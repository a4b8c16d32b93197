"""progcheck's rules J001-J004 over RECORDED runs of the registry's
programs (the port's counterpart of the JAX package's
``analysis/rules_jaxpr.py``, which reads traced jaxprs; the port has no
trace stage, so each rule reads what one run of a program did).

A run is recorded by :func:`..progcheck.record_program` through
``utils.costcount.counting(record=True)``: in order, every aten op with
its output shapes, every kernel scope, every collective with its bytes
and the mesh axes it is declared over, and the entries to and exits
from the ``telemetry.phases.traced_span`` regions the engines open
(``rd:sparse_wire``, ``rd:neighbor_wire``, ``rd:dense_wire``,
``mig:fast``, ``pipe:land+drift``); plus the high-water mark of the
bytes its ops allocated that were still alive. A record is a dict:
``events``, ``sequence`` (the ordered ``(primitive, bytes)`` of its
collectives), ``peak_live_bytes`` and ``cost``
(``telemetry.roofline.count_cost``'s dict). Host reads are counted
apart (J002).

The rule ids and their meaning are the reference's:

* J001: the reference proves a ``lax.cond`` predicate replicated; here a
  branch is taken on the host after a ``pmin``, so the rule compares
  what every rank of the 8-rank world actually issued: the same ordered
  collective sequence on every rank, on every input, and on an input on
  which one rank alone overflows the mover block the dense schedule on
  every rank (the guard agreed, not one rank's own).
* J002: no host read inside a resident program's call (counted by a
  ``TorchFunctionMode``; on the card also ``set_sync_debug_mode
  ("error")``).
* J003: the four fast-path contracts, read off the regions of the
  record.
* J004: each program's collective bytes a primitive, their total and
  count and its peak live bytes against the committed baseline, with the
  reference's ``_drifted`` tolerance; and the per-primitive bytes, total
  and count against the reference's committed ``profiles`` (copied into
  the port's baseline as ``reference_profiles``) under a justified list
  of differences.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from mpi_grid_redistribute_tpu_torch.analysis.progcheck import ProgFinding

RULE_DOCS = {
    "J000": "registry completeness: every engine x topology, the resident "
    "macro-step, the migrate fast path and apply_assignment must have a "
    "registered program",
    "J001": "collective-schedule consistency: every rank of a sharded "
    "program issues the same ordered (collective, bytes) sequence on every "
    "input, and when one rank alone overflows the mover block every rank "
    "takes the dense schedule (the pmin-agreed guard)",
    "J002": "resident purity: no host read (item, tolist, bool/int/float "
    "of a tensor, cpu, numpy, nonzero, masked_select, boolean-mask "
    "indexing) in a resident-marked program's call; on the card no "
    "synchronizing operation under sync debug mode 'error'",
    "J003": "fast-path cost contract: the fast region ran; migrate fast "
    "branches sort-free with mover-bounded gathers; sparse wire at "
    "mover-cap columns; neighbor wire ppermute-only, no dense all_to_all; "
    "pipelined steady-state iterations bin step k+1 before landing step "
    "k, with exactly one landing scatter and at most one payload "
    "collective per iteration",
    "J004": "wire/footprint drift: per-program collective bytes, their "
    "total and count and the peak live bytes must match the committed "
    "progprofile_baseline.json, and the collective bytes the reference's "
    "committed profiles apart from the justified differences",
}

# collectives that move particle payload (not a scalar guard)
PAYLOAD_COLLECTIVES = frozenset({"ppermute", "all_to_all", "all_gather"})
_SORTS = frozenset({"aten::sort", "aten::argsort", "aten::topk",
                    "aten::msort"})
_GATHERS = frozenset({"aten::index", "aten::index_select", "aten::gather",
                      "aten::take", "aten::take_along_dim"})
_SCATTERS = frozenset({"aten::index_put_", "aten::_index_put_impl_",
                       "aten::index_put", "aten::scatter_", "aten::scatter",
                       "aten::index_copy_", "aten::masked_scatter_",
                       "aten::put_"})
# the landing kernel's scope names (ops/overlay.py, ops/scatter.py)
_LANDINGS = ("overlay_scatter_planar", "scatter_rows")

# regions the engines open (telemetry.phases.traced_span)
SPARSE_WIRE = "rd:sparse_wire"
NEIGHBOR_WIRE = "rd:neighbor_wire"
DENSE_WIRE = "rd:dense_wire"
MIGRATE_FAST = "mig:fast"
PIPELINE_STEADY = "pipe:land+drift"


def regions(events, name: str) -> List[list]:
    """The events inside each (outermost) region ``name``, in order."""
    out, depth, cur = [], 0, None
    for e in events:
        if e.kind == "enter" and e.name == name:
            depth += 1
            if depth == 1:
                cur = []
            continue
        if e.kind == "exit" and e.name == name:
            depth -= 1
            if depth == 0:
                out.append(cur)
                cur = None
            continue
        if cur is not None:
            cur.append(e)
    return out


def _colls(events, name=None):
    return [e for e in events if e.kind == "coll"
            and (name is None or e.name == name)]


# ---------------------------------------------------------------------
# J001 -- the same collective schedule on every rank
# ---------------------------------------------------------------------


def _render(seq) -> str:
    return ", ".join(f"{n}:{b}" for n, b in seq) or "none"


def check_j001(name: str, sequences: Dict[str, Sequence[Sequence[tuple]]]
               ) -> List:
    """``sequences[input][rank]`` is the ordered ``(primitive, bytes)``
    list rank ``rank`` issued on ``input``. Every rank must issue the
    same list; on ``one_rank_overflows`` it must also be the dense list
    of the ``registry`` input (whose every rank but 0 overflows)."""
    out = []
    for data in sorted(sequences):
        seqs = [list(map(tuple, s)) for s in sequences[data]]
        ref = seqs[0]
        bad = [r for r, s in enumerate(seqs) if s != ref]
        if bad:
            out.append(ProgFinding(
                "J001", name,
                f"input {data!r}: ranks {bad} issue another collective "
                f"sequence than rank 0 — ranks diverged around a branch "
                f"and the mesh deadlocks; rank 0: [{_render(ref)}], rank "
                f"{bad[0]}: [{_render(seqs[bad[0]])}]"))
    over = sequences.get("one_rank_overflows")
    dense = sequences.get("registry")
    if over is not None and dense is not None:
        for r, (s, d) in enumerate(zip(over, dense)):
            if list(map(tuple, s)) != list(map(tuple, d)):
                out.append(ProgFinding(
                    "J001", name,
                    f"rank {r}: when one rank alone overflows the mover "
                    f"block this rank runs [{_render(s)}], not the dense "
                    f"schedule [{_render(d)}] — the fallback guard is not "
                    "agreed across ranks (pmin) before the branch"))
                break
    return out


# ---------------------------------------------------------------------
# J002 -- resident purity
# ---------------------------------------------------------------------


def check_j002(spec, host_reads: Dict[str, int],
               sync_error: Optional[str] = None) -> List:
    """``host_reads``: ``{read: count}`` one call made (counted by
    :class:`..progcheck.HostReadCounter`); ``sync_error``: what
    ``set_sync_debug_mode("error")`` raised on the card, if anything."""
    if not spec.resident:
        return []
    out = []
    reads = {k: v for k, v in sorted(host_reads.items()) if v}
    if reads:
        out.append(ProgFinding(
            "J002", spec.name,
            f"resident-marked program reads the device from the host "
            f"{reads}: every read waits for the device and splits the "
            "chunk (the dynamic backstop behind gridlint G009)"))
    if sync_error:
        out.append(ProgFinding(
            "J002", spec.name,
            f"resident-marked program synchronizes under sync debug mode "
            f"'error': {sync_error}"))
    return out


# ---------------------------------------------------------------------
# J003 -- the fast-path cost contracts
# ---------------------------------------------------------------------


def _max_rows(shapes) -> int:
    return max((max(s) for s in shapes if s), default=0)


def _check_migrate(spec, records) -> List:
    events = records["registry"]["events"]
    fast = regions(events, MIGRATE_FAST)
    if not fast:
        return [ProgFinding(
            "J003", spec.name,
            "migrate fast path lost: no step of the run entered the "
            f"{MIGRATE_FAST!r} region (the mover-sparse branch)")]
    out = []
    bound = spec.fast_rows
    sorts = sorted({e.name for reg in fast for e in reg
                    if e.kind == "op" and e.name in _SORTS})
    if sorts:
        out.append(ProgFinding(
            "J003", spec.name,
            f"migrate fast branch runs {sorts}: sorts are resident-scale; "
            "the fast branch must consume selections made outside it"))
    for reg in fast:
        for e in reg:
            if bound is not None and e.kind == "op" and e.name in _GATHERS:
                rows = _max_rows(e.shapes)
                if rows > bound:
                    out.append(ProgFinding(
                        "J003", spec.name,
                        f"fast-branch gather {e.name} produces {rows} rows "
                        f"> mover_cap x V = {bound}: a resident-scale "
                        "permutation snuck into the mover-scale path"))
                    return out
    return out


def _wire_width(events, region) -> int:
    w = [e.nbytes for reg in regions(events, region)
         for e in _colls(reg, "all_to_all")]
    return max(w) if w else 0


def _check_sparse_wire(spec, records) -> List:
    fast = records.get("fast")
    narrow = 0 if fast is None else _wire_width(fast["events"], SPARSE_WIRE)
    wide = _wire_width(records["registry"]["events"], DENSE_WIRE)
    if not narrow or not wide:
        return [ProgFinding(
            "J003", spec.name,
            "sparse dispatch lost: the input whose movers fit ran no "
            f"all_to_all in {SPARSE_WIRE!r} (narrow {narrow} B) or the "
            f"registry input none in {DENSE_WIRE!r} (wide {wide} B)")]
    cap, B = spec.capacity, spec.mover_cap
    if cap and B and narrow * cap != wide * B:
        return [ProgFinding(
            "J003", spec.name,
            f"sparse pool width broke the B/cap contract: narrow {narrow} "
            f"* cap {cap} != wide {wide} * mover_cap {B} — the fast "
            "branch no longer rides mover-cap columns")]
    return []


def _check_neighbor_wire(spec, records) -> List:
    fast = records.get("fast")
    wires = [] if fast is None else regions(fast["events"], NEIGHBOR_WIRE)
    if not wires:
        return [ProgFinding(
            "J003", spec.name,
            "neighbor dispatch lost: the input whose movers fit the "
            f"stencil never entered {NEIGHBOR_WIRE!r} (the ppermute "
            "schedule)")]
    out = []
    for reg in wires:
        if not _colls(reg, "ppermute"):
            out.append(ProgFinding(
                "J003", spec.name,
                "neighbor fast branch has no ppermute: the stencil shift "
                "schedule is gone"))
        if _colls(reg, "all_to_all"):
            out.append(ProgFinding(
                "J003", spec.name,
                "neighbor fast branch contains an all_to_all: the dense "
                "pool exchange re-entered the stencil schedule"))
    if _colls(records["registry"]["events"], "ppermute"):
        out.append(ProgFinding(
            "J003", spec.name,
            "neighbor dense branch contains ppermute: the fallback is no "
            "longer the canonical dense exchange"))
    return out


def _is_landing(e) -> bool:
    return ((e.kind == "kernel" and e.name in _LANDINGS)
            or (e.kind == "op" and e.name in _SCATTERS))


def bins_before_landing(events) -> bool:
    """Does this region bin (``aten::floor``, the cell quantization of
    ``ops.binning``) before its first landing scatter?"""
    for e in events:
        if e.kind == "op" and e.name == "aten::floor":
            return True
        if _is_landing(e):
            return False
    return False


def _check_pipeline(spec, records) -> List:
    steady = regions(records["registry"]["events"], PIPELINE_STEADY)
    if not steady:
        return [ProgFinding(
            "J003", spec.name,
            f"pipelined dispatch lost: no {PIPELINE_STEADY!r} region (the "
            "steady-state iteration that bins step k+1 before landing "
            "step k)")]
    out = []
    for i, reg in enumerate(steady):
        if not bins_before_landing(reg):
            out.append(ProgFinding(
                "J003", spec.name,
                f"steady-state iteration {i} lands step k before it bins "
                "step k+1: the overlap is gone"))
        n_land = sum(1 for e in reg if _is_landing(e))
        if n_land != 1:
            out.append(ProgFinding(
                "J003", spec.name,
                f"steady-state iteration {i} lands with {n_land} scatters "
                "(contract: exactly one — the free-stack update must stay "
                "fused into the landing)"))
        n_coll = sum(1 for e in _colls(reg) if e.name in PAYLOAD_COLLECTIVES)
        if n_coll > 1:
            out.append(ProgFinding(
                "J003", spec.name,
                f"steady-state iteration {i} issues {n_coll} payload "
                "collectives (contract: at most one exchange a step)"))
        if out:
            break
    return out


FASTPATH_CHECKS = {
    "migrate": _check_migrate,
    "sparse_wire": _check_sparse_wire,
    "neighbor_wire": _check_neighbor_wire,
    "pipeline": _check_pipeline,
}


def check_j003(spec, records: Dict[str, dict]) -> List:
    """``records[input]``: rank 0's record of each input the program ran
    (``registry`` always; ``fast`` for the wire contracts)."""
    if spec.fastpath is None:
        return []
    try:
        checker = FASTPATH_CHECKS[spec.fastpath]
    except KeyError:
        raise ValueError(
            f"program {spec.name!r}: unknown fastpath kind "
            f"{spec.fastpath!r} (known: {sorted(FASTPATH_CHECKS)})"
        ) from None
    return checker(spec, records)


# ---------------------------------------------------------------------
# J004 -- wire/footprint drift, and the reference's committed profiles
# ---------------------------------------------------------------------


def program_profile(record: dict) -> dict:
    """The profile J004 gates, from rank 0's registry record."""
    cost = record["cost"]
    return {
        "collective_bytes": dict(cost["collective_bytes"]),
        "collective_bytes_total": int(cost["collective_bytes_total"]),
        "collective_count": int(cost["collective_count"]),
        "peak_live_bytes": int(record["peak_live_bytes"]),
    }


_PROFILE_SCALARS = ("collective_bytes_total", "collective_count",
                    "peak_live_bytes")


def drifted(old: int, new: int, rtol: float) -> bool:
    """The reference's drift test (``rules_jaxpr._drifted``)."""
    if old == new:
        return False
    if rtol <= 0:
        return True
    return abs(new - old) > rtol * max(abs(old), 1)


def compare_profiles(current: Dict[str, dict],
                     baseline: Optional[Dict[str, dict]],
                     rtol: float = 0.0, check_stale: bool = False,
                     partial: bool = False) -> List:
    """Drift gate over the profiles: any numeric drift beyond ``rtol``
    (default: exact) is a J004 finding; intentional changes re-commit
    with ``--update-baseline``."""
    out = []
    baseline = baseline or {}
    for name in sorted(current):
        if name not in baseline:
            out.append(ProgFinding(
                "J004", name,
                "program has no committed profile baseline — run python -m "
                "mpi_grid_redistribute_tpu_torch.analysis.progcheck "
                "--update-baseline and commit "
                "analysis/progprofile_baseline.json"))
            continue
        cur, base = current[name], baseline[name]
        for key in _PROFILE_SCALARS:
            old, new = int(base.get(key, 0)), int(cur.get(key, 0))
            if drifted(old, new, rtol):
                pct = (new - old) / max(abs(old), 1) * 100.0
                out.append(ProgFinding(
                    "J004", name,
                    f"{key} drifted: baseline {old}, now {new} "
                    f"({pct:+.1f}%) — a cost change; justify it and "
                    "refresh with --update-baseline"))
        old_c = dict(base.get("collective_bytes", {}))
        new_c = dict(cur.get("collective_bytes", {}))
        for prim in sorted(set(old_c) | set(new_c)):
            old, new = int(old_c.get(prim, 0)), int(new_c.get(prim, 0))
            if drifted(old, new, rtol):
                out.append(ProgFinding(
                    "J004", name,
                    f"collective {prim} bytes drifted: baseline {old}, now "
                    f"{new} — the wire schedule changed; justify it and "
                    "refresh with --update-baseline"))
    if check_stale and not partial:
        for name in sorted(set(baseline) - set(current)):
            out.append(ProgFinding(
                "J004", name,
                "stale baseline entry: program is no longer registered — "
                "remove it with --update-baseline"))
    return out


def flat_items(profile: dict, keys: Iterable[str]) -> Dict[str, int]:
    """``{"collective_bytes.<prim>": n, <scalar>: n, ...}`` of one profile
    (or wire attribution): nested dicts flattened one level."""
    out = {}
    for key in keys:
        v = profile.get(key, 0)
        if isinstance(v, dict):
            for k, n in v.items():
                out[f"{key}.{k}"] = int(n)
        else:
            out[key] = int(v)
    return out


REFERENCE_PROFILE_KEYS = ("collective_bytes", "collective_bytes_total",
                          "collective_count")


def reference_differences(current: Dict[str, dict],
                          reference: Dict[str, dict],
                          keys: Sequence[str]) -> List[Tuple]:
    """``(program, key, port, reference)`` of every number in ``keys``
    where the port's ``current`` differs from the reference's committed
    numbers (a key one side lacks reads 0 there)."""
    out = []
    for name in sorted(current):
        if name not in reference:
            continue
        mine = flat_items(current[name], keys)
        theirs = flat_items(reference[name], keys)
        for key in sorted(set(mine) | set(theirs)):
            a, b = mine.get(key, 0), theirs.get(key, 0)
            if a != b:
                out.append((name, key, a, b))
    return out


def compare_reference(rule: str, section: str, current: Dict[str, dict],
                      reference: Optional[Dict[str, dict]],
                      justified: Sequence[dict], keys: Sequence[str]
                      ) -> List:
    """Every difference from the reference's committed ``section`` that
    the justified list does not name with these exact numbers is a
    ``rule`` finding; so is a program the reference has no entry for."""
    if reference is None:
        return [ProgFinding(rule, "<baseline>",
                         f"no copy of the reference's {section} in the "
                         "port's baseline")]
    ok = {(j["program"], j["key"], int(j["port"]), int(j["reference"]))
          for j in justified if j.get("section") == section
          and j.get("justification")}
    out = []
    for name in sorted(set(current) - set(reference)):
        out.append(ProgFinding(
            rule, name, f"the reference's {section} has no entry for this "
            "program"))
    for name, key, a, b in reference_differences(current, reference, keys):
        if (name, key, a, b) not in ok:
            out.append(ProgFinding(
                rule, name,
                f"{section} {key} is {a} here and {b} in the reference's "
                "committed baseline, and the justified list of differences "
                "does not name it"))
    return out
