"""shardcheck's S004 and the DCN-ratio gate over recorded runs of the
program registry (the port's counterpart of the JAX package's
``analysis/shardcheck.py`` and ``rules_shard.py``).

S004 bills each collective's bytes, as progcheck's record has them
(:func:`.progcheck.record_registry`, rank 0's registry input), to every
mesh axis the collective is declared over (``per_axis``) and once to a
domain (``per_domain``): ``dcn`` when one of its axes is a cross-pod
link by name (a token of :data:`DCN_AXIS_TOKENS`, as the reference's
``dcn_x``), else ``ici``. A collective over the whole mesh of a program
deployed over pods (its spec's ``dcn_shape``) crosses the expanded axes
of the reference's ``HierarchicalMesh``: a ``dcn_<name>`` axis in front
of each split grid axis. A sub-axis collective of the hierarchical
engine names its own axes (``parallel.mesh.HierarchicalMesh``'s
``ici_axes`` inside a pod, ``dcn_axes`` across pods). The attribution
is committed as ``wire_attribution`` in ``analysis/
progprofile_baseline.json`` and held against the reference's committed
one (copied there as ``reference_wire_attribution``) under progcheck's
justified list of differences.

:func:`check_dcn_ratio` is the reference's gate: the hierarchical
program's DCN bytes at most :data:`DCN_RATIO_MAX` of the flat sparse
engine's on the same two pods; a zero denominator is a finding.

S001-S003 judge ``shard_map``'s replication of traced values; the port
has no ``shard_map`` and no traced values (a rank is a process and a
guard is agreed by a ``pmin`` it reads), so they are not applicable and
the CLI lists them so.

CLI: ``python -m mpi_grid_redistribute_tpu_torch.tools.shardcheck
[--device cpu] [--check] [--format text|json|sarif|github]
[--update-baseline]``; exit codes 0 clean, 1 findings, 2 usage.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional, Sequence

S_RULE_IDS = ("S001", "S002", "S003", "S004")
NOT_APPLICABLE = ("S001", "S002", "S003")

RULE_DOCS = {
    "S001": "not applicable: shard_map output replication (the port has "
    "no shard_map; a rank is a process)",
    "S002": "not applicable: a redundant reduction of a value shard_map "
    "proves replicated (the port traces no values)",
    "S003": "not applicable: a value still varying over a mesh axis "
    "escaping shard_map unreduced (the port traces no values)",
    "S004": "per-axis wire attribution drift: collective bytes billed to "
    "the mesh axes crossed (ICI-vs-DCN rollup) must match the "
    "wire_attribution section of progprofile_baseline.json and the "
    "reference's committed one apart from the justified differences; the "
    "hierarchical engine's DCN bytes at most DCN_RATIO_MAX of the flat "
    "sparse engine's",
}

ICI_DOMAIN = "ici"
DCN_DOMAIN = "dcn"
# axis names that denote a cross-pod (data-center-network) link
DCN_AXIS_TOKENS = frozenset({"dcn", "pod", "pods", "slice", "slices", "wan"})

# the gate: the hierarchical engine's staged cross-pod hop carries at
# most this share of the bytes the flat sparse engine pushes across the
# pod boundary on the same two-pod split
DCN_RATIO_MAX = 0.15
DCN_RATIO_HIER_PROGRAM = "canonical_hierarchical_sharded"
DCN_RATIO_FLAT_PROGRAM = "canonical_sparse_pods"
WIRE_KEYS = ("per_axis", "per_domain", "total_bytes")


@dataclasses.dataclass(frozen=True)
class ShardFinding:
    """One shardcheck finding."""

    rule: str
    program: str
    message: str
    path: str = "mpi_grid_redistribute_tpu_torch/analysis/shardcheck.py"
    line: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"<{self.program}>: {self.rule}: {self.message}"


def axis_domain(axis: str) -> str:
    """The domain of one mesh axis by name: split on ``_`` so the
    expanded ``dcn_x`` bills to DCN while ``x`` stays ICI."""
    name = str(axis).lower()
    if name in DCN_AXIS_TOKENS or any(
            tok in DCN_AXIS_TOKENS for tok in name.split("_")):
        return DCN_DOMAIN
    return ICI_DOMAIN


def expanded_axes(axes: Sequence[str], dcn_shape) -> tuple:
    """The axes a whole-mesh collective crosses on a deployment over
    pods: a ``dcn_<name>`` axis in front of each grid axis split into
    more than one pod."""
    if dcn_shape is None:
        return tuple(axes)
    out = []
    for name, d in zip(axes, dcn_shape):
        if d > 1:
            out.append("dcn_" + name)
        out.append(name)
    return tuple(out)


def wire_profile(record: dict, spec) -> dict:
    """The S004 attribution of one recorded run: ``per_axis`` bills every
    collective's full bytes to each axis it crosses, ``per_domain`` once
    to its most expensive domain (DCN over ICI), so ``per_domain`` sums
    to the program's collective total."""
    per_axis: Dict[str, int] = {}
    per_domain = {ICI_DOMAIN: 0, DCN_DOMAIN: 0}
    for e in record["events"]:
        if e.kind != "coll":
            continue
        axes = (expanded_axes(e.axes, spec.dcn_shape) if e.world
                else tuple(e.axes))
        for a in axes:
            per_axis[a] = per_axis.get(a, 0) + e.nbytes
        if axes:
            dom = (DCN_DOMAIN if any(axis_domain(a) == DCN_DOMAIN
                                     for a in axes) else ICI_DOMAIN)
            per_domain[dom] += e.nbytes
    return {
        "per_axis": {k: int(per_axis[k]) for k in sorted(per_axis)},
        "per_domain": {k: int(per_domain[k]) for k in sorted(per_domain)},
        "total_bytes": int(sum(per_domain.values())),
    }


def compare_wire(current: Dict[str, dict],
                 baseline: Optional[Dict[str, dict]], rtol: float = 0.0,
                 check_stale: bool = False, partial: bool = False
                 ) -> List[ShardFinding]:
    """Drift gate over the wire attributions (the reference's, with its
    tolerance): any numeric drift beyond ``rtol`` (default: exact) is an
    S004 finding; intentional changes re-commit with
    ``--update-baseline``."""
    from mpi_grid_redistribute_tpu_torch.analysis.rules_prog import drifted

    out: List[ShardFinding] = []
    baseline = baseline or {}
    for name in sorted(current):
        if name not in baseline:
            out.append(ShardFinding(
                "S004", name,
                "program has no committed wire-attribution baseline — run "
                "python -m mpi_grid_redistribute_tpu_torch.tools.shardcheck "
                "--update-baseline and commit "
                "analysis/progprofile_baseline.json"))
            continue
        cur, base = current[name], baseline[name]
        old_t, new_t = int(base.get("total_bytes", 0)), int(
            cur.get("total_bytes", 0))
        if drifted(old_t, new_t, rtol):
            pct = (new_t - old_t) / max(abs(old_t), 1) * 100.0
            out.append(ShardFinding(
                "S004", name,
                f"total wire bytes drifted: baseline {old_t}, now {new_t} "
                f"({pct:+.1f}%) — a wire-cost change; justify it and "
                "refresh with --update-baseline"))
        for section, unit in (("per_axis", "axis"), ("per_domain", "domain")):
            old_c = dict(base.get(section, {}))
            new_c = dict(cur.get(section, {}))
            for key in sorted(set(old_c) | set(new_c)):
                old, new = int(old_c.get(key, 0)), int(new_c.get(key, 0))
                if drifted(old, new, rtol):
                    out.append(ShardFinding(
                        "S004", name,
                        f"wire bytes on {unit} {key!r} drifted: baseline "
                        f"{old}, now {new} — the collective schedule moved "
                        "across the mesh; justify it and refresh with "
                        "--update-baseline"))
    if check_stale and not partial:
        for name in sorted(set(baseline) - set(current)):
            out.append(ShardFinding(
                "S004", name,
                "stale wire-attribution baseline entry: program is no "
                "longer registered — remove it with --update-baseline"))
    return out


def dcn_ratio(wires: Dict[str, dict],
              hier_program: str = DCN_RATIO_HIER_PROGRAM,
              flat_program: str = DCN_RATIO_FLAT_PROGRAM):
    """``(hierarchical DCN bytes, flat DCN bytes)``, or ``None`` when
    either program is absent."""
    if hier_program not in wires or flat_program not in wires:
        return None
    return (int(wires[hier_program]["per_domain"].get(DCN_DOMAIN, 0)),
            int(wires[flat_program]["per_domain"].get(DCN_DOMAIN, 0)))


def check_dcn_ratio(wires: Dict[str, dict],
                    max_ratio: float = DCN_RATIO_MAX,
                    hier_program: str = DCN_RATIO_HIER_PROGRAM,
                    flat_program: str = DCN_RATIO_FLAT_PROGRAM
                    ) -> List[ShardFinding]:
    """The reference's gate: skipped when either program is absent (a
    ``--programs`` subset); a zero denominator is a finding (the flat
    program no longer crosses the pods, and the gate would be
    vacuous)."""
    pair = dcn_ratio(wires, hier_program, flat_program)
    if pair is None:
        return []
    hier_dcn, flat_dcn = pair
    if flat_dcn <= 0:
        return [ShardFinding(
            "S004", flat_program,
            "DCN-ratio gate denominator is zero: the flat sparse "
            "comparison program no longer bills any bytes to the DCN "
            "domain, so the hierarchical-vs-sparse gate is vacuous — "
            "check the deployment's dcn_shape and DCN_AXIS_TOKENS")]
    ratio = hier_dcn / flat_dcn
    if ratio > max_ratio:
        return [ShardFinding(
            "S004", hier_program,
            f"hierarchical DCN bytes {hier_dcn} are {ratio * 100.0:.1f}% "
            f"of the flat sparse engine's cross-pod bytes {flat_dcn} "
            f"(gate: <= {max_ratio * 100.0:.0f}%) — the staged per-pod hop "
            "is no longer mover-count-driven; check cross_cap sizing and "
            "the condensed block packing")]
    return []


def wire_profiles(recorded: Dict[str, dict], programs) -> Dict[str, dict]:
    """S004's attribution of every recorded program (rank 0's registry
    input)."""
    return {name: wire_profile(recorded[name]["records"]["registry"],
                               programs[name])
            for name in sorted(programs)}


def gate_wires(wires, baseline_doc, rtol=0.0, check_stale=False,
               partial=False) -> List[ShardFinding]:
    """S004 against a committed baseline document: drift from the port's
    ``wire_attribution``, differences from the reference's copied
    ``reference_wire_attribution`` not on the justified list, and the
    DCN-ratio gate."""
    from mpi_grid_redistribute_tpu_torch.analysis import rules_prog

    out = compare_wire(wires, baseline_doc.get("wire_attribution"),
                       rtol=rtol, check_stale=check_stale, partial=partial)
    out += [ShardFinding(f.rule, f.program, f.message)
            for f in rules_prog.compare_reference(
                "S004", "wire_attribution", wires,
                baseline_doc.get("reference_wire_attribution"),
                baseline_doc.get("reference_differences", []), WIRE_KEYS)]
    return out + check_dcn_ratio(wires)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_grid_redistribute_tpu_torch.tools.shardcheck",
        description="S004: the registry's collective bytes billed to the "
        "mesh axes and ICI/DCN domains they cross, and the DCN-ratio "
        "gate.")
    p.add_argument("--device", default=None,
                   help="where the programs run (default: the GPU)")
    p.add_argument("--format", choices=("text", "json", "sarif", "github"),
                   default="text", help="output format")
    p.add_argument("--programs", default=None, metavar="NAME[,NAME]",
                   help="comma-separated subset of registered programs")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="the wire baseline (default: the progcheck "
                   "profile baseline)")
    p.add_argument("--check", action="store_true",
                   help="CI mode: also fail on baseline entries of "
                   "programs that are no longer registered")
    p.add_argument("--update-baseline", action="store_true",
                   help="write the current attribution to the baseline "
                   "file and exit 0")
    p.add_argument("--rtol", type=float, default=0.0,
                   help="relative tolerance of the drift (default 0)")
    p.add_argument("--list-rules", action="store_true",
                   help="list rules and exit")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    from mpi_grid_redistribute_tpu_torch.analysis import (
        baseline, progcheck, sarif,
    )

    args = _parser().parse_args(argv)
    if args.list_rules:
        for rid in S_RULE_IDS:
            print(f"{rid}  {RULE_DOCS[rid]}")
        return 0
    programs = progcheck.default_programs()
    if args.programs:
        wanted = [x.strip() for x in args.programs.split(",") if x.strip()]
        unknown = [p for p in wanted if p not in programs]
        if unknown:
            print(f"shardcheck: unknown program(s): {', '.join(unknown)} "
                  f"(known: {', '.join(sorted(programs))})",
                  file=sys.stderr)
            return 2
        programs = {n: programs[n] for n in wanted}
    recorded = progcheck.record_registry(programs, device=args.device,
                                         host_read_check=False,
                                         inputs=("registry",))
    wires = wire_profiles(recorded, programs)
    path = args.baseline or baseline.progprofile_baseline_path()
    if args.update_baseline:
        baseline.write_wire_baseline(path, wires)
        print(f"shardcheck: wrote {len(wires)} wire attribution(s) to "
              f"{path}")
        return 0
    findings = gate_wires(wires, baseline.load_progprofile_doc(path),
                          rtol=args.rtol, check_stale=args.check,
                          partial=args.programs is not None)
    pair = dcn_ratio(wires)
    if args.format == "json":
        print(json.dumps({"findings": [f.to_dict() for f in findings],
                          "wire_attribution": wires,
                          "dcn_ratio": None if pair is None or not pair[1]
                          else pair[0] / pair[1]},
                         indent=2, sort_keys=True))
    elif args.format == "sarif":
        print(json.dumps(sarif.to_sarif(findings, "shardcheck", RULE_DOCS),
                         indent=2))
    elif args.format == "github":
        for line in sarif.github_annotations(findings):
            print(line)
    else:
        for rid in NOT_APPLICABLE:
            print(f"{rid}: {RULE_DOCS[rid]}")
        for f in findings:
            print(f.render())
        if pair is not None and pair[1]:
            print(f"shardcheck: DCN ratio {pair[0]} / {pair[1]} B = "
                  f"{pair[0] / pair[1] * 100.0:.2f}% (gate <= "
                  f"{DCN_RATIO_MAX * 100.0:.0f}%)")
        print(f"shardcheck: {len(findings)} finding(s) over "
              f"{len(programs)} program(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
