"""The K rules of ``analysis.kernelcheck`` (the port's counterpart of the
JAX package's ``analysis/rules_kernel.py``): the guarded arena a case
runs in, and the checks over what a run left behind. The rules are
documented in :data:`RULE_DOCS` and in ``analysis/kernelcheck.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from mpi_grid_redistribute_tpu_torch.analysis.kernelcheck import (
    KernelCase,
    KernelFinding,
    KernelSpec,
)

# bytes of guard band on each side of every tensor (four 128-byte
# sectors), and the byte they hold; a 4-byte word of it reads 0xA5A5A5A5
GUARD_BYTES = 512
SENTINEL = 0xA5


# ---------------------------------------------------------------------
# the guarded arena
# ---------------------------------------------------------------------


class Arena:
    """The tensors of one run of a case, each the interior of a byte
    buffer with :data:`GUARD_BYTES` of :data:`SENTINEL` on each side.
    ``sentinel_outputs`` starts the ``"overwrite"`` operands as the
    sentinel too (``"out"`` operands always do)."""

    def __init__(self, case: KernelCase, device, sentinel_outputs=False):
        import torch

        self.buffers = {}
        self.tensors = {}
        self.initial = {}
        for name, role in case.roles.items():
            if role == "out":
                shape, dt = case.out_specs[name]
                arr = None
                dtype = getattr(torch, dt)
            else:
                arr = case.inputs[name]
                shape = arr.shape
                dtype = torch.from_numpy(arr[:0].copy()).dtype
            itemsize = torch.empty((), dtype=dtype).element_size()
            nbytes = int(np.prod(shape)) * itemsize
            buf = torch.full((2 * GUARD_BYTES + nbytes,), SENTINEL,
                             dtype=torch.uint8, device=device)
            inner = buf[GUARD_BYTES:GUARD_BYTES + nbytes]
            t = inner.view(dtype).view(shape)
            if arr is not None and not (
                    role == "overwrite" and sentinel_outputs):
                t.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            self.buffers[name] = buf
            self.tensors[name] = t
            self.initial[name] = _bytes(t)

    def guard_damage(self) -> Dict[str, Tuple[int, int]]:
        """``{tensor: (bytes hit before, bytes hit after)}`` for every
        tensor whose guard bands lost the sentinel."""
        out = {}
        for name, buf in self.buffers.items():
            b = buf.cpu().numpy()
            lo = int(np.count_nonzero(b[:GUARD_BYTES] != SENTINEL))
            hi = int(np.count_nonzero(b[-GUARD_BYTES:] != SENTINEL))
            if lo or hi:
                out[name] = (lo, hi)
        return out


def _bytes(t) -> np.ndarray:
    """``t``'s elements as ``[numel, itemsize]`` raw bytes on the host."""
    import torch

    c = t.detach().contiguous().cpu()
    # a copy: on the CPU the view would share the live tensor's memory
    return c.view(torch.uint8).numpy().reshape(
        c.numel(), c.element_size()).copy()


def _sentinel_elements(t) -> np.ndarray:
    """Element mask (``t``'s shape) of elements whose every byte is the
    sentinel."""
    return (_bytes(t) == SENTINEL).all(axis=1).reshape(tuple(t.shape))


def _differ(a, b) -> np.ndarray:
    """Element mask of the elements whose bits differ."""
    return (_bytes(a) != _bytes(b)).any(axis=1).reshape(tuple(a.shape))


def plain_tensors(case: KernelCase, device) -> Dict[str, object]:
    """The case's inputs as ordinary tensors on ``device`` (fresh
    copies), for the plain twin."""
    import torch

    return {name: torch.from_numpy(np.ascontiguousarray(arr)).to(device)
            for name, arr in case.inputs.items()}


# ---------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------

# Hopper (sm_90) limits the footprint is gated against
MAX_REGS_PER_THREAD = 255
MAX_SMEM_PER_BLOCK = 232448  # 227 KB, with the opt-in attribute
MAX_STATIC_SMEM = 49152  # static __shared__ arrays
REGS_PER_SM = 65536

RULE_DOCS = {
    "K000": "registry completeness: every kernel in ops._build.KERNELS "
    "has a case, and on the card each case raises its kernel's launch "
    "count by the launches it expects (a case that takes the plain route "
    "guards nothing)",
    "K001": "in-bounds addressing: every tensor a case hands its op sits "
    "between guard bands of sentinel bytes that must survive the launch "
    "(reads out of bounds: compute-sanitizer memcheck, --sanitize)",
    "K002": "write coverage and overlap: no output sentinel survives a "
    "dense kernel, a scatter kernel writes exactly its contract's set, "
    "no input changes; scatter cases: three launches give the same bits "
    "and a duplicate target is refused where the port refuses one "
    "(shared-memory hazards: compute-sanitizer racecheck, --sanitize)",
    "K003": "card footprint: registers, static + dynamic shared bytes and "
    "threads of every launched function within Hopper's limits (255 "
    "registers a thread, 227 KB shared a block, 64K registers an SM), "
    "and equal to the committed kernelcheck_baseline.json for its nvcc",
    "K004": "not applicable: lane tiling is a property of the TPU "
    "compiler; CUDA kernels address words directly",
    "K005": "each case bit-equal to its plain twin on the same inputs",
}


def check_registry(kernels: Dict[str, KernelSpec]) -> List[KernelFinding]:
    """K000's leg that needs no card: every ``_build.KERNELS`` entry has
    a case, and no case names an unknown kernel."""
    from mpi_grid_redistribute_tpu_torch.ops import _build

    findings = []
    covered = {s.kernel for s in kernels.values()}
    for k in sorted(_build.KERNELS):
        if k not in covered:
            findings.append(KernelFinding(
                "K000", k, f"kernel {k!r} ({_build.KERNELS[k].source.name})"
                " has no kernelcheck case"))
    for name, spec in sorted(kernels.items()):
        if spec.kernel not in _build.KERNELS:
            findings.append(KernelFinding(
                "K000", name, f"the case names kernel {spec.kernel!r}, "
                "which ops._build does not register"))
    return findings


def check_launches(name: str, spec: KernelSpec, before: dict,
                   after: dict) -> List[KernelFinding]:
    """K000's leg on the card: one call of the case raised its kernel's
    launch count by ``spec.launches``."""
    got = after.get(spec.kernel, 0) - before.get(spec.kernel, 0)
    if got == spec.launches:
        return []
    return [KernelFinding(
        "K000", name, f"one call launched {spec.kernel!r} {got} time(s), "
        f"the case expects {spec.launches}: the op took its plain route at "
        "the registered shapes, so the case guards nothing")]


def guard_findings(name, arena) -> List[KernelFinding]:
    return [KernelFinding(
        "K001", name, f"wrote outside {t!r}: {lo} guard byte(s) before it "
        f"and {hi} after it lost the sentinel")
        for t, (lo, hi) in sorted(arena.guard_damage().items())]


def input_findings(name, case, arena) -> List[KernelFinding]:
    out = []
    for t, role in sorted(case.roles.items()):
        if role != "in":
            continue
        n = int((_bytes(arena.tensors[t]) != arena.initial[t]).any(
            axis=1).sum())
        if n:
            out.append(KernelFinding(
                "K002", name, f"changed {n} element(s) of its input {t!r}"))
    return out


def scatter_findings(name, case, device) -> List[KernelFinding]:
    """K002 for a scatter kernel: the written set, launches repeated,
    duplicate refusal."""
    findings = []
    arena = Arena(case, device, sentinel_outputs=True)
    got = case.run(arena.tensors)
    # the plain twin on the sentinel-filled state: what the contract
    # writes, and the sentinel everywhere else
    fresh = Arena(case, device, sentinel_outputs=True)
    want = case.plain(fresh.tensors)
    findings += guard_findings(name, arena)
    masks = case.written(case.inputs)
    for out_name, mask in masks.items():
        g, w = got[out_name], want[out_name]
        stray = int((~mask & ~_sentinel_elements(g)).sum())
        if stray:
            findings.append(KernelFinding(
                "K002", name, f"wrote {stray} element(s) of {out_name!r} "
                "outside its contract's set"))
        wrong = int((mask & _differ(g, w)).sum())
        if wrong:
            findings.append(KernelFinding(
                "K002", name, f"{wrong} element(s) of {out_name!r} in its "
                "contract's set were not written as the contract says"))
    # three back-to-back launches, each on the same starting state
    runs = []
    for _ in range(3):
        a = Arena(case, device)
        runs.append(case.run(a.tensors))
    for i in (1, 2):
        for out_name in runs[0]:
            n = int(_differ(runs[0][out_name], runs[i][out_name]).sum())
            if n:
                findings.append(KernelFinding(
                    "K002", name, f"launch {i + 1} of 3 differs from the "
                    f"first in {n} element(s) of {out_name!r}"))
    if case.duplicate is not None:
        a = Arena(case, device)
        try:
            case.duplicate(a.tensors)
        except ValueError:
            pass
        else:
            findings.append(KernelFinding(
                "K002", name, "a duplicate in-range target was not "
                "refused under the op's debug check"))
    return findings


def footprint(spec: KernelSpec, case: KernelCase, tensors) -> dict:
    """K003's table row of a case on the card: ``{function: {regs,
    static_smem, dynamic_smem, local_bytes, threads, max_threads}}`` for
    every function one call launches."""
    from mpi_grid_redistribute_tpu_torch.ops import _build

    usage = _build.KERNELS[spec.kernel].resource_usage()
    row = {}
    for fn, threads, dyn in case.functions(tensors):
        if fn not in usage:
            raise KeyError(f"{spec.kernel}: the launch names {fn!r}, which "
                           f"its source does not list ({sorted(usage)})")
        a = usage[fn]
        row[fn] = {"regs": a["regs"], "static_smem": a["static_smem"],
                   "dynamic_smem": int(dyn), "local_bytes": a["local_bytes"],
                   "threads": int(threads),
                   "max_threads": a["max_threads"]}
    return row


def check_footprint(name: str, row: dict) -> List[KernelFinding]:
    """K003 against Hopper's limits."""
    out = []
    for fn, a in sorted(row.items()):
        smem = a["static_smem"] + a["dynamic_smem"]
        probs = []
        if a["regs"] > MAX_REGS_PER_THREAD:
            probs.append(f"{a['regs']} registers a thread > "
                         f"{MAX_REGS_PER_THREAD}")
        if smem > MAX_SMEM_PER_BLOCK:
            probs.append(f"{smem} shared bytes a block > "
                         f"{MAX_SMEM_PER_BLOCK}")
        if a["static_smem"] > MAX_STATIC_SMEM:
            probs.append(f"{a['static_smem']} static shared bytes > "
                         f"{MAX_STATIC_SMEM}")
        if a["threads"] > a["max_threads"]:
            probs.append(f"{a['threads']} threads a block > the "
                         f"{a['max_threads']} it can launch with")
        if a["regs"] * a["threads"] > REGS_PER_SM:
            probs.append(f"{a['regs']} x {a['threads']} registers a block > "
                         f"the SM's {REGS_PER_SM}")
        for p in probs:
            out.append(KernelFinding("K003", name, f"{fn}: {p}"))
    return out


def compare_footprints(footprints: Dict[str, dict],
                       baseline: Optional[dict], nvcc: Optional[str],
                       check_stale: bool = False,
                       partial: bool = False) -> List[KernelFinding]:
    """K003's exact gate: each case's row against the committed table,
    written with ``baseline["nvcc"]``. A different toolkit is one
    finding naming both versions (rows are then not compared); stale
    entries are findings under ``check_stale`` (not on a ``partial``
    run of some cases)."""
    if baseline is None:
        return [KernelFinding(
            "K003", "<baseline>", "no footprint baseline: run python -m "
            "mpi_grid_redistribute_tpu_torch.tools.kernelcheck "
            "--update-baseline on the card")]
    if baseline.get("nvcc") != nvcc:
        return [KernelFinding(
            "K003", "<baseline>", f"toolkit drift: the footprint baseline "
            f"was written with nvcc {baseline.get('nvcc')}, this run builds "
            f"with nvcc {nvcc}; re-baseline on purpose with "
            "--update-baseline and justify the change")]
    table = baseline.get("footprints") or {}
    out = []
    for name, row in sorted(footprints.items()):
        if name not in table:
            out.append(KernelFinding(
                "K003", name, "no baseline entry: run --update-baseline on "
                "the card"))
            continue
        want = table[name]
        for fn in sorted(set(row) | set(want)):
            if fn not in want:
                out.append(KernelFinding(
                    "K003", name, f"launches {fn}, which the baseline "
                    "does not list"))
                continue
            if fn not in row:
                out.append(KernelFinding(
                    "K003", name, f"the baseline lists {fn}, which the "
                    "case no longer launches"))
                continue
            for field in sorted(set(row[fn]) | set(want[fn])):
                a, b = want[fn].get(field), row[fn].get(field)
                if a != b:
                    out.append(KernelFinding(
                        "K003", name, f"drift: {fn}.{field} is {b}, the "
                        f"baseline has {a}"))
    if check_stale and not partial:
        for name in sorted(set(table) - set(footprints)):
            out.append(KernelFinding(
                "K003", name, "stale footprint baseline entry (the case "
                "is not registered): remove it with --update-baseline"))
    return out


def dense_findings(name: str, got: dict, want: dict) -> List[KernelFinding]:
    """K002 for a dense kernel: no output element keeps the sentinel
    where the plain twin wrote a value."""
    out = []
    for o, w in sorted(want.items()):
        if o not in got:
            continue
        n = int((_sentinel_elements(got[o]) & ~_sentinel_elements(w)).sum())
        if n:
            out.append(KernelFinding(
                "K002", name, f"{n} element(s) of {o!r} were never written "
                "(the sentinel survived)"))
    return out


def check_k005(name: str, got: dict, want: dict) -> List[KernelFinding]:
    out = []
    for o in sorted(want):
        if o not in got:
            out.append(KernelFinding(
                "K005", name, f"the op returned no {o!r}"))
            continue
        g, w = got[o], want[o]
        if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype:
            out.append(KernelFinding(
                "K005", name, f"{o!r} is {g.dtype} {tuple(g.shape)}, the "
                f"plain twin's {w.dtype} {tuple(w.shape)}"))
            continue
        n = int(_differ(g, w).sum())
        if n:
            out.append(KernelFinding(
                "K005", name, f"{o!r} differs from the plain twin in {n} "
                f"of {g.numel()} element(s)"))
    return out
