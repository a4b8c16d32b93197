"""Rooflines from counted costs (the port's copy of the JAX package's
``telemetry/roofline.py``).

The span tables (``telemetry/phases.py``) attribute MEASURED time;
this module supplies what the program SHOULD cost. The reference reads
XLA's cost model (``Compiled.cost_analysis()``); PyTorch has none, so
:func:`count_cost` runs the program once and COUNTS its bytes, flops and
collective payloads (the rules are ``utils/costcount.py``'s: aten ops by
their tensors, each of the six kernels by its stated formula, the
collectives by their payloads). The count does not depend on the route:
the card's kernels and the CPU's plain versions count the same, so a
kernel redesign cannot change its own denominator. Divided by the
H100's roofs in ``utils/profiling.py`` (HBM3 bytes/s, FP32 FLOP/s, the
NVLink collective roof) it gives a predicted time and a bound-by
verdict per program:

* ``compute``    — flops / peak FLOP/s dominates;
* ``memory``     — bytes accessed / HBM peak dominates;
* ``collective`` — the counted collective bytes over the NVLink roof
  dominate.

:func:`roofline_report` runs this over every registered program
(``analysis.progcheck``), cross-checks the count against the committed
collective-byte profile (``analysis/progprofile_baseline.json``; a
program missing there is journaled as a discrepancy, never dropped), and
with measured min-of-k seconds fills ``achieved_fraction`` =
predicted / measured, which ``metrics.from_journal`` surfaces as the
``grid_roofline_achieved_fraction`` gauge.

:func:`predict`, :func:`cross_check` and :func:`format_roofline_table`
are the reference's hand-math; only the default roofs differ.
"""

from __future__ import annotations

from typing import Dict, Optional

from mpi_grid_redistribute_tpu_torch.utils import costcount, profiling

# bound-by verdicts, in predict() tie-break order
BOUND_COMPUTE = "compute"
BOUND_MEMORY = "memory"
BOUND_COLLECTIVE = "collective"
BOUND_UNKNOWN = "unknown"  # no cost available

# A measured share above this means the count is too high (usually a
# kernel scope that counts what its kernel never reads): fix the count,
# never clip the share.
ACHIEVED_FRACTION_MAX = 1.05


def count_cost(fn, args) -> dict:
    """Run ``fn(*args)`` once and count what it does: ``{"flops",
    "bytes_accessed", "ops", "collective_bytes": {primitive: bytes},
    "collective_bytes_total", "collective_count", "kernels": {name:
    {"calls", "bytes", "flops"}}}`` (the rules: ``utils/costcount.py``).
    The program's outputs are dropped."""
    with costcount.counting() as counter:
        fn(*args)
    return counter.as_dict()


def predict(
    cost: Optional[Dict[str, float]],
    collective_bytes: int = 0,
    *,
    peak_flops_per_sec: float = profiling.PEAK_FLOPS_PER_SEC,
    peak_bytes_per_sec: float = profiling.HBM_PEAK_BYTES_PER_SEC,
    collective_peak_bytes_per_sec: float = profiling.NVLINK_BYTES_PER_SEC,
) -> Dict[str, object]:
    """Roofline prediction for one program (pure hand-math).

    Args:
      cost: ``{"flops", "bytes_accessed"}`` (:func:`count_cost`; ``None``
        = no cost).
      collective_bytes: the counted collective byte total, billed against
        the collective roof apart from local bytes (the wire and HBM are
        independent resources).

    Returns ``t_compute_s`` / ``t_memory_s`` / ``t_collective_s``, their
    max ``t_predicted_s`` and the ``bound_by`` verdict (ties break
    compute < memory < collective, so a 0-cost program reads
    ``compute``-bound at 0 s)."""
    t_coll = float(collective_bytes) / collective_peak_bytes_per_sec
    if cost is None:
        return {
            "flops": None,
            "bytes_accessed": None,
            "t_compute_s": None,
            "t_memory_s": None,
            "t_collective_s": t_coll,
            "t_predicted_s": t_coll,
            "bound_by": BOUND_UNKNOWN,
        }
    t_comp = cost["flops"] / peak_flops_per_sec
    t_mem = cost["bytes_accessed"] / peak_bytes_per_sec
    t_pred = max(t_comp, t_mem, t_coll)
    if t_pred == t_comp:
        bound = BOUND_COMPUTE
    elif t_pred == t_mem:
        bound = BOUND_MEMORY
    else:
        bound = BOUND_COLLECTIVE
    return {
        "flops": cost["flops"],
        "bytes_accessed": cost["bytes_accessed"],
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "t_predicted_s": t_pred,
        "bound_by": bound,
    }


def cross_check(
    cost: Optional[Dict[str, float]],
    static_profile: Optional[dict],
    wire: Optional[dict],
) -> Dict[str, object]:
    """Count vs committed collective profile, for one program.

    The collective byte total is a LOWER bound on the memory traffic
    (every wired byte is read and written at least once), so
    ``bytes_accessed < collective_bytes_total`` means one of the two
    counts is wrong, as does a missing cost. Either way the caller
    journals it. ``wire`` is the reference's per-domain wire attribution
    (S004); the port has none and passes ``None``."""
    static_bytes = None
    ici_bytes = None
    if static_profile is not None:
        static_bytes = int(static_profile.get("collective_bytes_total", 0))
    if wire is not None:
        ici_bytes = int(wire.get("per_domain", {}).get("ici", 0))
    if cost is None:
        return {
            "static_collective_bytes": static_bytes,
            "static_ici_bytes": ici_bytes,
            "bytes_ratio": None,
            "discrepancy": True,
            "discrepancy_reason": "no cost model on this backend",
        }
    if static_bytes is None:
        return {
            "static_collective_bytes": None,
            "static_ici_bytes": ici_bytes,
            "bytes_ratio": None,
            "discrepancy": True,
            "discrepancy_reason": "program missing from the J004 baseline"
            " — run python -m mpi_grid_redistribute_tpu_torch.analysis."
            "progcheck --update-baseline",
        }
    ratio = (
        cost["bytes_accessed"] / static_bytes if static_bytes > 0 else None
    )
    if static_bytes > 0 and cost["bytes_accessed"] < static_bytes:
        return {
            "static_collective_bytes": static_bytes,
            "static_ici_bytes": ici_bytes,
            "bytes_ratio": ratio,
            "discrepancy": True,
            "discrepancy_reason": (
                "cost-model bytes accessed "
                f"({cost['bytes_accessed']:.0f}) below the static "
                f"collective total ({static_bytes}) — one model is wrong"
            ),
        }
    return {
        "static_collective_bytes": static_bytes,
        "static_ici_bytes": ici_bytes,
        "bytes_ratio": ratio,
        "discrepancy": False,
        "discrepancy_reason": "",
    }


def measure_programs(programs, device=None, n_local=None, s1: int = 1,
                     s2: int = 3, reps: int = 3,
                     costs: Optional[dict] = None) -> Dict[str, float]:
    """Min-of-k seconds a call of each program on ``device`` (CUDA
    events on the card, :func:`..utils.profiling.
    cuda_time_per_step_samples`; the host's clock on the CPU): runs of
    ``s1`` and ``s2`` back-to-back calls, differenced. Sharded programs
    are skipped (their ranks run in another process). A ``costs`` dict
    is filled with each timed program's :func:`count_cost`, counted on
    the same build (one build a program)."""
    from mpi_grid_redistribute_tpu_torch import _device

    dev = _device.resolve(device)
    out = {}
    for name in sorted(programs):
        spec = programs[name]
        if spec.topology == "sharded":
            continue
        fn, args = spec.build(device=dev, n_local=n_local)
        if costs is not None:
            costs[name] = count_cost(fn, args)

        def make_run(S, fn=fn, args=args):
            def run():
                res = None
                for _ in range(S):
                    res = fn(*args)
                return res
            return run

        if dev.type == "cuda":
            detail, _ = profiling.cuda_time_per_step_samples(
                make_run, s1=s1, s2=s2, reps=reps)
        else:
            detail, _ = profiling.time_per_step_samples(
                make_run, s1=s1, s2=s2, reps=reps, device=dev)
        out[name] = detail["min"]
    return out


def over_roof(report: Dict[str, dict],
              limit: float = ACHIEVED_FRACTION_MAX) -> list:
    """The programs of a :func:`roofline_report` whose measured
    ``achieved_fraction`` exceeds ``limit``, sorted."""
    return sorted(name for name, row in report.items()
                  if (row.get("achieved_fraction") or 0.0) > limit)


def roofline_report(
    programs: Optional[dict] = None,
    measured_s: Optional[Dict[str, float]] = None,
    recorder=None,
    *,
    costs: Optional[Dict[str, dict]] = None,
    device=None,
    n_local: Optional[int] = None,
    peak_flops_per_sec: float = profiling.PEAK_FLOPS_PER_SEC,
    peak_bytes_per_sec: float = profiling.HBM_PEAK_BYTES_PER_SEC,
) -> Dict[str, dict]:
    """Predicted-vs-achieved roofline rows for every registered program.

    Args:
      programs: registry subset (default: all 17,
        ``analysis.progcheck.default_programs()``).
      measured_s: optional ``{program: min-of-k seconds a call}``
        (:func:`measure_programs`); fills ``measured_s`` and
        ``achieved_fraction`` (predicted / measured).
      recorder: optional ``StepRecorder``: every row is journaled as a
        ``roofline`` event, discrepant rows included.
      costs: counted costs (:func:`count_cost` a program); default: count
        every program now on ``device`` at ``n_local``
        (``progcheck.program_costs``; the sharded ones in a world of 8).

    Returns ``{program: row}``, each row :func:`predict` and
    :func:`cross_check` merged with the measured columns (and the counted
    ``collective_bytes_total`` beside the committed one)."""
    from mpi_grid_redistribute_tpu_torch.analysis import progcheck
    from mpi_grid_redistribute_tpu_torch.analysis.baseline import (
        load_progprofile_baseline,
    )

    programs = progcheck.default_programs() if programs is None else programs
    if costs is None:
        costs = progcheck.program_costs(programs, device=device,
                                        n_local=n_local)
    measured_s = measured_s or {}
    static = load_progprofile_baseline() or {}
    report: Dict[str, dict] = {}
    for name in sorted(programs):
        cost = costs.get(name)
        prof = static.get(name)
        coll = int(prof.get("collective_bytes_total", 0)) if prof else 0
        row = predict(
            cost,
            coll,
            peak_flops_per_sec=peak_flops_per_sec,
            peak_bytes_per_sec=peak_bytes_per_sec,
        )
        row.update(cross_check(cost, prof, None))
        row["counted_collective_bytes"] = (
            None if cost is None else cost["collective_bytes_total"])
        meas = measured_s.get(name)
        row["measured_s"] = meas
        row["achieved_fraction"] = (
            None
            if meas is None or not row["t_predicted_s"] or meas <= 0
            else row["t_predicted_s"] / meas
        )
        report[name] = row
        if recorder is not None:
            recorder.record(
                "roofline",
                program=name,
                phase="total",
                flops=row["flops"],
                bytes_accessed=row["bytes_accessed"],
                t_predicted_s=row["t_predicted_s"],
                bound_by=row["bound_by"],
                static_collective_bytes=row["static_collective_bytes"],
                bytes_ratio=row["bytes_ratio"],
                discrepancy=row["discrepancy"],
                discrepancy_reason=row["discrepancy_reason"],
                measured_s=meas,
                achieved_fraction=row["achieved_fraction"],
            )
    return report


def format_roofline_table(report: Dict[str, dict]) -> str:
    """Markdown roofline table (one row per program)."""
    lines = [
        "| program | flops | bytes | pred ms | bound by | achieved | "
        "xcheck |",
        "|---|---|---|---|---|---|---|",
    ]

    def _num(v, scale=1.0, fmt="{:.2f}"):
        return "—" if v is None else fmt.format(v * scale)

    for name in sorted(report):
        r = report[name]
        xc = "DISCREPANT" if r["discrepancy"] else "ok"
        lines.append(
            f"| {name} | {_num(r['flops'], 1e-6)}M "
            f"| {_num(r['bytes_accessed'], 1e-6)}MB "
            f"| {_num(r['t_predicted_s'], 1e3, '{:.4f}')} "
            f"| {r['bound_by']} "
            f"| {_num(r['achieved_fraction'], 100.0)}% "
            f"| {xc} |"
        )
    return "\n".join(lines)
