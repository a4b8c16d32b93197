"""Config 7 on one GPU: the full-reshuffle stress, the exchange's bandwidth
utilization when nearly every row moves every step (the twin of the JAX
package's ``bench/config7_stress.py``).

The drift configs move ~2% of the rows a step, so their exchange says
little about its own headroom. Here each row carries a per-axis offset
drawn uniform in ``[0, 1)`` and a step is ``pos' = wrap(pos + offset)``:
every step sends each row to an effectively uniform random vrank (~7/8
change owner on the 2x2x2 grid). Rows carry 8 int32 payload rows beside
pos (3) and the offset (3), so the wire moves a 56-byte record.

The loop is the planar canonical exchange
(:func:`..parallel.exchange.vrank_redistribute_planar_fn`) over the grid
as 8 vranks on one card, timed with
:func:`..utils.profiling.time_per_step_samples` (runs of 4 and 20 steps
differenced, min of ``reps``), and reported through
:func:`..telemetry.report.exchange_report` against the card's HBM3 roof
(``"hbm"``: the vrank wire is gathers and scatters in device memory).
It reaches no hand-written kernel, as the reference's loop reaches no
TPU kernel.

    python -m mpi_grid_redistribute_tpu_torch.bench.config7_stress

sweeps 2^18, 2^19 and 2^20 total rows (times ``BENCH_SCALE``) and
reports the size of peak utilization with the others under ``"sweep"``;
``BENCH_STRESS_N=n`` runs one size. It raises on a dropped row or a lost
one.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch import _device
from mpi_grid_redistribute_tpu_torch.bench import common
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.models import nbody
from mpi_grid_redistribute_tpu_torch.ops import binning
from mpi_grid_redistribute_tpu_torch.parallel import exchange
from mpi_grid_redistribute_tpu_torch.telemetry import report as report_lib
from mpi_grid_redistribute_tpu_torch.utils import profiling
from mpi_grid_redistribute_tpu_torch.utils.stats import host_arrays

# int32 payload rows riding beside pos (3) and the offset (3): ids,
# masses, tags... row_bytes = 4 * (3 + 3 + 8) = 56
N_PAYLOAD_ROWS = 8


def run(n_total: int = None, reps: int = 3, device=None) -> dict:
    """One measurement (``n_total`` rows, or ``BENCH_STRESS_N``), or the
    sweep, reporting the size of PEAK bandwidth utilization (the per-row
    cost grows with the population) with every size under ``"sweep"``."""
    if n_total is None and "BENCH_STRESS_N" not in os.environ:
        scale = float(os.environ.get("BENCH_SCALE", 1.0))
        sizes = [max(1 << 13, int(scale * n))
                 for n in (1 << 18, 1 << 19, 1 << 20)]
        outs = [_run_one(n, reps, device) for n in sizes]
        best = dict(max(outs, key=lambda o: o["bw_util"]))
        best["sweep"] = [
            {k: o[k] for k in ("rows", "bw_util", "ms_per_step",
                               "exchange_gb_per_sec")}
            for o in outs
        ]
        return best
    if n_total is None:
        n_total = int(os.environ["BENCH_STRESS_N"])
    return _run_one(n_total, reps, device)


def _sizes(n_total: int):
    """``(slots, n_live)`` a vrank: 90% of the slots live."""
    slots = max(1024, n_total // 8)
    return slots, int(0.9 * slots)


def initial_state(n_total: int):
    """``(fused [8, 14, slots] float32, count [8] int32, n_live)``: the
    reference's state from ``default_rng(7)``: live rows uniform over the
    box, offsets uniform in ``[0, 1)``, payload rows ``arange`` as int32
    bits."""
    vR = 8
    slots, n_live = _sizes(n_total)
    K = 3 + 3 + N_PAYLOAD_ROWS
    rng = np.random.default_rng(7)
    fused = np.zeros((vR, K, slots), np.float32)
    fused[:, :3, :n_live] = rng.random((vR, 3, n_live), dtype=np.float32)
    fused[:, 3:6, :n_live] = rng.random((vR, 3, n_live), dtype=np.float32)
    payload = np.arange(vR * N_PAYLOAD_ROWS * slots, dtype=np.int32)
    fused[:, 6:, :] = payload.reshape(vR, N_PAYLOAD_ROWS, slots).view(
        np.float32)
    return fused, np.full((vR,), n_live, np.int32), n_live


def make_step(n_total: int):
    """``(step, cap)``: one stress step ``step(fused, count) -> (fused,
    count, stats)`` (wrap, then the planar exchange) at the reference's
    capacity ``ceil(n_live / 8 * 1.6)``."""
    vgrid = ProcessGrid((2, 2, 2))
    domain = Domain(0.0, 1.0, periodic=True)
    slots, n_live = _sizes(n_total)
    # destinations are uniform, so each of the R^2 pairs carries ~n_live/R
    # rows; 1.6x covers the multinomial tail at small n
    cap = max(64, math.ceil(n_live / 8 * 1.6))
    xfn = exchange.vrank_redistribute_planar_fn(domain, vgrid, cap, slots)

    def step(f, c):
        p = binning.wrap_periodic_planar(f[:, :3, :] + f[:, 3:6, :], domain)
        return xfn(torch.cat([p, f[:, 3:, :]], dim=1), c)

    return step, cap


def _run_one(n_total: int, reps: int = 3, device=None) -> dict:
    dev = _device.resolve(device)
    vR = 8
    fused, count, n_live = initial_state(n_total)
    row_bytes = fused.shape[1] * 4
    step, _ = make_step(n_total)
    f0 = torch.from_numpy(fused).to(dev)
    c0 = torch.from_numpy(count).to(dev)

    def make_run(S):
        def go():
            f, c = f0, c0
            steps = []
            for _ in range(S):
                f, c, stats = step(f, c)
                steps.append(stats)
            return f, c, nbody._stack_redistribute_stats(steps, vR, dev)
        return go

    detail, (_, count_out, stats) = profiling.time_per_step_samples(
        make_run, s1=4, s2=20, reps=reps, device=dev)
    dropped_send, dropped_recv, live = host_arrays(
        [stats.dropped_send, stats.dropped_recv, count_out])
    if int(dropped_send.sum()):
        raise RuntimeError(
            "stress loop dropped rows on send: capacity sizing bug")
    if int(dropped_recv.sum()):
        raise RuntimeError(
            "stress loop dropped rows on recv: out_capacity sizing bug")
    if int(live.sum()) != vR * n_live:
        raise RuntimeError(
            f"stress loop lost rows: {int(live.sum())} of {vR * n_live}")
    report = report_lib.exchange_report(
        stats, row_bytes, step_seconds=detail["min"], domain="hbm",
        n_chips=1)
    moved_frac = report["stats"]["moved_fraction"]
    out = {
        "metric": "config7_stress_bw_util",
        "value": round(report["bw_util"], 6),
        "unit": "fraction_of_hbm_peak",
        "engine": "planar",
        "rows": vR * n_live,
        "vranks": vR,
        "row_bytes": row_bytes,
        # ~7/8 on a 2x2x2 grid: the full-reshuffle regime
        "migration_fraction": round(moved_frac, 4),
        "ms_per_step": round(detail["min"] * 1e3, 3),
        "timing_spread": round(detail["spread"], 4),
        "timing_k": detail["k"],
        "pps": round(vR * n_live / detail["min"], 2),
        "exchange_bytes_per_step": report["exchange_bytes_per_step"],
        "moved_bytes_per_step": report["moved_bytes_per_step"],
        "exchange_bytes_per_sec": report["exchange_bytes_per_sec"],
        "exchange_gb_per_sec": round(report["exchange_gb_per_sec"], 3),
        "bw_util": round(report["bw_util"], 6),
        "exchange_domain": report["exchange_domain"],
    }
    common.log(
        f"config7: full reshuffle {moved_frac * 100:.1f}% rows/step, "
        f"{detail['min'] * 1e3:.2f} ms/step (spread "
        f"{detail['spread'] * 100:.1f}%), "
        f"{report['exchange_gb_per_sec']:.2f} GB/s = "
        f"{report['bw_util'] * 100:.2f}% of the HBM3 roof")
    return out


if __name__ == "__main__":
    print(json.dumps(run()), flush=True)
