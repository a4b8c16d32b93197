"""Per-step timing on the GPU with CUDA events (min-of-k), and the
exchange's bandwidth roofs on an H100.

The protocol of the JAX package's ``utils/profiling.py``
(``scan_time_per_step_samples``): runs of two lengths are differenced,
so the fixed cost of a run (state set-up, the first launch) cancels and
what remains is the cost of a step, host launch gaps included. Each
length is warmed up once, then timed ``k`` times; interference only adds
time, so the minimum is the estimate and ``spread = (max - min) / min``
is the capture's own noise floor.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

from mpi_grid_redistribute_tpu_torch.utils.stats import host_arrays


def _event_seconds(fn: Callable[[], object]):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, out


def _host_seconds(fn: Callable[[], object]):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def cuda_time_per_step_samples(make_run: Callable[[int], Callable[[], object]],
                               s1: int = 2, s2: int = 10, reps: int = 4):
    """Min-of-k seconds per step. ``make_run(S)`` returns a callable that
    enqueues an S-step run on the current CUDA stream and returns its
    output. Each of the ``reps`` long runs gives one per-step sample
    against the best short run.

    Returns ``(detail, long_out)``: ``detail`` is ``{min, max, mean,
    median, spread, k, values}`` of per-step seconds; ``long_out`` is the
    last long run's output."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_per_step_samples needs a CUDA device")
    return time_per_step_samples(make_run, s1, s2, reps, device="cuda")


def time_per_step_samples(make_run: Callable[[int], Callable[[], object]],
                          s1: int = 2, s2: int = 10, reps: int = 4,
                          device="cuda"):
    """:func:`cuda_time_per_step_samples` on ``device``: CUDA events on
    the card, the host's clock on the CPU (where the runs are
    synchronous; the bench scripts' CPU runs in the tests)."""
    if s2 <= s1 or reps < 1:
        raise ValueError(f"need s2 > s1 and reps >= 1, got {s1}, {s2}, {reps}")
    clock = (_event_seconds if torch.device(device).type == "cuda"
             else _host_seconds)

    def run(s: int):
        fn = make_run(s)
        out = fn()  # warm-up
        times = []
        for _ in range(reps):
            out = None  # free the previous run's state first
            t, out = clock(fn)
            times.append(t)
        return times, out

    times1 = run(s1)[0]
    times2, out2 = run(s2)
    t1 = min(times1)
    samples = [(t2 - t1) / (s2 - s1) for t2 in times2]
    lo, hi = min(samples), max(samples)
    detail = {
        "min": lo,
        "max": hi,
        "mean": sum(samples) / len(samples),
        "median": statistics.median(samples),
        "spread": (hi - lo) / lo if lo > 0 else 0.0,
        "k": len(samples),
        "values": samples,
    }
    return detail, out2


def cuda_time_ms(fn: Callable[[], object], iters: int = 20,
                 reps: int = 3) -> float:
    """Min over ``reps`` of the mean milliseconds of ``fn()`` across
    ``iters`` back-to-back calls (CUDA events; one warm-up call)."""
    fn()
    torch.cuda.synchronize()

    def many():
        for _ in range(iters):
            fn()

    return min(_event_seconds(many)[0] for _ in range(reps)) * 1e3 / iters


def cuda_graph_time_ms(fn: Callable[[], object], iters: int = 20,
                       reps: int = 3) -> float:
    """Like :func:`cuda_time_ms`, but the ``iters`` calls are captured in
    one CUDA graph and each rep replays it, so the time is the device's
    alone: for microsecond kernels the host's launch cost would otherwise
    set the number. ``fn`` must be capturable (no host sync, no
    allocation that outlives the capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return min(_event_seconds(graph.replay)[0]
               for _ in range(reps)) * 1e3 / iters


# Roofs of the utilization denominators, H100 SXM5 80 GB datasheet values
# (never a TPU figure):
#   * HBM3: 3.35 TB/s per card, the roof of the one-card vrank exchange,
#     whose "wire" is the card's own gathers and scatters
#     (exchange_domain "hbm");
#   * NVLink 4: 900 GB/s per GPU bidirectional over 18 links, so 450 GB/s
#     each way, the roof of the exchange across cards
#     (exchange_domain "nvlink"). Through NVSwitch one pair of cards can
#     use all of it, so it is also one link's roof in the per-link report
#     (telemetry.flow.link_report).
HBM_PEAK_BYTES_PER_SEC = 3.35e12
NVLINK_BYTES_PER_SEC = 450e9


def exchange_peak_bytes_per_sec(domain: str) -> float:
    """Peak bytes/s of an exchange domain, per card: ``"hbm"`` when the
    vrank exchange stays on one card, ``"nvlink"`` when rows cross
    cards."""
    if domain == "hbm":
        return HBM_PEAK_BYTES_PER_SEC
    if domain == "nvlink":
        return NVLINK_BYTES_PER_SEC
    raise ValueError(f"unknown exchange domain {domain!r}")


def exchange_bw_util(bytes_per_sec: float, domain: str,
                     n_chips: int = 1) -> float:
    """Fraction of the domain's peak the exchange achieves: aggregate
    ``bytes_per_sec`` over ``n_chips`` cards against one card's roof."""
    return bytes_per_sec / n_chips / exchange_peak_bytes_per_sec(domain)


def exchange_bytes_per_step(stats, row_bytes: int) -> float:
    """Mean bytes crossing the exchange a step, from a stats tuple:
    ``RedistributeStats`` (``send_counts [R, R]``, optionally stacked
    ``[S, R, R]``) or ``MigrateStats`` (``sent [R]`` or ``[S, R]``); one
    read of the leaf off the device."""
    if hasattr(stats, "sent"):
        sent = host_arrays([stats.sent])[0]
        sent = sent.reshape(-1, sent.shape[-1])  # [S, R]
    else:
        sent = host_arrays([stats.send_counts])[0]
        sent = sent.reshape((-1,) + sent.shape[-2:])  # [S, R, R]
    per_step = sent.reshape(sent.shape[0], -1).sum(axis=-1)
    return float(per_step.mean()) * row_bytes
