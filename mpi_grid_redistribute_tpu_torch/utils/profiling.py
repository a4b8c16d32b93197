"""Per-step timing on the GPU with CUDA events (min-of-k).

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
