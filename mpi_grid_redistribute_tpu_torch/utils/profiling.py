"""Per-step timing on the GPU with CUDA events (min-of-k), the
reference's length-differenced loop timing (:func:`scan_time_per_step`,
:func:`scan_time_per_step_samples`: the host's clock around calls that
end in a one-element read), and the exchange's bandwidth roofs on an
H100.

The protocol of the JAX package's ``utils/profiling.py``
(``scan_time_per_step_samples``): runs of two lengths are differenced,
so the fixed cost of a run (state set-up, the first launch) cancels and
what remains is the cost of a step, host launch gaps included. Each
length is warmed up once, then timed ``k`` times; interference only adds
time, so the minimum is the estimate and ``spread = (max - min) / min``
is the capture's own noise floor. A step costs time: when the best long
run reads no slower than the best short one, interference swamped the
difference, so both lengths are timed again (the minima can only fall
toward the truth) until it is positive, and a step time <= 0 is refused
(a knockout's cut step, which may cost less than the noise at a toy
size, asks for its readings as they are).
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
    median, spread, k, values}`` of per-step seconds; ``long_out`` is
    the last long run's output."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_per_step_samples needs a CUDA device")
    return time_per_step_samples(make_run, s1, s2, reps, device="cuda")


# rounds of ``reps`` more runs of each length taken, at most, when the
# difference is not positive, before the measurement is refused
MAX_EXTRA_ROUNDS = 8


def time_per_step_samples(make_run: Callable[[int], Callable[[], object]],
                          s1: int = 2, s2: int = 10, reps: int = 4,
                          device="cuda"):
    """:func:`cuda_time_per_step_samples` on ``device``: CUDA events on
    the card, the host's clock on the CPU (where the runs are
    synchronous; the bench scripts' CPU runs in the tests). Both
    lengths are re-timed (at most :data:`MAX_EXTRA_ROUNDS` more rounds of
    ``reps``) while the best long run is no slower than the best short
    one, then it raises."""
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
    for _ in range(MAX_EXTRA_ROUNDS):
        if min(times2) > min(times1):
            break
        out2 = None
        times1 += run(s1)[0]
        more, out2 = run(s2)
        times2 += more
    if min(times2) <= min(times1):
        raise RuntimeError(
            f"time_per_step_samples: the best {s2}-step run "
            f"({min(times2):.6g} s) was no slower than the best {s1}-step "
            f"run ({min(times1):.6g} s) after {len(times2)} reps: the "
            "difference is noise, not a step; time longer runs")
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


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for v in out:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def fetch_barrier(out) -> None:
    """Hard barrier: read one element of the first tensor in ``out`` to
    the host (the device has then finished everything issued before)."""
    t = _first_tensor(out)
    if t is not None and t.numel():
        t.reshape(-1)[:1].cpu()


def scan_time_per_step(make_loop: Callable[[int], Callable], args,
                       s1: int = 8, s2: int = 72, reps: int = 2,
                       clock: Callable[[], float] = time.perf_counter):
    """Per-step seconds of ``make_loop(S)(*args)`` by length differencing
    (the reference's ``scan_time_per_step``, whose loop is one
    ``lax.scan``; ``make_loop(S)`` returns a callable that runs S steps,
    and :func:`fetch_barrier` ends each call). Returns
    ``(per_step_seconds, fixed_overhead_seconds, long_loop_output)``:
    the overhead is the per-call cost the differencing removed, and the
    long loop's output lets a caller read its stats without another
    call. ``clock`` is the host clock read around each call. As in
    :func:`time_per_step_samples`, a step time <= 0 is never returned:
    both lengths are timed again while the best long call is no slower
    than the best short one, and then it raises."""
    per_step, overhead, out, _ = _scan_time_impl(make_loop, args, s1, s2,
                                                 reps, clock)
    return per_step, overhead, out


def scan_time_per_step_samples(make_loop: Callable[[int], Callable], args,
                               s1: int = 8, s2: int = 72, reps: int = 4,
                               clock: Callable[[], float] = time.perf_counter):
    """Min-of-k :func:`scan_time_per_step` with its spread: each loop is
    built once and warmed up once, then ``reps`` long calls each give one
    per-step sample against the best short call. Returns ``(detail,
    long_out)``, ``detail`` the reference's ``{min, max, mean, spread, k,
    values}`` of per-step seconds."""
    _per_step, _overhead, out, samples = _scan_time_impl(
        make_loop, args, s1, s2, reps, clock)
    lo, hi = min(samples), max(samples)
    detail = {
        "min": lo,
        "max": hi,
        "mean": sum(samples) / len(samples),
        "spread": (hi - lo) / lo if lo > 0 else 0.0,
        "k": len(samples),
        "values": samples,
    }
    return detail, out


def _scan_time_impl(make_loop, args, s1, s2, reps, clock):
    if s2 <= s1:
        raise ValueError(f"need s2 > s1 for differencing, got {s1} >= {s2}")
    loops = {s: make_loop(s) for s in (s1, s2)}

    def run(s: int, warm: bool):
        out = None
        if warm:
            out = loops[s](*args)
            fetch_barrier(out)
        times = []
        for _ in range(reps):
            out = None  # free the previous call's state first
            t0 = clock()
            out = loops[s](*args)
            fetch_barrier(out)
            times.append(clock() - t0)
        return times, out

    times1, out1 = run(s1, True)
    del out1
    times2, out2 = run(s2, True)
    for _ in range(MAX_EXTRA_ROUNDS):
        if min(times2) > min(times1):
            break
        out2 = None
        times1 += run(s1, False)[0]
        more, out2 = run(s2, False)
        times2 += more
    if min(times2) <= min(times1):
        raise RuntimeError(
            f"scan_time_per_step: the best {s2}-step call "
            f"({min(times2):.6g} s) was no slower than the best {s1}-step "
            f"call ({min(times1):.6g} s) after {len(times2)} reps: the "
            "difference is noise, not a step; time longer loops")
    t1 = min(times1)
    samples = [(t2 - t1) / (s2 - s1) for t2 in times2]
    per_step = min(samples)
    return per_step, t1 - per_step * s1, out2, samples


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
#     (telemetry.flow.link_report);
#   * FP32 outside the tensor cores: 67 TFLOP/s (the data sheet's "FP32"
#     line), the compute roof of telemetry.roofline: nothing on these
#     paths runs on the tensor cores.
HBM_PEAK_BYTES_PER_SEC = 3.35e12
NVLINK_BYTES_PER_SEC = 450e9
PEAK_FLOPS_PER_SEC = 67e12


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
