"""Phase attribution from the program's own spans, and the spans (the
port's counterpart of the JAX package's ``telemetry/phases.py``).

:func:`attribute_phases` runs a whole, uncut loop once under
``torch.profiler`` and charges each device operation (on the CPU, each
host op) to the innermost listed span open when it was launched; what
the enclosing span launched outside the listed ones is the ``"rest"``
row, so a table adds up to the whole by construction. Each row can be
held against a logical-bytes roofline; :func:`format_phase_table` prints
the table.

:func:`span` and :func:`traced_span` label regions for
``torch.profiler`` traces (``record_function`` ranges: they show on the
host timeline, on the same clock as the device's events, and group the
kernels launched inside them). They cost one check when nothing
records: a ``record_function`` range costs ~10 us of host time even with
no profiler running, so they open one only while a profiler or a
``utils.costcount`` recording is active, and otherwise return one shared
no-op context. :func:`host_read` is the one way the loop reads a device
value on the host: it counts the read and labels its wait ``sync:<site>``.

The drift loop's span names begin with one of :data:`SPAN_PREFIXES`; a
trace's reader tells the loop's ranges from device work by them.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from mpi_grid_redistribute_tpu_torch.utils import costcount, profiling

# the prefixes of the drift loop's span names: the migrate step ("mig:"),
# the deposit ("dep:"), the collectives ("coll:") and the host reads
# ("sync:")
SPAN_PREFIXES = ("mig:", "dep:", "coll:", "sync:")

_NOOP = contextlib.nullcontext()


def span(name: str):
    """Host-side profiler span: ``with span('exchange'): out = fn(x)``, a
    ``torch.profiler.record_function`` range while a profiler or a
    ``costcount`` recording is active, else a shared no-op context."""
    if (torch.autograd._profiler_enabled()
            or costcount.region(name) is not None):
        return torch.profiler.record_function(name)
    return _NOOP


class _RecordedSpan:
    """A ``record_function`` range that is also a region of the
    recording ``utils.costcount`` block around it."""

    def __init__(self, name: str, region):
        self._range = torch.profiler.record_function(name)
        self._region = region

    def __enter__(self):
        self._range.__enter__()
        self._region.__enter__()
        return self

    def __exit__(self, *exc):
        self._region.__exit__(*exc)
        return self._range.__exit__(*exc)


def traced_span(name: str):
    """Span around an engine's own phases (``'rd:bin'``, ``'rd:pack'``):
    the same range as :func:`span`, gated the same way; the JAX package
    needs a separate kind inside ``jit``, the port does not. While a
    ``utils.costcount.counting(record=True)`` block records on this
    thread, the span is also a region of its record (what progcheck's
    J003 reads)."""
    region = costcount.region(name)
    if region is not None:
        return _RecordedSpan(name, region)
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NOOP


def host_read(counter: dict, site: str, flag: torch.Tensor) -> bool:
    """``bool(flag)``, read on the host: the one way the loop waits for
    the device. Counts the read in ``counter[site]`` (the module's
    ``HOST_SYNCS``) every time, and while something records labels the
    wait with a ``sync:<site>`` span, so a trace shows how long the host
    waited there and how many reads a step made."""
    counter[site] += 1
    with span("sync:" + site):
        # the read this helper exists for; each caller's line carries
        # its own gridlint sanction
        return bool(flag)  # gridlint: disable=G002


class PhaseTiming(NamedTuple):
    """One row of a span table, a step's share: ``delta_s`` is the time
    of the operations charged to the span ``phase`` (or to :data:`REST`),
    ``cumulative_s`` the running sum of the rows up to this one, so the
    last row's is the whole step; roofline fields are populated when
    logical bytes were supplied."""

    phase: object
    cumulative_s: float
    delta_s: float
    logical_bytes: Optional[int] = None
    roofline_s: Optional[float] = None

    @property
    def x_roofline(self) -> Optional[float]:
        """measured time / roofline time; >>1 flags latency/serialization
        bound (scatters, sorts), not a bandwidth wall."""
        if not self.roofline_s or self.roofline_s <= 0:
            return None
        return self.delta_s / self.roofline_s


# the row of what the enclosing span (or the whole call) launched outside
# every listed span
REST = "rest"

# the trace's device operations, and the host calls that launch them
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class SpanTrace(NamedTuple):
    """A profiled call, reduced: ``ops`` is ``(t, us)`` of every device
    operation (on the CPU, every host op not nested in another), ``t``
    the host time it was launched (began); ``ranges`` is ``(name, start,
    end)`` of every span, by start. Microseconds on the trace's clock."""

    ops: List[Tuple[float, float]]
    ranges: List[Tuple[str, float, float]]

    @classmethod
    def from_chrome(cls, data: dict, device: str) -> "SpanTrace":
        """On ``"cuda"`` a kernel, copy or set is tied to its launch by
        its correlation id; elsewhere each outermost host op is one
        operation."""
        ranges, launches, dev_ops, host_ops = [], {}, [], []
        for e in data.get("traceEvents", []):
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            corr = e.get("args", {}).get("correlation")
            if cat == "user_annotation":
                ranges.append((e["name"], ts, ts + dur))
            elif cat in _DEVICE_CATS and corr is not None:
                dev_ops.append((int(corr), dur))
            elif cat in _LAUNCH_CATS and corr is not None:
                launches[int(corr)] = ts
            elif cat == "cpu_op":
                host_ops.append((ts, ts + dur))
        if device == "cuda":
            ops = [(launches[c], us) for c, us in dev_ops if c in launches]
        else:
            ops, end = [], float("-inf")
            for s0, e0 in sorted(host_ops):
                if s0 >= end:  # an op nested in another is the outer's
                    ops.append((s0, e0 - s0))
                    end = e0
        ranges.sort(key=lambda r: r[1])
        return cls(sorted(ops), ranges)

    def seconds_in(self, name: Optional[str] = None) -> float:
        """Time of the operations launched inside any span ``name``, at
        any depth (``None``: every operation of the call)."""
        if name is None:
            return sum(us for _, us in self.ops) * 1e-6
        spans = []
        for n, s, e in self.ranges:
            if n != name:
                continue
            if spans and s <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], e)
            else:
                spans.append([s, e])
        starts = [s for s, _ in spans]
        total = 0.0
        for t, us in self.ops:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += us
        return total * 1e-6


def profile_call(fn: Callable, args, device="cuda"):
    """``fn(*args)`` once to warm (kernels built, caches filled), then
    once under ``torch.profiler``; returns ``(out, SpanTrace)`` of the
    second call. The Chrome trace goes through a temporary file in
    ``TMPDIR``, deleted once read."""
    from torch.profiler import ProfilerActivity

    dev = torch.device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    warm = fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    del warm  # large outputs must not pile up
    with torch.profiler.profile(activities=acts) as prof:
        out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return out, SpanTrace.from_chrome(data, dev.type)


def phase_rows(trace: SpanTrace, spans: Sequence[str], *,
               whole: Optional[str] = None, steps: int = 1,
               phase_bytes: Optional[dict] = None,
               peak_bytes_per_sec: float = profiling.HBM_PEAK_BYTES_PER_SEC,
               ) -> List[PhaseTiming]:
    """The span table of ``trace``: one row per name of ``spans``, then
    :data:`REST`, each a step's share (the call's time over ``steps``).

    An operation goes to the innermost listed span open when it was
    launched, wherever that span is; one inside no listed span goes to
    the rest if it was launched inside a ``whole`` span (``None``: the
    whole call), and is left out otherwise. ``phase_bytes`` (``{row:
    logical_bytes}``, the least traffic a row's math implies a step)
    fills the roofline columns."""
    listed = [r for r in trace.ranges if r[0] in spans]
    starts = [s for _, s, _ in listed]
    outer = [(s, e) for n, s, e in trace.ranges if n == whole]
    outer_starts = [s for s, _ in outer]
    us = dict.fromkeys(list(spans) + [REST], 0.0)
    for t, d in trace.ops:
        # the latest-starting listed span still open at t is the
        # innermost: spans nest on the launching thread
        for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if t <= listed[j][2]:
                us[listed[j][0]] += d
                break
        else:
            i = bisect.bisect_right(outer_starts, t) - 1
            if whole is None or (i >= 0 and t <= outer[i][1]):
                us[REST] += d
    rows, cum = [], 0.0
    for name, total in us.items():
        sec = total * 1e-6 / steps
        cum += sec
        lb = None if phase_bytes is None else phase_bytes.get(name)
        roof = None if lb is None else lb / peak_bytes_per_sec
        rows.append(PhaseTiming(name, cum, sec, lb, roof))
    return rows


def attribute_phases(
    loop: Callable,
    args,
    spans: Sequence[str],
    *,
    whole: Optional[str] = None,
    steps: int = 1,
    phase_bytes: Optional[dict] = None,
    peak_bytes_per_sec: float = profiling.HBM_PEAK_BYTES_PER_SEC,
    device="cuda",
) -> List[PhaseTiming]:
    """Attribute a step's time to the program's spans: ``loop(*args)``
    runs ``steps`` whole steps; after a warm call one call is profiled
    (:func:`profile_call`) and read by :func:`phase_rows` (``whole``,
    ``phase_bytes``, ``peak_bytes_per_sec`` as there). Device time on
    the card, the host ops' time on the CPU. Returns one
    :class:`PhaseTiming` per span and one for :data:`REST`, in order."""
    _, trace = profile_call(loop, args, device)
    return phase_rows(trace, spans, whole=whole, steps=steps,
                      phase_bytes=phase_bytes,
                      peak_bytes_per_sec=peak_bytes_per_sec)


def format_phase_table(timings: Sequence[PhaseTiming]) -> str:
    """Markdown span table: ms a step, the running sum, logical MB,
    roofline ms, x-roofline."""
    lines = [
        "| span | ms | cumulative | logical MB | roofline ms "
        "| x-roofline |",
        "|---|---|---|---|---|---|",
    ]
    for t in timings:
        mb = "—" if t.logical_bytes is None else f"{t.logical_bytes/1e6:8.1f}"
        roof = "—" if t.roofline_s is None else f"{t.roofline_s*1e3:6.2f}"
        xr = t.x_roofline
        xcol = "—" if xr is None else f"{xr:6.1f}"
        lines.append(
            f"| {t.phase} | {t.delta_s*1e3:7.3f} | {t.cumulative_s*1e3:7.3f} "
            f"| {mb} | {roof} | {xcol} |"
        )
    return "\n".join(lines)
