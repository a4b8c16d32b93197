"""The traced run: a ``torch.profiler`` trace of the card, reduced to what
the per-layer readers need, and the readers themselves, found by file.

:func:`profile` runs a function under the profiler and returns a
:class:`Trace` of the chrome trace it exports: device operations
(kernels, copies, sets) with their correlation ids, the host's launch
calls, and the ``record_function`` ranges of the program and of the
harness (``bench:window`` around the traced calls, ``bench:call`` around
each, ``bench:turn`` around the turns of clustered rows before a call,
``bench:edit`` around the edit of the one-shot call's input before a
call).
A device operation belongs to the ranges open on the host when it was
launched.

Each file of ``metrics/`` is one per-layer metric: it sets ``NAME``,
``UNIT``, ``LAYER``, ``MOVES`` and ``SOURCE`` and defines ``read(ctx) ->
float | None``; ``None`` means the run had nothing for it to read, and
the metric is left out of the line (the cells it reads in are listed in
``BENCHMARK.json``). The line names it ``NAME`` followed by the cell's
``metric_suffix``, as it does the end-to-end metric it moves.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import os
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

METRICS_DIR = Path(__file__).resolve().parent / "metrics"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench:window"
CALL = "bench:call"
TURN = "bench:turn"
EDIT = "bench:edit"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class Trace:
    """Times in microseconds on the trace's clock. ``device``: ``(name,
    start, end, correlation)`` of every device operation; ``launches``:
    correlation -> host time of the launch; ``ranges``: ``(name, start,
    end)`` of the host ranges, by start."""

    device: List[Tuple[str, float, float, int]]
    launches: Dict[int, float]
    ranges: List[Tuple[str, float, float]]

    @classmethod
    def from_chrome(cls, data: dict) -> "Trace":
        device, launches, ranges = [], {}, []
        for e in data.get("traceEvents", []):
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                corr = int(e.get("args", {}).get("correlation", -1))
                device.append((e["name"], ts, ts + dur, corr))
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[int(corr)] = ts
            elif cat == "user_annotation":
                ranges.append((e["name"], ts, ts + dur))
        device.sort(key=lambda x: x[1])
        ranges.sort(key=lambda x: x[1])
        return cls(device, launches, ranges)

    def window(self) -> Optional[Tuple[float, float]]:
        for name, s, e in self.ranges:
            if name == WINDOW:
                return s, e
        return None

    def named(self, prefix: str) -> List[Tuple[float, float]]:
        """Ranges whose name starts with ``prefix``, overlaps merged."""
        return _merge([(s, e) for n, s, e in self.ranges
                       if n.startswith(prefix)])

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.ranges if n == name)

    def host_us(self, name: str) -> float:
        return sum(e - s for n, s, e in self.ranges if n == name)

    def device_us_in(self, prefix: str, kernel: str = None) -> float:
        """Device time of the operations launched inside a range named
        ``prefix...`` (only kernels whose name holds ``kernel``, if
        given)."""
        spans = self.named(prefix)
        starts = [s for s, _ in spans]
        total = 0.0
        for name, s, e, corr in self.device:
            if kernel is not None and kernel not in name:
                continue
            t = self.launches.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += e - s
        return total

    def kernel_durations(self, kernel: str) -> List[float]:
        return [e - s for n, s, e, _ in self.device if kernel in n]

    def busy_us(self) -> Tuple[float, float]:
        """``(busy, window)``: the time inside the traced window in which
        some operation ran on the device, and the window's length."""
        w = self.window()
        if w is None:
            return 0.0, 0.0
        busy = 0.0
        for s, e in _merge([(s, e) for _, s, e, _ in self.device]):
            s, e = max(s, w[0]), min(e, w[1])
            if e > s:
                busy += e - s
        return busy, w[1] - w[0]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, by name, and the
        device's idle gaps inside the window summed by the innermost host
        range open when each began; seconds."""
        ops: Dict[str, float] = {}
        w = self.window()
        for name, s, e, _ in self.device:
            if w is None or (s >= w[0] and e <= w[1]):
                key = name[:120]
                ops[key] = ops.get(key, 0.0) + (e - s)
        gaps: Dict[str, float] = {}
        if w is not None:
            busy = [iv for iv in _merge([(s, e) for _, s, e, _ in self.device])
                    if iv[1] > w[0] and iv[0] < w[1]]
            t = w[0]
            starts = [s for _, s, _ in self.ranges]
            for s, e in busy + [[w[1], w[1]]]:
                if s > t:
                    label = self._innermost(t, starts)
                    gaps[label] = gaps.get(label, 0.0) + (s - t)
                t = max(t, e)

        def top_of(d):
            return [[k, v * 1e-6] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": top_of(ops), "idle_gaps": top_of(gaps)}

    def _innermost(self, t: float, starts) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - 4000), -1):
            name, s, e = self.ranges[j]
            if s <= t < e:
                return name
        return "outside any range"


def profile(fn):
    """Run ``fn()`` under the profiler (host and device); returns
    ``(fn's result, Trace)``. The chrome trace goes to a temporary file
    in ``TMPDIR`` and is deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return out, Trace.from_chrome(data)


@dataclasses.dataclass
class Context:
    """What a reader reads: the cell, the card's kind, the trace, this
    card's rank, the traced calls' counts (``stats``: ``sent``,
    ``received``, ``flow`` host arrays, steps stacked) and ``cards``, the
    ``(busy, window)`` microseconds of :meth:`Trace.busy_us` on every card
    of the run, in rank order."""

    cell: object
    kind: str
    trace: Trace
    rank: int
    stats: dict
    cards: list = dataclasses.field(default_factory=list)


def load_metrics() -> list:
    """Every reader in ``metrics/``, in file order."""
    from benchmark.spec import check_name, check_unit

    out = []
    for path in sorted(METRICS_DIR.glob("*.py")):
        if path.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            f"benchmark.metrics.{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        check_name(mod.NAME, f"{path.name}: NAME")
        check_unit(mod.UNIT)
        out.append(mod)
    return out


def read_all(ctx: Context) -> dict:
    """``{name: {"value", "unit"}}`` of every reader that found something,
    each named with the cell's ``metric_suffix``."""
    out = {}
    for mod in load_metrics():
        v = mod.read(ctx)
        if v is not None:
            out[mod.NAME + ctx.cell.metric_suffix] = {"value": float(v),
                                                      "unit": mod.UNIT}
    return out
