"""Phase attribution by cumulative truncation, and profiler spans (the
port's copy of the JAX package's ``telemetry/phases.py``).

:func:`attribute_phases` times the step truncated after each phase with
the length-differenced protocol of
:func:`..utils.profiling.time_per_step_samples` (CUDA events on the
card), and reads each phase's cost off the deltas, optionally against a
logical-bytes roofline; :func:`format_phase_table` prints the table.

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

import contextlib
from typing import Callable, List, NamedTuple, Optional, Sequence

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
    """One row of an attribution run. ``cumulative_s`` is the truncated
    step's per-step time; ``delta_s`` the increment over the previous
    phase (the phase's attributed cost); roofline fields are populated
    when logical bytes were supplied; ``spread_s`` is how far the
    reading may be off: the range of the per-step samples
    ``cumulative_s`` is the least of, plus the range of the short runs
    they are differenced against, per step."""

    phase: object
    cumulative_s: float
    delta_s: float
    logical_bytes: Optional[int] = None
    roofline_s: Optional[float] = None
    spread_s: Optional[float] = None

    @property
    def x_roofline(self) -> Optional[float]:
        """measured delta / roofline time; >>1 flags latency/serialization
        bound (scatters, sorts), not a bandwidth wall."""
        if not self.roofline_s or self.roofline_s <= 0:
            return None
        return self.delta_s / self.roofline_s


def attribute_phases(
    loop_builder: Callable[[object, int], Callable],
    args,
    phases: Sequence,
    *,
    s1: int = 4,
    s2: int = 16,
    reps: int = 2,
    phase_bytes: Optional[dict] = None,
    peak_bytes_per_sec: float = profiling.HBM_PEAK_BYTES_PER_SEC,
    progress: Optional[Callable[[PhaseTiming], None]] = None,
    device="cuda",
) -> List[PhaseTiming]:
    """Attribute a step's time to its phases by cumulative truncation.

    Args:
      loop_builder: ``loop_builder(phase, S)`` returns a callable running
        ``S`` steps of the pipeline truncated after ``phase`` (phases are
        caller-defined tokens); each truncation must keep its last
        phase's output alive so the work is not skipped.
      args: loop inputs, passed to the built loops.
      phases: ordered phase tokens; ``phases[i]``'s cost is
        ``cumulative[i] - cumulative[i-1]`` (the first row's delta is
        its cumulative time).
      s1/s2/reps: the differencing protocol's knobs
        (:func:`..utils.profiling.time_per_step_samples`).
      phase_bytes: optional ``{phase: logical_bytes}``, the least traffic
        each phase's math implies; fills the roofline columns.
      peak_bytes_per_sec: the roofline's denominator (the H100's HBM3
        by default).
      progress: optional callback with each finished row.
      device: where the loops run (CUDA events on the card, the host's
        clock on the CPU).

    Returns one :class:`PhaseTiming` per phase, in order.
    """
    out: List[PhaseTiming] = []
    prev = None
    for phase in phases:
        # a cut step can cost less than the noise (a toy size on the
        # CPU): its readings are kept as they are, and the table marks a
        # delta that does not add up
        detail, _last = profiling.time_per_step_samples(
            lambda S, phase=phase: (
                lambda fn=loop_builder(phase, S): fn(*args)),
            s1=s1, s2=s2, reps=reps, device=device, require_positive=False,
        )
        del _last  # large outputs must not pile up across phases
        per_step = detail["min"]
        delta = per_step if prev is None else per_step - prev
        lb = None if phase_bytes is None else phase_bytes.get(phase)
        roof = None if lb is None else lb / peak_bytes_per_sec
        row = PhaseTiming(phase, per_step, delta, lb, roof,
                          detail["max"] - detail["min"]
                          + detail["base_spread"])
        out.append(row)
        if progress is not None:
            progress(row)
        prev = per_step
    return out


def format_phase_table(timings: Sequence[PhaseTiming]) -> str:
    """Markdown phase table (the BENCH_CONFIGS.md format): cumulative
    ms, delta ms, logical MB, roofline ms, x-roofline."""
    lines = [
        "| phase (cumulative) | ms | delta | logical MB | roofline ms "
        "| x-roofline |",
        "|---|---|---|---|---|---|",
    ]
    for i, t in enumerate(timings):
        mb = "—" if t.logical_bytes is None else f"{t.logical_bytes/1e6:8.1f}"
        roof = "—" if t.roofline_s is None else f"{t.roofline_s*1e3:6.2f}"
        xr = t.x_roofline
        xcol = "—" if xr is None else f"{xr:6.1f}"
        delta = "(first)" if i == 0 else f"{t.delta_s*1e3:+7.2f}"
        lines.append(
            f"| {t.phase} | {t.cumulative_s*1e3:7.2f} | {delta} | {mb} "
            f"| {roof} | {xcol} |"
        )
    return "\n".join(lines)
