"""Metrics plane: Counter/Gauge/Histogram registry + OpenMetrics text (the
port's copy of the JAX package's ``telemetry/metrics.py``, the same
families, names and rendering).

The journal (:mod:`.recorder`) is the source of truth for what happened;
this module is its scrapable projection. Two ways to populate a
:class:`MetricsRegistry`:

* direct instrumentation: ``reg.counter(...)`` / ``.gauge(...)`` /
  ``.histogram(...)`` hand out families; children are addressed by
  label values and mutated with ``inc``/``set``/``observe``;
* journal replay: :func:`from_journal` folds a ``StepRecorder`` (or an
  exported JSONL event stream) into the standard grid metric families.
  ``grid_journal_events_total`` is built from the recorder's *all-time*
  counts, so scrape totals are exact even after ring eviction.

:func:`render_openmetrics` emits the OpenMetrics text exposition format
(``# TYPE``/``# HELP`` metadata, ``_total`` counter samples, cumulative
``_bucket{le=...}`` histograms, terminating ``# EOF``).

Everything here is host code and imports neither torch nor numpy: a
scrape never touches the device.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# OpenMetrics reserves the _total/_bucket/_sum/_count suffixes for the
# renderer to append; family base names must not collide with them.
_RESERVED_SUFFIXES = ("_total", "_bucket", "_sum", "_count", "_created")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric/label name: {name!r}")
    for suf in _RESERVED_SUFFIXES:
        if name.endswith(suf):
            raise ValueError(
                f"metric name {name!r} ends with reserved suffix {suf!r}"
                " (the OpenMetrics renderer appends it)"
            )
    return name


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _format_value(v) -> str:
    """Shortest round-trip text for a sample value (repr for floats —
    exact; plain int for integral counters)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def pow2_edges(lo: int, hi: int) -> Tuple[float, ...]:
    """Histogram bucket edges at powers of two: ``2**lo .. 2**hi``
    inclusive. The grid's quantities span decades (step times from µs
    spin-ups to multi-second stalls, mover counts from 1 to millions);
    pow2 buckets give constant relative resolution with a handful of
    buckets and exactly representable edges."""
    if hi < lo:
        raise ValueError(f"pow2_edges: hi {hi} < lo {lo}")
    return tuple(float(2.0 ** e) for e in range(int(lo), int(hi) + 1))


class _Child:
    __slots__ = ("_labels",)

    def __init__(self, labels: Tuple[str, ...]):
        self._labels = labels


class Counter(_Child):
    """Monotone non-negative count. ``inc`` by a non-negative amount."""

    __slots__ = ("_value",)

    def __init__(self, labels: Tuple[str, ...]):
        super().__init__(labels)
        self._value = 0

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter decrease: {amount}")
        self._value += amount

    @property
    def value(self):
        return self._value


class Gauge(_Child):
    """Point-in-time value; may go up or down."""

    __slots__ = ("_value",)

    def __init__(self, labels: Tuple[str, ...]):
        super().__init__(labels)
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = value

    def inc(self, amount: float = 1) -> None:
        self._value += amount

    def dec(self, amount: float = 1) -> None:
        self._value -= amount

    @property
    def value(self):
        return self._value


class Histogram(_Child):
    """Distribution over fixed edges; per-bucket counts are stored
    non-cumulative and rendered cumulative (OpenMetrics ``le`` buckets
    include an implicit ``+Inf``)."""

    __slots__ = ("_edges", "_bucket_counts", "_sum", "_count")

    def __init__(self, labels: Tuple[str, ...], edges: Sequence[float]):
        super().__init__(labels)
        self._edges = tuple(float(e) for e in edges)
        # one slot per finite edge plus the +Inf overflow slot
        self._bucket_counts = [0] * (len(self._edges) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self._sum += v
        self._count += 1
        for i, edge in enumerate(self._edges):
            if v <= edge:
                self._bucket_counts[i] += 1
                return
        self._bucket_counts[-1] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """``(le, cumulative_count)`` pairs, ending with ``(+Inf, count)``."""
        out, acc = [], 0
        for edge, n in zip(self._edges, self._bucket_counts):
            acc += n
            out.append((edge, acc))
        out.append((math.inf, self._count))
        return out

    def quantile(self, q: float) -> float:
        """Bucketed upper-bound ``q``-quantile: the smallest edge whose
        cumulative count covers ``ceil(q * count)`` observations.

        This is the estimate a Prometheus ``histogram_quantile`` over
        the rendered buckets would bound, so an SLO rule computed here
        (health.py ``slo_latency_p99``) agrees with what an operator
        sees on ``/metrics``. Returns ``+Inf`` when the quantile lands
        in the overflow bucket and ``0.0`` on an empty histogram.
        """
        if not 0.0 < q <= 1.0:
            raise ValueError(f"quantile q must be in (0, 1], got {q}")
        if self._count == 0:
            return 0.0
        target = max(1, math.ceil(q * self._count))
        acc = 0
        for edge, n in zip(self._edges, self._bucket_counts):
            acc += n
            if acc >= target:
                return edge
        return math.inf


_CHILD_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric family: a type, help text, a fixed label-name
    tuple, and one child per distinct label-value tuple."""

    def __init__(
        self,
        name: str,
        mtype: str,
        help: str,
        labelnames: Sequence[str] = (),
        edges: Optional[Sequence[float]] = None,
    ):
        if mtype not in _CHILD_TYPES:
            raise ValueError(f"unknown metric type: {mtype!r}")
        self.name = _check_name(name)
        self.mtype = mtype
        self.help = str(help)
        self.labelnames = tuple(_check_name(ln) for ln in labelnames)
        if mtype == "histogram":
            if not edges:
                raise ValueError(f"histogram {name!r} needs bucket edges")
            es = [float(e) for e in edges]
            if any(b <= a for a, b in zip(es, es[1:])):
                raise ValueError(
                    f"histogram {name!r} edges must strictly increase"
                )
            self.edges: Optional[Tuple[float, ...]] = tuple(es)
        else:
            if edges is not None:
                raise ValueError(f"{mtype} {name!r} takes no edges")
            self.edges = None
        self._children: Dict[Tuple[str, ...], _Child] = {}

    def labels(self, **kv) -> _Child:
        """The child for these label values (created on first use)."""
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(kv)}, "
                f"declared {sorted(self.labelnames)}"
            )
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        child = self._children.get(key)
        if child is None:
            if self.mtype == "histogram":
                child = Histogram(key, self.edges)
            else:
                child = _CHILD_TYPES[self.mtype](key)
            self._children[key] = child
        return child

    def children(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        return list(self._children.items())

    def _label_str(self, values: Tuple[str, ...], extra: str = "") -> str:
        parts = [
            f'{ln}="{_escape_label(v)}"'
            for ln, v in zip(self.labelnames, values)
        ]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    """An ordered set of metric families with one rendering.

    Family accessors are idempotent: re-declaring an existing name with
    the same type/labels returns the existing family (so journal replay
    and direct instrumentation can share a registry); re-declaring with
    a different shape raises.
    """

    def __init__(self):
        self._families: Dict[str, Family] = {}

    def _family(self, name, mtype, help, labelnames, edges=None) -> Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.mtype != mtype or fam.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-declared with different "
                    f"type/labels ({fam.mtype}{fam.labelnames} vs "
                    f"{mtype}{tuple(labelnames)})"
                )
            if mtype == "histogram" and fam.edges != tuple(
                float(e) for e in edges
            ):
                raise ValueError(
                    f"histogram {name!r} re-declared with different edges"
                )
            return fam
        fam = Family(name, mtype, help, labelnames, edges)
        self._families[name] = fam
        return fam

    def counter(self, name, help, labelnames=()) -> Family:
        return self._family(name, "counter", help, labelnames)

    def gauge(self, name, help, labelnames=()) -> Family:
        return self._family(name, "gauge", help, labelnames)

    def histogram(self, name, help, labelnames=(), edges=()) -> Family:
        return self._family(name, "histogram", help, labelnames, edges)

    def families(self) -> List[Family]:
        return list(self._families.values())

    def get(self, name: str) -> Optional[Family]:
        return self._families.get(name)

    def render_openmetrics(self) -> str:
        return render_openmetrics(self)

    @classmethod
    def from_journal(cls, source, **kw) -> "MetricsRegistry":
        return from_journal(source, registry=cls(), **kw)


def render_openmetrics(registry: MetricsRegistry) -> str:
    """OpenMetrics text exposition of every family in the registry.

    Counters render as ``<name>_total``; histograms as cumulative
    ``<name>_bucket{le="..."}`` plus ``_sum``/``_count`` with a final
    ``le="+Inf"`` bucket equal to ``_count``; the document terminates
    with ``# EOF``. Label values are escaped per the spec
    (backslash, quote, newline)."""
    lines: List[str] = []
    for fam in registry.families():
        lines.append(f"# TYPE {fam.name} {fam.mtype}")
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape_label(fam.help)}")
        for values, child in fam.children():
            if fam.mtype == "counter":
                lines.append(
                    f"{fam.name}_total{fam._label_str(values)}"
                    f" {_format_value(child.value)}"
                )
            elif fam.mtype == "gauge":
                lines.append(
                    f"{fam.name}{fam._label_str(values)}"
                    f" {_format_value(child.value)}"
                )
            else:
                for le, acc in child.cumulative():
                    le_txt = "+Inf" if math.isinf(le) else _format_value(le)
                    label_str = fam._label_str(
                        values, 'le="%s"' % le_txt
                    )
                    lines.append(f"{fam.name}_bucket{label_str} {acc}")
                lines.append(
                    f"{fam.name}_sum{fam._label_str(values)}"
                    f" {_format_value(child.sum)}"
                )
                lines.append(
                    f"{fam.name}_count{fam._label_str(values)}"
                    f" {child.count}"
                )
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Journal replay: fold recorded events into the standard grid families.

# step times: 2^-14 s (~61 µs) .. 2^4 s (16 s)
STEP_TIME_EDGES = pow2_edges(-14, 4)
# mover counts: 1 .. 2^24 (~16.7M rows/step)
MOVERS_EDGES = pow2_edges(0, 24)
# dropped rows per step: an explicit 0 bucket (loss-free steps must be
# distinguishable from <=1-row loss, and the p99-of-zeros must be 0 for
# the threshold=0 SLO), then 1 .. 2^24 (same span as movers)
DROPPED_EDGES = (0.0,) + pow2_edges(0, 24)


def _iter_events(source) -> Tuple[Iterable[tuple], Optional[Dict[str, int]]]:
    """Normalize a journal source to ``(events, all_time_counts)``.

    ``events`` yields ``(kind, data)`` pairs; ``all_time_counts`` is the
    exact per-kind total when the source knows it (a ``StepRecorder`` or
    a merged journal), else None (counted from the stream)."""
    counts = None
    if hasattr(source, "events") and hasattr(source, "counts"):
        # a StepRecorder, or a merged journal of the same shape
        counts = dict(source.counts())
        events = []
        for e in source.events():
            if hasattr(e, "kind"):
                events.append((e.kind, dict(e.data)))
            else:  # merged journal dict rows
                d = dict(e)
                kind = d.pop("kind")
                for env in ("seq", "time", "host", "pid", "t_aligned"):
                    d.pop(env, None)
                events.append((kind, d))
        return events, counts
    # iterable of JSONL-decoded dicts
    events = []
    for row in source:
        d = dict(row)
        kind = d.pop("kind")
        for env in ("seq", "time", "host", "pid", "t_aligned"):
            d.pop(env, None)
        events.append((kind, d))
    return events, None


def from_journal(
    source,
    registry: Optional[MetricsRegistry] = None,
    prefix: str = "grid",
) -> MetricsRegistry:
    """Fold a journal into the standard grid metric families.

    ``source`` is a ``StepRecorder``, a merged journal, or
    any iterable of JSONL-decoded event dicts. When the source carries
    all-time counts, ``<prefix>_journal_events_total`` uses them — exact
    even after ring eviction — and ``<prefix>_journal_evicted_events``
    reports how many retained-window-only samples the other families are
    missing.

    Families (documented in SCHEMA.md "Metric families"):

    * ``journal_events_total{kind}`` — all-time events per kind;
    * ``migrate_rows_total{direction}`` — sent/received/backlog/
      dropped_recv row totals over the journaled ``migrate_step`` window;
    * ``population_rows`` / ``backlog_rows`` — latest step gauges;
    * ``step_time_seconds`` — pow2 histogram of ``step_time`` samples;
    * ``fast_path_steps_total{taken}`` + ``movers_per_step`` histogram;
    * ``capacity_rows{which}`` — latest ratcheted capacity per budget;
    * ``exchange_wire_bytes_total{engine}`` — scheduled canonical-
      exchange wire bytes per engine over the journaled
      ``redistribute`` window;
    * ``alerts_total{rule,severity}`` — health findings journaled;
    * ``flow_moved_rows`` / ``flow_imbalance`` /
      ``rank_population{vrank}`` — latest flow snapshot;
    * ``step_latency_seconds`` / ``dropped_rows`` — pow2 histograms of
      the service driver's ``step_latency`` events (the SLO surface);
    * ``snapshot_corrupt_total`` — corrupt snapshots skipped at restore;
    * ``roofline_achieved_fraction{program,phase}`` — latest analytic
      predicted/measured fraction per ``roofline`` event;
    * ``profile_sessions_total`` — ``profile_session`` events (profiler
      captures attempted);
    * ``state_nan_total{field}`` / ``state_oob_total`` — corrupt-row
      totals over the journaled ``state_health`` window;
    * ``state_live_rows`` / ``state_residual`` — latest conservation-
      ledger gauges (a nonzero residual is row loss/creation the
      exchange never accounted).
    """
    reg = registry if registry is not None else MetricsRegistry()
    events, counts = _iter_events(source)
    p = prefix

    ev_total = reg.counter(
        f"{p}_journal_events",
        "All-time journal events per kind (survives ring eviction)",
        ("kind",),
    )
    if counts is None:
        counts = {}
        for kind, _ in events:
            counts[kind] = counts.get(kind, 0) + 1
    for kind in sorted(counts):
        ev_total.labels(kind=kind).inc(counts[kind])
    evicted = reg.gauge(
        f"{p}_journal_evicted_events",
        "Events recorded but no longer retained (ring wrapped); the"
        " non-counter families below cover the retained window only",
    )
    total_events = sum(counts.values())
    evicted.labels().set(max(0, total_events - len(events)))

    rows = reg.counter(
        f"{p}_migrate_rows",
        "Rows by direction over the journaled migrate_step window",
        ("direction",),
    )
    pop_g = reg.gauge(
        f"{p}_population_rows", "Total resident rows at the latest step"
    )
    back_g = reg.gauge(
        f"{p}_backlog_rows", "Deferred (capacity-limited) rows, latest step"
    )
    st_h = reg.histogram(
        f"{p}_step_time_seconds",
        "Measured wall step times (pow2 buckets)",
        edges=STEP_TIME_EDGES,
    )
    lat_h = reg.histogram(
        f"{p}_step_latency_seconds",
        "Service-driver end-to-end step latency (step_latency events,"
        " pow2 buckets) — the SLO surface the restart policy actuates on",
        edges=STEP_TIME_EDGES,
    )
    drop_h = reg.histogram(
        f"{p}_dropped_rows",
        "Rows dropped per service step (step_latency events, pow2"
        " buckets); any nonzero sample is row loss",
        edges=DROPPED_EDGES,
    )
    corrupt_c = reg.counter(
        f"{p}_snapshot_corrupt",
        "Corrupt snapshots skipped over during restores (restore"
        " events' snapshots_skipped)",
    )
    fp_total = reg.counter(
        f"{p}_fast_path_steps",
        "Sparse-engine routing outcomes (taken=1 sparse, 0 dense fallback)",
        ("taken",),
    )
    mov_h = reg.histogram(
        f"{p}_movers_per_step",
        "Movers per step (sent + backlog) on sparse-capable loops",
        edges=MOVERS_EDGES,
    )
    cap_g = reg.gauge(
        f"{p}_capacity_rows",
        "Latest ratcheted capacity per budget (capacity_grow /"
        " mover_cap_grow events)",
        ("which",),
    )
    wire = reg.counter(
        f"{p}_exchange_wire_bytes",
        "Scheduled canonical-exchange wire bytes by resolved engine"
        " (redistribute events; pool width x row bytes x shards)",
        ("engine",),
    )
    alerts = reg.counter(
        f"{p}_alerts",
        "Health-rule findings journaled as alert events",
        ("rule", "severity"),
    )
    flow_moved = reg.gauge(
        f"{p}_flow_moved_rows",
        "Cumulative off-diagonal rows moved (latest flow_snapshot)",
    )
    flow_imb = reg.gauge(
        f"{p}_flow_imbalance",
        "Max/mean population imbalance (latest flow_snapshot; 1.0 ="
        " balanced)",
    )
    flow_pop = reg.gauge(
        f"{p}_rank_population",
        "Live rows per vrank (latest flow_snapshot population leaf)",
        ("vrank",),
    )
    roofline_g = reg.gauge(
        f"{p}_roofline_achieved_fraction",
        "Analytic-roofline predicted/measured step-time fraction per"
        " program (latest roofline event; 1.0 = at the roof)",
        ("program", "phase"),
    )
    profile_c = reg.counter(
        f"{p}_profile_sessions",
        "Profiler trace sessions attempted (profile_session events;"
        " armed or degraded alike)",
    )
    state_nan = reg.counter(
        f"{p}_state_nan",
        "Live rows with non-finite components over the journaled"
        " state_health window, per field (any nonzero is corruption)",
        ("field",),
    )
    state_oob = reg.counter(
        f"{p}_state_oob",
        "Live rows with positions outside the probe's domain box over"
        " the journaled state_health window",
    )
    state_live = reg.gauge(
        f"{p}_state_live_rows",
        "Total live particle rows at the latest probed step"
        " (state_health events)",
    )
    state_res = reg.gauge(
        f"{p}_state_residual",
        "Exact conservation residual (live + dropped - initial) at the"
        " latest probed step; nonzero = unaccounted row loss/creation",
    )

    saw_migrate = saw_flow = saw_roofline = saw_state = False
    for kind, data in events:
        if kind == "migrate_step":
            saw_migrate = True
            for d in ("sent", "received", "backlog", "dropped_recv"):
                if d in data:
                    rows.labels(direction=d).inc(int(data[d]))
            if "population" in data:
                pop_g.labels().set(int(data["population"]))
            if "backlog" in data:
                back_g.labels().set(int(data["backlog"]))
        elif kind == "step_time":
            if "seconds" in data:
                st_h.labels().observe(float(data["seconds"]))
        elif kind == "step_latency":
            if "seconds" in data:
                lat_h.labels().observe(float(data["seconds"]))
            drop_h.labels().observe(int(data.get("dropped", 0)))
        elif kind == "restore":
            corrupt_c.labels().inc(int(data.get("snapshots_skipped", 0) or 0))
        elif kind == "fast_path":
            fp_total.labels(taken=int(data.get("taken", 0))).inc()
            if "movers" in data:
                mov_h.labels().observe(int(data["movers"]))
        elif kind == "capacity_grow":
            if "which" in data and "new" in data:
                cap_g.labels(which=data["which"]).set(int(data["new"]))
        elif kind == "mover_cap_grow":
            if "new" in data:
                cap_g.labels(which="mover").set(int(data["new"]))
        elif kind == "redistribute":
            if "wire_bytes" in data:
                wire.labels(
                    engine=data.get("engine", "unknown")
                ).inc(int(data["wire_bytes"]))
        elif kind == "alert":
            alerts.labels(
                rule=data.get("rule", "unknown"),
                severity=data.get("severity", "unknown"),
            ).inc()
        elif kind == "flow_snapshot":
            saw_flow = True
            if "moved_rows_total" in data:
                flow_moved.labels().set(int(data["moved_rows_total"]))
            if "imbalance" in data:
                flow_imb.labels().set(float(data["imbalance"]))
            if data.get("population") is not None:
                # latest snapshot wins outright: drop stale vrank
                # children first so a shrunk rank count can't leave
                # ghost gauges behind
                flow_pop._children.clear()
                for vr, rows_live in enumerate(data["population"]):
                    flow_pop.labels(vrank=vr).set(int(rows_live))
        elif kind == "roofline":
            if data.get("achieved_fraction") is not None:
                saw_roofline = True
                roofline_g.labels(
                    program=data.get("program", "unknown"),
                    phase=data.get("phase", "total"),
                ).set(float(data["achieved_fraction"]))
        elif kind == "profile_session":
            profile_c.labels().inc()
        elif kind == "state_health":
            saw_state = True
            state_nan.labels(field="pos").inc(int(data.get("nan_pos", 0)))
            state_nan.labels(field="vel").inc(int(data.get("nan_vel", 0)))
            state_oob.labels().inc(int(data.get("oob", 0)))
            if "live" in data:
                state_live.labels().set(int(data["live"]))
            if "residual" in data:
                state_res.labels().set(int(data["residual"]))
        elif kind == "store_window":
            # compacted state_health windows keep feeding the corrupt-
            # row totals after the raw per-step rows are gone
            st = data.get("state")
            if st:
                saw_state = True
                state_nan.labels(field="pos").inc(int(st.get("nan_pos", 0)))
                state_nan.labels(field="vel").inc(int(st.get("nan_vel", 0)))
                state_oob.labels().inc(int(st.get("oob", 0)))
                if st.get("live_last") is not None:
                    state_live.labels().set(int(st["live_last"]))
                if st.get("residual_last") is not None:
                    state_res.labels().set(int(st["residual_last"]))
    # gauges with no samples yet would render a misleading 0 — only
    # materialize the step-scoped gauges once their kind has appeared
    if not saw_migrate:
        for fam in (pop_g, back_g):
            fam._children.clear()
    if not saw_flow:
        for fam in (flow_moved, flow_imb, flow_pop):
            fam._children.clear()
    if not saw_roofline:
        roofline_g._children.clear()
    if not saw_state:
        for fam in (state_live, state_res):
            fam._children.clear()
    return reg
