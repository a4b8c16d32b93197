"""Always-on health monitor: declarative rules over the telemetry journal
(the port's copy of the JAX package's ``telemetry/health.py``: the same
rules, in the same order, with the same severities and reasons).

:class:`HealthMonitor` evaluates a small set of rules on demand
(``rd.health()``, bench boundaries); each finding fires the registered
callbacks AND records an ``alert`` event into the same ring, so alerts
appear in the JSONL export and the Perfetto timeline next to the events
that caused them. Evaluation is host-side dict scans only: the monitor
never touches the device.

The stock rules (:func:`default_rules`):

* ``backlog_growth``: total backlog strictly increasing over the last
  ``window`` ``migrate_step`` events. ALERT.
* ``dropped_rows``: any ``migrate_step`` with ``dropped_recv > 0``, or
  any ``overflow_window_loss`` ever (all-time counts). ALERT.
* ``capacity_grow_frequency``: more than ``max_grows`` capacity/halo
  grows in the retained window. WARN.
* ``imbalance_ratio``: the latest ``flow_snapshot``'s max/mean
  population above ``threshold``. WARN.
* ``step_time_spike``: the latest ``step_time`` above ``factor`` x the
  EMA of the preceding ones (:meth:`HealthMonitor.note_step_time`). WARN.
* ``fast_path_fallback``: the sparse migrate engine fell back to the
  dense path on more than ``threshold`` of the last ``window``
  ``fast_path`` events. WARN.
* ``snapshot_staleness``: wall time since the last ``snapshot`` event
  over ``factor`` x its recorded cadence. WARN.
* ``nan_detected`` / ``conservation_drift`` / ``bounds_violation``: a
  fresh ``state_health`` event with NaN/Inf rows, a nonzero conservation
  residual, or rows out of the domain box. ALERT.

Opt-in SLO rules: ``slo_latency_p99``, ``slo_dropped_rows`` and the
multi-window burn-rate rules ``burn_rate_latency`` /
``burn_rate_dropped`` over ``step_latency`` events (pow2 histograms of
:mod:`.metrics`). ALERT.

Callbacks (``add_callback`` / ``on_alert=``) are isolated: one that
raises is journaled as a ``callback_error`` event and evaluation goes
on.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

from mpi_grid_redistribute_tpu_torch.telemetry import metrics as metrics_lib
from mpi_grid_redistribute_tpu_torch.telemetry.recorder import StepRecorder

OK = "OK"
WARN = "WARN"
ALERT = "ALERT"
_SEVERITY_ORDER = {OK: 0, WARN: 1, ALERT: 2}

# Event kinds the observability plane itself emits while reacting to
# findings. Excluded from the alert-dedup clock in
# :meth:`HealthMonitor.evaluate` so reacting to an alert is never "new
# evidence" that re-fires the same alert.
_META_KINDS = ("alert", "callback_error", "incident")


class HealthRule(NamedTuple):
    """One declarative rule: ``fn(recorder)`` returns a human reason
    string when the rule fires, ``None`` when healthy. ``severity`` is
    :data:`WARN` or :data:`ALERT`."""

    name: str
    severity: str
    fn: Callable[[StepRecorder], Optional[str]]


class Finding(NamedTuple):
    """One fired rule from a :meth:`HealthMonitor.evaluate` pass."""

    rule: str
    severity: str
    reason: str


def backlog_growth(window: int = 4) -> HealthRule:
    """ALERT when total backlog grows strictly monotonically over the
    last ``window`` ``migrate_step`` events (and ends nonzero)."""
    if window < 2:
        raise ValueError(f"window must be >= 2, got {window}")

    def fn(rec: StepRecorder) -> Optional[str]:
        ev = rec.events("migrate_step")[-window:]
        if len(ev) < window:
            return None
        backlog = [int(e.data.get("backlog", 0)) for e in ev]
        growing = all(b > a for a, b in zip(backlog, backlog[1:]))
        if growing and backlog[-1] > 0:
            return (
                f"backlog grew monotonically over the last {window} "
                f"steps: {backlog[0]} -> {backlog[-1]}"
            )
        return None

    return HealthRule("backlog_growth", ALERT, fn)


def dropped_rows() -> HealthRule:
    """ALERT on any surfaced row loss: a ``migrate_step`` event with
    ``dropped_recv > 0``, or any all-time ``overflow_window_loss``."""

    def fn(rec: StepRecorder) -> Optional[str]:
        losses = rec.counts().get("overflow_window_loss", 0)
        if losses:
            return f"{losses} overflow window(s) resolved with loss"
        for e in rec.events("migrate_step"):
            d = int(e.data.get("dropped_recv", 0))
            if d > 0:
                return f"dropped_recv={d} at step {e.data.get('step')}"
        return None

    return HealthRule("dropped_rows", ALERT, fn)


def capacity_grow_frequency(max_grows: int = 3) -> HealthRule:
    """WARN when more than ``max_grows`` capacity/halo grow events are
    retained in the ring — capacities are thrashing, not converging."""

    def fn(rec: StepRecorder) -> Optional[str]:
        grows = len(rec.events("capacity_grow")) + len(
            rec.events("halo_grow")
        )
        if grows > max_grows:
            return (
                f"{grows} capacity grows in the retained window "
                f"(> {max_grows}): workload outruns the size estimate"
            )
        return None

    return HealthRule("capacity_grow_frequency", WARN, fn)


def imbalance_ratio(
    threshold: float = 2.0, severity: str = WARN
) -> HealthRule:
    """Fire when the latest ``flow_snapshot`` population imbalance
    (max/mean) exceeds ``threshold``. WARN by default (advisory for an
    operator); the service driver's adaptive-rebalance loop installs an
    ALERT-severity copy at its actuation threshold, since for it the
    finding is a trigger, not a notice."""
    if severity not in (WARN, ALERT):
        raise ValueError(f"severity must be WARN or ALERT, got {severity!r}")

    def fn(rec: StepRecorder) -> Optional[str]:
        e = rec.last("flow_snapshot")
        if e is None:
            return None
        imb = float(e.data.get("imbalance", 0.0))
        if imb > threshold:
            return (
                f"population imbalance {imb:.2f}x (max/mean) exceeds "
                f"{threshold:.2f}x"
            )
        return None

    return HealthRule("imbalance_ratio", severity, fn)


def step_time_spike(factor: float = 3.0, min_samples: int = 4) -> HealthRule:
    """WARN when the newest ``step_time`` event exceeds ``factor`` x the
    EMA of the preceding ones (recompile, contention, thermal event)."""

    def fn(rec: StepRecorder) -> Optional[str]:
        ev = rec.events("step_time")
        if len(ev) < min_samples:
            return None
        times = [float(e.data.get("seconds", 0.0)) for e in ev]
        ema = times[0]
        for t in times[1:-1]:
            ema = 0.2 * t + 0.8 * ema
        if ema > 0 and times[-1] > factor * ema:
            return (
                f"step time {times[-1] * 1e3:.2f} ms is "
                f"{times[-1] / ema:.1f}x the {ema * 1e3:.2f} ms EMA"
            )
        return None

    return HealthRule("step_time_spike", WARN, fn)


def fast_path_fallback(
    window: int = 16, threshold: float = 0.5
) -> HealthRule:
    """WARN when more than ``threshold`` of the last ``window``
    ``fast_path`` events took the dense fallback — the sparse engine is
    compiled in but mostly not running (undersized ``mover_cap`` or a
    workload that is not mover-sparse), so steps pay the routing guard
    on top of the full dense cost. Needs a full window of events before
    it can fire (a cold journal is not evidence)."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")

    def fn(rec: StepRecorder) -> Optional[str]:
        ev = rec.events("fast_path")[-window:]
        if len(ev) < window:
            return None
        fallbacks = sum(1 - int(e.data.get("taken", 0)) for e in ev)
        rate = fallbacks / len(ev)
        if rate > threshold:
            return (
                f"sparse fast path fell back on {fallbacks}/{len(ev)} of "
                f"the last steps ({rate:.0%} > {threshold:.0%}): grow "
                f"mover_cap or run engine='planar'"
            )
        return None

    return HealthRule("fast_path_fallback", WARN, fn)


def snapshot_staleness(factor: float = 2.0) -> HealthRule:
    """WARN when the wall time since the last ``snapshot`` event exceeds
    ``factor`` x the cadence that event recorded (``cadence_s``, the
    service driver's ``snapshot_every`` x step-time EMA). A stale
    snapshot means the checkpoint writer is stalled or dead: the state
    at risk on a crash keeps growing past what the restart policy
    budgets for. Quiet until a snapshot with a known cadence exists —
    a run with snapshots off is not evidence of staleness."""
    if factor <= 0:
        raise ValueError(f"factor must be > 0, got {factor}")

    def fn(rec: StepRecorder) -> Optional[str]:
        e = rec.last("snapshot")
        if e is None:
            return None
        cadence = float(e.data.get("cadence_s", 0.0))
        if cadence <= 0.0:
            return None  # cadence unknown (cold step-time EMA)
        age = time.time() - e.time
        if age > factor * cadence:
            return (
                f"last snapshot (step {e.data.get('step')}) is "
                f"{age:.1f}s old, > {factor:.1f}x the {cadence:.1f}s "
                f"cadence: checkpoint writer stalled or dead"
            )
        return None

    return HealthRule("snapshot_staleness", WARN, fn)


def _fresh_state_events(rec: StepRecorder):
    """``state_health`` events journaled AFTER the newest supervised
    state restore. A restore rolls the particle state back to a
    pre-corruption snapshot, so corruption evidence older than it
    describes state that no longer exists — without this cut a
    recovered service would page on its own history until the ring
    scrolled, and the supervisor's post-run ``healthz`` poll would turn
    one rolled-back NaN burst into a permanent crash loop."""
    ev = rec.events("state_health")
    if not ev:
        return ev
    restores = [
        e for e in rec.events("restore") if e.data.get("what") == "state"
    ]
    if not restores:
        return ev
    cut = restores[-1].seq
    return [e for e in ev if e.seq > cut]


def nan_detected() -> HealthRule:
    """ALERT on the first fresh ``state_health`` event whose NaN/Inf
    row count is nonzero (``nan_pos + nan_vel > 0``) — non-finite
    particle state is corruption the moment it exists, never load. The
    reason names the step, so the incident bundle's index pins exactly
    where the corruption entered. Quiet when probes are off (no
    ``state_health`` events is not evidence), and quiet about
    corruption an intervening state restore already rolled back
    (:func:`_fresh_state_events`)."""

    def fn(rec: StepRecorder) -> Optional[str]:
        for e in _fresh_state_events(rec):
            n_pos = int(e.data.get("nan_pos", 0))
            n_vel = int(e.data.get("nan_vel", 0))
            if n_pos or n_vel:
                return (
                    f"non-finite state at step {e.data.get('step')}: "
                    f"nan_pos={n_pos} nan_vel={n_vel} live rows corrupt"
                )
        return None

    return HealthRule("nan_detected", ALERT, fn)


def conservation_drift() -> HealthRule:
    """ALERT on the first retained ``state_health`` event whose exact
    int32 conservation residual (``live + dropped - initial``) is
    nonzero — rows appeared or vanished without being accounted by the
    exchange's own drop counters. Exact by construction: any nonzero
    value fires, there is no threshold to tune. Like the other state
    rules, only evidence newer than the latest state restore counts
    (:func:`_fresh_state_events`)."""

    def fn(rec: StepRecorder) -> Optional[str]:
        for e in _fresh_state_events(rec):
            r = int(e.data.get("residual", 0))
            if r != 0:
                return (
                    f"conservation residual {r:+d} rows at step "
                    f"{e.data.get('step')}: live + dropped != initial"
                )
        return None

    return HealthRule("conservation_drift", ALERT, fn)


def bounds_violation() -> HealthRule:
    """ALERT on the first retained ``state_health`` event with live
    rows outside the probe's domain box (``oob > 0``). The periodic
    drift wraps every position into [0, 1), so an out-of-bounds row
    means a broken integrator or wrap, not a fast particle. NaN rows
    are counted by ``nan_detected`` only (IEEE comparisons are false
    both ways), so the two rules partition the corrupt rows. Only
    evidence newer than the latest state restore counts
    (:func:`_fresh_state_events`)."""

    def fn(rec: StepRecorder) -> Optional[str]:
        for e in _fresh_state_events(rec):
            oob = int(e.data.get("oob", 0))
            if oob:
                return (
                    f"{oob} live rows out of the domain box at step "
                    f"{e.data.get('step')}"
                )
        return None

    return HealthRule("bounds_violation", ALERT, fn)


def slo_latency_p99(
    threshold_s: float, window: int = 16, q: float = 0.99
) -> HealthRule:
    """ALERT when the bucketed ``q``-quantile of the last ``window``
    ``step_latency`` events exceeds ``threshold_s``.

    The quantile is computed through the same pow2-bucket histogram the
    metrics plane scrapes (``grid_step_latency_seconds``), so the value
    that trips the restart policy is the value an operator sees on
    ``/metrics`` — not a slightly different exact-percentile. Needs a
    full window before it can fire (a cold journal is not a breach), so
    a post-restart driver gets ``window`` healthy steps to prove itself
    before old spikes scroll out."""
    if threshold_s <= 0:
        raise ValueError(f"threshold_s must be > 0, got {threshold_s}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    def fn(rec: StepRecorder) -> Optional[str]:
        ev = rec.events("step_latency")[-window:]
        if len(ev) < window:
            return None
        h = metrics_lib.Histogram((), metrics_lib.STEP_TIME_EDGES)
        for e in ev:
            h.observe(float(e.data.get("seconds", 0.0)))
        p = h.quantile(q)
        if p > threshold_s:
            return (
                f"step latency p{q * 100:g} over the last {window} steps"
                f" is {p:.3g}s (> {threshold_s:.3g}s SLO)"
            )
        return None

    return HealthRule("slo_latency_p99", ALERT, fn)


def slo_dropped_rows(
    threshold: int = 0, window: int = 16, q: float = 0.99
) -> HealthRule:
    """ALERT when the bucketed ``q``-quantile of rows dropped per step
    over the last ``window`` ``step_latency`` events exceeds
    ``threshold`` — the ``grid_dropped_rows`` histogram's SLO twin of
    :func:`slo_latency_p99` (default 0: any sustained loss breaches)."""
    if threshold < 0:
        raise ValueError(f"threshold must be >= 0, got {threshold}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    def fn(rec: StepRecorder) -> Optional[str]:
        ev = rec.events("step_latency")[-window:]
        if len(ev) < window:
            return None
        h = metrics_lib.Histogram((), metrics_lib.DROPPED_EDGES)
        for e in ev:
            h.observe(int(e.data.get("dropped", 0)))
        p = h.quantile(q)
        if p > threshold:
            return (
                f"dropped rows p{q * 100:g} over the last {window} steps"
                f" is {p:g} (> {threshold} SLO)"
            )
        return None

    return HealthRule("slo_dropped_rows", ALERT, fn)


def _over_budget(h, threshold: float) -> int:
    """Events in buckets strictly above the one containing ``threshold``.

    Bucketed like the quantile rules: an observation only counts as an
    SLO violation once it lands beyond the threshold's own bucket edge,
    so the burn rate trips on the same evidence an operator sees in the
    ``/metrics`` histogram — never on sub-bucket noise the exposition
    cannot show."""
    for le, cum in h.cumulative():
        if le >= threshold:
            return h.count - cum
    return 0  # unreachable: cumulative() ends with the +Inf bucket


def _burn_rate_rule(
    name: str,
    kind_key: str,
    edges,
    cast,
    threshold,
    unit: str,
    objective: float,
    fast_window: int,
    slow_window: int,
    fast_burn: float,
    slow_burn: float,
) -> HealthRule:
    # shared machinery behind burn_rate_latency / burn_rate_dropped
    if not 0.0 < objective < 1.0:
        raise ValueError(f"objective must be in (0, 1), got {objective}")
    if fast_window < 1:
        raise ValueError(f"fast_window must be >= 1, got {fast_window}")
    if slow_window <= fast_window:
        raise ValueError(
            f"slow_window must exceed fast_window "
            f"({slow_window} <= {fast_window})"
        )
    if fast_burn <= 0 or slow_burn <= 0:
        raise ValueError(
            f"burn factors must be > 0, got {fast_burn}/{slow_burn}"
        )
    budget = 1.0 - objective

    def fn(rec: StepRecorder) -> Optional[str]:
        ev = rec.events("step_latency")
        # fast window first: it pages at the higher factor, and when both
        # would fire the short window is the fresher evidence
        for label, win, factor in (
            ("fast", fast_window, fast_burn),
            ("slow", slow_window, slow_burn),
        ):
            tail = ev[-win:]
            if len(tail) < win:
                continue  # a cold journal is not a breach
            h = metrics_lib.Histogram((), edges)
            for e in tail:
                h.observe(cast(e.data.get(kind_key, 0)))
            bad = _over_budget(h, threshold)
            burn = (bad / win) / budget
            if burn >= factor:
                return (
                    f"error budget burning at {burn:.1f}x over the "
                    f"{label} window (>= {factor:g}x): {bad}/{win} steps "
                    f"beyond {threshold:g}{unit} against a {budget:.2%} "
                    f"budget (objective {objective:g})"
                )
        return None

    return HealthRule(name, ALERT, fn)


def burn_rate_latency(
    threshold_s: float,
    objective: float = 0.99,
    fast_window: int = 16,
    slow_window: int = 64,
    fast_burn: float = 8.0,
    slow_burn: float = 2.0,
) -> HealthRule:
    """ALERT when the step-latency error budget burns too fast.

    Multi-window burn-rate alerting (the SRE-standard upgrade of the
    point-in-time :func:`slo_latency_p99`): over each window the bad
    fraction is the share of ``step_latency`` events whose seconds land
    beyond ``threshold_s``'s pow2 bucket, and the burn rate is that
    fraction divided by the error budget ``1 - objective``. The *fast*
    window fires at ``fast_burn`` x budget (sudden total breach pages on
    minutes of evidence); the *slow* window fires at ``slow_burn`` x
    (sustained low-grade burn that would quietly exhaust the budget).
    Each window needs to be full before it can fire, and the journaled
    reason names the window and burn factor that tripped."""
    return _burn_rate_rule(
        "burn_rate_latency",
        "seconds",
        metrics_lib.STEP_TIME_EDGES,
        float,
        float(threshold_s),
        "s",
        objective,
        fast_window,
        slow_window,
        fast_burn,
        slow_burn,
    )


def burn_rate_dropped(
    threshold: int = 0,
    objective: float = 0.99,
    fast_window: int = 16,
    slow_window: int = 64,
    fast_burn: float = 8.0,
    slow_burn: float = 2.0,
) -> HealthRule:
    """ALERT when the dropped-rows error budget burns too fast — the
    ``grid_dropped_rows`` twin of :func:`burn_rate_latency` (default
    ``threshold=0``: any step that drops rows spends budget)."""
    if threshold < 0:
        raise ValueError(f"threshold must be >= 0, got {threshold}")
    return _burn_rate_rule(
        "burn_rate_dropped",
        "dropped",
        metrics_lib.DROPPED_EDGES,
        int,
        float(threshold),
        " rows",
        objective,
        fast_window,
        slow_window,
        fast_burn,
        slow_burn,
    )


def default_rules() -> List[HealthRule]:
    """The stock rule set, in evaluation order (the reference's, rule for
    rule: SCHEMA.md's "Health rule table")."""
    return [
        backlog_growth(),
        dropped_rows(),
        capacity_grow_frequency(),
        imbalance_ratio(),
        step_time_spike(),
        fast_path_fallback(),
        snapshot_staleness(),
        nan_detected(),
        conservation_drift(),
        bounds_violation(),
    ]


class HealthMonitor:
    """Evaluate declarative rules against a recorder's journal.

    ``monitor.evaluate()`` runs every rule, records one ``alert`` event
    per NEW finding into the same ring (deduplicated: the same
    (rule, reason) pair is not re-journaled until new events arrive),
    invokes the registered callbacks with each new :class:`Finding`, and
    returns ``{"status": OK|WARN|ALERT, "findings": [...]}`` — the dict
    behind ``GridRedistribute.health()``.
    """

    def __init__(
        self,
        recorder: StepRecorder,
        rules: Optional[Sequence[HealthRule]] = None,
        on_alert: Optional[Callable[[Finding], None]] = None,
    ):
        self.recorder = recorder
        self.rules = list(default_rules() if rules is None else rules)
        self.callbacks: List[Callable[[Finding], None]] = []
        if on_alert is not None:
            self.callbacks.append(on_alert)
        # (rule name) -> (reason, journal seq at fire time): dedup state
        self._seen: Dict[str, object] = {}

    def add_callback(self, cb: Callable[[Finding], None]) -> None:
        self.callbacks.append(cb)

    def note_step_time(self, seconds: float) -> None:
        """Journal one measured step time (feeds ``step_time_spike``)."""
        self.recorder.record("step_time", seconds=float(seconds))

    def evaluate(self, record: bool = True) -> Dict[str, object]:
        """Run every rule over the journal; returns the verdict dict.

        ``record=False`` is the scrape path (a ``/healthz`` poller):
        rules run and the verdict is
        returned, but nothing is journaled, no callbacks fire, and the
        dedup state is untouched — an external poller hitting the
        endpoint every few seconds must observe health, not mutate it.
        """
        findings: List[Finding] = []
        # dedup clock: non-meta events ever journaled — the alert /
        # callback_error / incident events an evaluation pass (or its
        # callbacks, e.g. the flight recorder) records must not count as
        # "new evidence" for the next pass, or a standing finding would
        # re-journal itself forever off its own side effects
        rec = self.recorder
        counts = rec.counts()
        seq = rec.total_recorded - sum(
            counts.get(k, 0) for k in _META_KINDS
        )
        for rule in self.rules:
            reason = rule.fn(rec)
            if reason is None:
                if record:
                    self._seen.pop(rule.name, None)
                continue
            f = Finding(rule.name, rule.severity, reason)
            findings.append(f)
            if not record:
                continue
            if self._seen.get(rule.name) == (reason, seq):
                continue  # same finding, no new events: don't re-journal
            rec.record(
                "alert",
                rule=rule.name,
                severity=rule.severity,
                reason=reason,
            )
            self._seen[rule.name] = (reason, seq)
            for cb in self.callbacks:
                # a broken sink must never mask a real ALERT (or abort
                # the rules still unevaluated): journal and keep going
                try:
                    cb(f)
                except Exception as exc:
                    rec.record(
                        "callback_error",
                        rule=rule.name,
                        callback=getattr(cb, "__qualname__", None)
                        or type(cb).__name__,
                        error=f"{type(exc).__name__}: {exc}",
                    )
        status = OK
        for f in findings:
            if _SEVERITY_ORDER[f.severity] > _SEVERITY_ORDER[status]:
                status = f.severity
        return {
            "status": status,
            "findings": [f._asdict() for f in findings],
        }
