"""Flight recorder: freeze an incident bundle the moment an ALERT fires
(the port's copy of the JAX package's ``telemetry/incident.py``: the same
bundle files, byte for byte but ``env.json``).

An ``alert`` event in the ring is a timestamp, not an investigation: by
the time someone looks, the journal window that explains it has been
evicted and the registry rebuilt many times. :class:`FlightRecorder`
closes that gap. Registered as a :class:`~.health.HealthMonitor`
callback (see :func:`install`), it reacts to every ALERT finding — and,
via :meth:`FlightRecorder.scan_faults` /
:meth:`FlightRecorder.capture_regression`, to injected faults and bench
REGRESSION labels — by freezing everything an operator needs into one
*incident bundle* directory:

``index.json``
    Trigger (rule / severity / reason / what kind of trigger), capture
    time, the :mod:`.context` step context of the triggering event
    (``trace`` + ``ctx_*`` join keys), all-time event counts, retained
    seq range, and the bundle file list. The machine-readable entry
    point for the ``incident`` tool and ``GET /incidents``
    (:mod:`..tools`).
``journal.jsonl``
    The retained journal window at capture time, one event per line in
    the exact export format of :meth:`~.recorder.StepRecorder.to_jsonl`
    — rehydrates through :mod:`.aggregate` into a Perfetto timeline.
``counts.json`` / ``metrics.prom`` / ``health.json`` / ``flow.json`` /
``env.json``
    All-time per-kind counts, the rendered OpenMetrics exposition, the
    triggering finding plus recent ``alert`` events, the latest
    ``flow_snapshot`` gauges, and :func:`~.regress.env_fingerprint`.

Captures are debounced per rule (``debounce_s``) so a standing ALERT
re-confirmed at every health boundary yields exactly one bundle, and
bounded (``keep``) so the incident directory cannot grow without limit.
Determinism for tests: ``clock`` and ``id_fn`` are injectable, bundle
ids default to a process-local monotone counter (not wall time), and
every JSON artifact is written with sorted keys — two seeded runs
produce byte-identical bundles.

Locking: bundle bookkeeping (debounce clocks, the id counter, the fault
scan cursor) lives behind one lock; file I/O and journal snapshots
happen outside it, so a slow disk never blocks the health pass that
triggered the capture beyond the snapshot cost itself.

This module is on the capture path and imports neither torch nor numpy
(only :func:`~.regress.env_fingerprint`, called at capture, probes
them).
"""

# gridlint: scrape-path

from __future__ import annotations

import json
import os
import shutil
import threading
import weakref
from typing import Dict, List, Optional

from mpi_grid_redistribute_tpu_torch.telemetry import context as context_lib
from mpi_grid_redistribute_tpu_torch.telemetry import metrics as metrics_lib

__all__ = ["FlightRecorder", "install", "list_bundles", "load_bundle"]

INDEX_SCHEMA = 1

# Envelope keys that constitute the step context of an event
# (telemetry/context.py).
_CTX_KEYS = ("trace", "ctx_step", "ctx_call", "ctx_attempt", "ctx_origin")


def _ctx_of(data) -> Dict[str, object]:
    return {k: data[k] for k in _CTX_KEYS if k in data}


def _dump_json(path: str, doc) -> None:
    # sorted keys + trailing newline: byte-stable across seeded runs
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")


class FlightRecorder:
    """Freeze debounced incident bundles from a recorder's journal.

    ``recorder`` is the journal to freeze; ``out_dir`` the bundle root
    (created on first capture). ``debounce_s`` suppresses repeat
    captures of the same rule; ``keep`` bounds retained bundles (oldest
    pruned). ``clock`` (defaults to ``time.time``) and ``id_fn``
    (``(n, rule) -> bundle id``) are injectable so tests pin bytes.
    """

    def __init__(
        self,
        recorder,
        out_dir,
        debounce_s: float = 60.0,
        keep: int = 32,
        clock=None,
        id_fn=None,
    ):
        if debounce_s < 0:
            raise ValueError(f"debounce_s must be >= 0, got {debounce_s}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.recorder = recorder
        self.out_dir = str(out_dir)
        self.debounce_s = float(debounce_s)
        self.keep = int(keep)
        if clock is None:
            import time as _time

            clock = _time.time
        self.clock = clock
        self._id_fn = id_fn
        # guards _last_capture/_n/_fault_seq — the health callback can
        # fire on whichever thread runs evaluate() while the driver's
        # boundary scan runs on another
        self._lock = threading.Lock()
        self._last_capture: Dict[str, float] = {}
        self._n = 0
        self._fault_seq = 0

    # -- trigger entry points -------------------------------------------

    def on_finding(self, finding) -> Optional[str]:
        """Health-callback entry point: capture on ALERT findings.

        Registered via :func:`install`; runs inline in
        ``HealthMonitor.evaluate`` on whatever thread evaluates (the
        journal write below is why that thread is a declared writer).
        Returns the bundle directory, or None (non-ALERT / debounced).
        """
        # racecheck: recorder-writer — capture journals an `incident`
        # event into the ring it freezes
        if getattr(finding, "severity", None) != "ALERT":
            return None
        return self.capture(
            rule=finding.rule,
            reason=finding.reason,
            severity=finding.severity,
            trigger="alert",
        )

    def scan_faults(self) -> List[str]:
        """Capture a bundle per ``fault_injected`` event not yet seen.

        Called from the service driver's boundaries and ``close()`` —
        injected faults that crash the attempt before a health pass
        still leave a bundle behind. Returns new bundle directories.
        """
        events = self.recorder.events("fault_injected")
        with self._lock:
            fresh = [e for e in events if e.seq > self._fault_seq]
            if fresh:
                self._fault_seq = fresh[-1].seq
        made = []
        for e in fresh:
            kind = str(e.data.get("fault", "fault"))
            out = self.capture(
                rule=f"fault_{kind}",
                reason=(
                    f"injected {kind} fault at step {e.data.get('step')}"
                ),
                severity="ALERT",
                trigger="fault",
                event=e,
            )
            if out is not None:
                made.append(out)
        return made

    def capture_regression(self, lines, labels) -> List[str]:
        """Capture on ``regress.classify_capture`` REGRESSION labels.

        ``lines``/``labels`` are the report lines and metric→label map
        the classifier returned; one bundle per regressed metric (rule
        ``regression_<metric>``), debounced like any other rule.
        """
        by_metric = {m for m, lab in dict(labels).items() if lab == "REGRESSION"}
        made = []
        for metric in sorted(by_metric):
            detail = next(
                (ln for ln in lines if metric in ln), f"{metric} regressed"
            )
            out = self.capture(
                rule=f"regression_{metric}",
                reason=detail.strip(),
                severity="ALERT",
                trigger="regression",
            )
            if out is not None:
                made.append(out)
        return made

    # -- the capture itself ---------------------------------------------

    def capture(
        self,
        rule: str,
        reason: str,
        severity: str = "ALERT",
        trigger: str = "alert",
        event=None,
    ) -> Optional[str]:
        """Freeze one bundle now; returns its directory or None when the
        rule is inside its debounce window."""
        now = float(self.clock())
        with self._lock:
            last = self._last_capture.get(rule)
            if last is not None and (now - last) < self.debounce_s:
                return None
            self._last_capture[rule] = now
            self._n += 1
            n = self._n
        bundle_id = (
            self._id_fn(n, rule)
            if self._id_fn is not None
            else f"incident-{n:04d}-{rule}"
        )
        # One journal snapshot feeds every artifact so the bundle is
        # internally consistent; the `incident` event is journaled after
        # the files are written (a bundle never contains its own event).
        rec = self.recorder
        events = rec.events()
        counts = rec.counts()
        ctx = self._trigger_context(events, rule, trigger, event)
        out = os.path.join(self.out_dir, bundle_id)
        os.makedirs(out, exist_ok=True)
        files = []

        path = os.path.join(out, "journal.jsonl")
        tags = {"host": rec.host, "pid": rec.pid}
        with open(path, "w", encoding="utf-8") as fh:
            for e in events:
                fh.write(e.to_json(tags))
                fh.write("\n")
        files.append("journal.jsonl")

        _dump_json(os.path.join(out, "counts.json"), counts)
        files.append("counts.json")

        prom = metrics_lib.render_openmetrics(metrics_lib.from_journal(rec))
        with open(
            os.path.join(out, "metrics.prom"), "w", encoding="utf-8"
        ) as fh:
            fh.write(prom)
        files.append("metrics.prom")

        alerts = [
            {"seq": e.seq, "time": e.time, **e.data}
            for e in events
            if e.kind == "alert"
        ][-16:]
        _dump_json(
            os.path.join(out, "health.json"),
            {
                "trigger": {
                    "rule": rule,
                    "severity": severity,
                    "reason": reason,
                },
                "recent_alerts": alerts,
            },
        )
        files.append("health.json")

        flow = next(
            (e for e in reversed(events) if e.kind == "flow_snapshot"), None
        )
        if flow is not None:
            _dump_json(
                os.path.join(out, "flow.json"),
                {"seq": flow.seq, "time": flow.time, **flow.data},
            )
            files.append("flow.json")

        _dump_json(os.path.join(out, "env.json"), self._env())
        files.append("env.json")

        _dump_json(
            os.path.join(out, "index.json"),
            {
                "schema": INDEX_SCHEMA,
                "id": bundle_id,
                "rule": rule,
                "severity": severity,
                "reason": reason,
                "trigger": trigger,
                "captured_at": now,
                "context": ctx,
                "counts": counts,
                "events_retained": len(events),
                "seq_first": events[0].seq if events else 0,
                "seq_last": events[-1].seq if events else 0,
                "files": sorted(files),
            },
        )

        # record_at with the (injectable) capture clock, and the bundle
        # id rather than its absolute path: a later bundle's journal
        # window contains this event, and it must stay byte-stable
        # across seeded runs that use different output roots
        rec.record_at(
            "incident",
            now,
            rule=rule,
            trigger=trigger,
            id=bundle_id,
            events=len(events),
        )
        self._prune()
        return out

    def _trigger_context(self, events, rule, trigger, event):
        # precedence: the triggering event itself, then the alert event
        # this finding just journaled (it carries the evaluating
        # thread's envelope), then whatever context is active here
        if event is not None:
            return _ctx_of(event.data)
        if trigger == "alert":
            for e in reversed(events):
                if e.kind == "alert" and e.data.get("rule") == rule:
                    ctx = _ctx_of(e.data)
                    if ctx:
                        return ctx
                    break
        env = context_lib.envelope_fields()
        return _ctx_of(env) if env else {}

    def _env(self):
        # lazy: regress pulls glob/argparse machinery the hot path never
        # needs
        from mpi_grid_redistribute_tpu_torch.telemetry import (
            regress as regress_lib,
        )

        try:
            return regress_lib.env_fingerprint()
        except Exception as exc:  # fingerprinting must never kill capture
            return {"error": f"{type(exc).__name__}: {exc}"}

    def _prune(self) -> None:
        bundles = []
        try:
            names = os.listdir(self.out_dir)
        except OSError:
            return
        for name in names:
            d = os.path.join(self.out_dir, name)
            if os.path.isfile(os.path.join(d, "index.json")):
                try:
                    bundles.append((os.path.getmtime(d), name, d))
                except OSError:
                    continue
        bundles.sort()
        for _, _, d in bundles[: max(0, len(bundles) - self.keep)]:
            shutil.rmtree(d, ignore_errors=True)


# recorder -> FlightRecorder already attached to it: a supervisor
# restart builds a fresh driver + monitor around the SAME recorder, and
# the bundle counter / debounce clocks must survive that or every
# attempt would re-capture (and overwrite) the same standing alert.
_INSTALLED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def install(
    monitor,
    recorder,
    out_dir,
    debounce_s: float = 60.0,
    keep: int = 32,
    clock=None,
    id_fn=None,
) -> FlightRecorder:
    """Attach a :class:`FlightRecorder` to ``monitor`` as an ALERT sink.

    Idempotent per recorder: if a flight recorder for the same
    ``out_dir`` is already attached to this journal (a previous restart
    attempt installed it), it is re-registered on the new monitor and
    its debounce/counter state carries over.
    """
    fr = _INSTALLED.get(recorder)
    if fr is None or fr.out_dir != str(out_dir):
        fr = FlightRecorder(
            recorder,
            out_dir,
            debounce_s=debounce_s,
            keep=keep,
            clock=clock,
            id_fn=id_fn,
        )
        _INSTALLED[recorder] = fr
    if not any(
        getattr(cb, "__self__", None) is fr for cb in monitor.callbacks
    ):
        monitor.add_callback(fr.on_finding)
    return fr


def list_bundles(out_dir) -> List[dict]:
    """Index entries of every bundle under ``out_dir``, oldest first.

    Unreadable bundles are reported as ``{"id", "error"}`` entries
    rather than hidden — a corrupt bundle during an incident is itself
    a finding. Missing directories yield an empty list.
    """
    out_dir = str(out_dir)
    try:
        names = sorted(os.listdir(out_dir))
    except OSError:
        return []
    entries = []
    for name in names:
        path = os.path.join(out_dir, name, "index.json")
        if not os.path.isfile(path):
            continue
        try:
            with open(path, "r", encoding="utf-8") as fh:
                entries.append(json.load(fh))
        except (OSError, ValueError) as exc:
            entries.append(
                {"id": name, "error": f"{type(exc).__name__}: {exc}"}
            )
    entries.sort(key=lambda d: (d.get("captured_at", 0.0), d.get("id", "")))
    return entries


def load_bundle(out_dir, bundle_id) -> dict:
    """One bundle's index plus its on-disk location and actual files."""
    d = os.path.join(str(out_dir), str(bundle_id))
    path = os.path.join(d, "index.json")
    with open(path, "r", encoding="utf-8") as fh:
        index = json.load(fh)
    index["dir"] = d
    index["files_present"] = sorted(
        f for f in os.listdir(d) if os.path.isfile(os.path.join(d, f))
    )
    return index
