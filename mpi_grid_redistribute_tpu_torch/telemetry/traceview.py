"""Perfetto/Chrome-trace export of the telemetry journal (the port's copy
of the JAX package's ``telemetry/traceview.py``).

One command turns any bench run into a viewable timeline: the JSON this
module emits loads in Perfetto (ui.perfetto.dev) or ``chrome://tracing``
— the standard Trace Event Format (``{"traceEvents": [...]}``, each
event carrying ``ph``/``ts``/``pid``/``tid``/``name``).

Three track families:

* **Journal instants** (pid 0): every retained
  :class:`~.recorder.StepRecorder` event becomes an instant event
  (``ph="i"``) on a per-kind track (one ``tid`` per event kind, labeled
  with thread-name metadata), timestamped with the event's host wall
  time relative to the first retained event. ``alert`` events land on
  their own track next to the events that caused them. Events whose
  envelope carries a ``trace`` step context (``telemetry/context.py``)
  additionally get Perfetto **flow arrows** (``ph="s"``/``ph="f"``):
  each ``alert`` / ``restart`` / ``incident`` instant is linked back to
  the latest preceding same-trace cause event, so the UI draws the
  arrow from the step that burned the budget to the alert it tripped.
* **Phase spans** (pid 1): :class:`~.phases.PhaseTiming` rows (the
  span tables' / ``attribute_phases`` output) become duration events
  (``ph="X"``) laid end to end — each phase's span length is its
  attributed ``delta_s``, so the lane reads as one step's time budget.
* **Migrate counters** (pid 2): ``migrate_step`` journal events become
  counter tracks (``ph="C"``) for population, backlog, sent — the
  timeline view of the drift workload unbalancing. When the journal
  carries measured ``step_time`` events their host wall times anchor
  the counter axis (an honest axis for driver runs, which journal step
  timings at health boundaries); otherwise the axis is SYNTHETIC:
  ``step * step_seconds`` (default 1 ms per step), since batch-journaled
  step events all share one wall time.

``GridRedistribute.to_perfetto()`` exports an API instance's journal.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

_TRACK_FAMILIES = {
    0: "journal (instant events per kind)",
    1: "phase attribution (duration events)",
    2: "migrate steps (counter tracks)",
}

# pid-0 instants that are *reactions* — flow-arrow targets. They (plus
# callback_error, another meta kind) never act as flow *sources*: the
# arrow should point at the workload event that caused the reaction,
# not at an earlier reaction that shares its trace.
_EFFECT_KINDS = ("alert", "restart", "incident")


def _meta(pid: int, tid: int, what: str, name: str) -> Dict[str, object]:
    return {
        "ph": "M",
        "pid": pid,
        "tid": tid,
        "name": what,
        "args": {"name": name},
    }


def _json_safe(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


def to_chrome_trace(
    recorder=None,
    phase_timings: Optional[Sequence] = None,
    step_seconds: Optional[float] = None,
    annotations: Optional[Dict[str, dict]] = None,
) -> Dict[str, object]:
    """Build one Trace Event Format dict from telemetry sources.

    Args:
      recorder: a :class:`~.recorder.StepRecorder`; its retained events
        become instant events (pid 0) and its ``migrate_step`` events
        additionally feed the counter tracks (pid 2).
      phase_timings: :class:`~.phases.PhaseTiming` rows
        (``attribute_phases`` output) for the duration lane (pid 1).
      step_seconds: honest per-step seconds for the counter track's
        synthetic time axis (default 1 ms per step).
      annotations: optional ``{phase_name: {key: value}}`` cost context
        (roofline flops/bytes/bound-by — see ``telemetry.roofline``)
        merged into the matching pid-1 duration event's ``args`` so the
        Perfetto tooltip shows what the phase SHOULD cost next to what
        it measured. Keys never overwrite the measured columns.

    Returns a JSON-serializable dict; every event carries the required
    ``ph``/``ts``/``pid`` keys.
    """
    events: List[Dict[str, object]] = []
    for pid, name in _TRACK_FAMILIES.items():
        events.append(_meta(pid, 0, "process_name", name))

    # --- pid 0: journal instants, one tid per kind --------------------
    if recorder is not None:
        journal = recorder.events()
        t0 = journal[0].time if journal else 0.0
        tids: Dict[str, int] = {}
        inst_ts: List[float] = []
        for e in journal:
            tid = tids.setdefault(e.kind, len(tids))
            ts = (e.time - t0) * 1e6  # us
            inst_ts.append(ts)
            events.append(
                {
                    "name": e.kind,
                    "ph": "i",
                    "ts": ts,
                    "pid": 0,
                    "tid": tid,
                    "s": "t",  # thread-scoped instant
                    "args": {
                        "seq": e.seq,
                        **{k: _json_safe(v) for k, v in e.data.items()},
                    },
                }
            )
        for kind, tid in tids.items():
            events.append(_meta(0, tid, "thread_name", kind))

        # flow arrows: each effect instant (alert/restart/incident) is
        # linked to the latest preceding same-trace cause event via a
        # ph="s"/"f" pair sharing an id — Perfetto draws the arrow
        flow_id = 0
        last_by_trace: Dict[str, int] = {}
        for i, e in enumerate(journal):
            trace = e.data.get("trace")
            if not isinstance(trace, str):
                continue
            if e.kind in _EFFECT_KINDS:
                j = last_by_trace.get(trace)
                if j is not None:
                    flow_id += 1
                    cause = journal[j]
                    pair = (
                        ("s", j, cause.kind, {}),
                        ("f", i, e.kind, {"bp": "e"}),
                    )
                    for ph, idx, kind, extra in pair:
                        events.append(
                            {
                                "name": f"cause:{e.kind}",
                                "cat": "causal",
                                "ph": ph,
                                "id": flow_id,
                                "ts": inst_ts[idx],
                                "pid": 0,
                                "tid": tids[kind],
                                **extra,
                            }
                        )
            elif e.kind != "callback_error":
                last_by_trace[trace] = i

    # --- pid 1: phase-attribution duration lane -----------------------
    if phase_timings:
        events.append(_meta(1, 0, "thread_name", "phases"))
        cursor = 0.0
        for row in phase_timings:
            dur = max(float(row.delta_s), 0.0) * 1e6
            args: Dict[str, object] = {
                "cumulative_s": float(row.cumulative_s),
                "delta_s": float(row.delta_s),
            }
            if getattr(row, "logical_bytes", None) is not None:
                args["logical_bytes"] = int(row.logical_bytes)
            x = getattr(row, "x_roofline", None)
            if x is not None:
                args["x_roofline"] = float(x)
            extra = (annotations or {}).get(str(row.phase))
            if extra:
                for k, v in extra.items():
                    args.setdefault(str(k), _json_safe(v))
            events.append(
                {
                    "name": str(row.phase),
                    "ph": "X",
                    "ts": cursor,
                    "dur": dur,
                    "pid": 1,
                    "tid": 0,
                    "args": args,
                }
            )
            cursor += dur

    # --- pid 2: migrate-step counter tracks ---------------------------
    if recorder is not None:
        dt_us = (step_seconds if step_seconds else 1e-3) * 1e6
        events.append(_meta(2, 0, "thread_name", "migrate counters"))
        # measured step_time wall times anchor the axis when present;
        # step-keyed where the events carry a step index, positional
        # otherwise. Batch-journaled runs without timings keep the
        # synthetic step * step_seconds axis.
        st = recorder.events("step_time")
        wall_by_step = {
            int(e.data["step"]): e.time for e in st if "step" in e.data
        }
        walls = [e.time for e in st]
        for i, e in enumerate(recorder.events("migrate_step")):
            step = int(e.data.get("step", 0))
            if step in wall_by_step:
                ts = (wall_by_step[step] - t0) * 1e6
            elif walls:
                ts = (walls[min(i, len(walls) - 1)] - t0) * 1e6
            else:
                ts = float(step) * dt_us
            for counter in ("population", "backlog", "sent"):
                if counter in e.data:
                    events.append(
                        {
                            "name": counter,
                            "ph": "C",
                            "ts": ts,
                            "pid": 2,
                            "tid": 0,
                            "args": {counter: int(e.data[counter])},
                        }
                    )

    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_trace(
    path: str,
    recorder=None,
    phase_timings: Optional[Sequence] = None,
    step_seconds: Optional[float] = None,
    annotations: Optional[Dict[str, dict]] = None,
) -> int:
    """Write :func:`to_chrome_trace` JSON to ``path``; returns the number
    of trace events written (metadata included)."""
    trace = to_chrome_trace(
        recorder,
        phase_timings=phase_timings,
        step_seconds=step_seconds,
        annotations=annotations,
    )
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])
