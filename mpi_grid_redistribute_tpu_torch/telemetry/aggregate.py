"""Multi-host journal aggregation: merge per-process shards pod-wide (the
port's copy of the JAX package's ``telemetry/aggregate.py``, the same
merge order and counts).

A pod job runs one process per host; each writes its own journal shard
(``StepRecorder.to_jsonl`` — every line tagged ``host``/``pid``). This
module merges those shards into one pod-wide event stream so the
single-process observability stack (FlowAccumulator, HealthMonitor,
``exchange_report``, the metrics plane) runs unchanged over the whole
pod.

Merge semantics:

* **Monotonic-clock alignment.** Within a shard, ``seq`` is the truth
  of ordering; wall clocks wobble (NTP steps, clock skew between
  hosts). Each shard's times are first repaired to be monotone
  non-decreasing (a backward step is clamped to the previous event's
  time), optionally re-based to the shard's own start
  (``align="start"`` — comparable offsets when hosts' wall clocks
  disagree by more than the run length), then shards are k-way merged
  on aligned time with ``(host, pid, seq)`` as the tie-break. Intra-
  shard order is always preserved exactly.
* **Exact counts.** ``MergedJournal.counts()`` sums the per-shard
  per-kind counters, so pod-wide totals equal the sum of shard totals
  by construction (tested as the merge-equals-sum property).

Host code only: it uses NumPy for :meth:`MergedJournal.pod_stats` and
never imports torch.
"""

# gridlint: scrape-path

from __future__ import annotations

import json
import types
from typing import Dict, List, Optional, Tuple

import numpy as np

from mpi_grid_redistribute_tpu_torch.telemetry import recorder as recorder_lib

# envelope keys a JSONL line may carry beyond the payload
_ENVELOPE = ("seq", "time", "kind", "host", "pid")


class Shard:
    """One process's journal: identity plus decoded event rows."""

    def __init__(self, host: str, pid: int, rows: List[dict]):
        self.host = str(host)
        self.pid = int(pid)
        self.rows = rows  # [{seq, time, kind, **payload}] in seq order

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.rows:
            out[r["kind"]] = out.get(r["kind"], 0) + 1
        return out


def _shard_from_lines(lines, fallback_host, fallback_pid) -> Shard:
    rows = []
    host, pid = fallback_host, fallback_pid
    for ln in lines:
        ln = ln.strip()
        if not ln:
            continue
        d = json.loads(ln)
        host = d.pop("host", host)
        pid = d.pop("pid", pid)
        rows.append(d)
    rows.sort(key=lambda r: r.get("seq", 0))
    return Shard(host, pid, rows)


def _coerce_shard(source, idx: int) -> Shard:
    """Accept a JSONL path, an open text file, a ``StepRecorder``, or an
    iterable of decoded dicts."""
    if isinstance(source, recorder_lib.StepRecorder):
        rows = [
            {"seq": e.seq, "time": e.time, "kind": e.kind, **e.data}
            for e in source.events()
        ]
        return Shard(source.host, source.pid, rows)
    fallback = (f"shard{idx}", 0)
    if isinstance(source, (str, bytes)):
        with open(source) as f:
            return _shard_from_lines(f, *fallback)
    if hasattr(source, "read"):
        return _shard_from_lines(source, *fallback)
    # iterable of decoded dicts
    lines = [json.dumps(d) for d in source]
    return _shard_from_lines(lines, *fallback)


class MergedJournal:
    """The pod-wide event stream plus per-shard attribution.

    ``events`` rows carry the shard identity (``host``/``pid``), the
    original ``seq``/``time``, the aligned merge key ``t_aligned``, and
    the flat payload — directly consumable by
    :func:`..metrics.from_journal`.
    """

    def __init__(self, shards: List[Shard], events: List[dict],
                 align: str):
        self.shards = shards
        self._events = events
        self.align = align

    def events(self, kind: Optional[str] = None) -> List[dict]:
        if kind is None:
            return list(self._events)
        return [e for e in self._events if e["kind"] == kind]

    def __len__(self) -> int:
        return len(self._events)

    def counts(self) -> Dict[str, int]:
        """Pod-wide per-kind totals == sum over shards (by construction;
        the merge-equals-sum test asserts it end to end)."""
        out: Dict[str, int] = {}
        for sh in self.shards:
            for k, n in sh.counts().items():
                out[k] = out.get(k, 0) + n
        return out

    def per_shard_counts(self) -> Dict[Tuple[str, int], Dict[str, int]]:
        return {(sh.host, sh.pid): sh.counts() for sh in self.shards}

    # -- projections into the single-process observability stack --------

    def to_recorder(
        self,
        pod_steps: bool = False,
        capacity: Optional[int] = None,
    ) -> recorder_lib.StepRecorder:
        """Replay the merged stream into a fresh ``StepRecorder`` (host
        tag ``"pod"``) so HealthMonitor / trace export / metrics replay
        run over the pod-wide journal.

        ``pod_steps=True`` additionally *sums* same-step ``migrate_step``
        events across shards into one pod-wide event per step (scalar
        counters added; ``*_per_rank`` vectors concatenated in shard
        order — each shard covers its own rank slice of the pod), which
        is what the backlog/drop health rules should judge: a pod with
        one hot shard must page on pod totals, not per-shard slivers.
        Non-step events keep their shard identity as ``host``/``pid``
        payload keys."""
        cap = capacity if capacity is not None else max(
            4096, 2 * len(self._events) or 4096
        )
        rec = recorder_lib.StepRecorder(capacity=cap, host="pod", pid=0)
        if not pod_steps:
            for e in self._events:
                d = self._payload(e)
                rec.record_at(
                    e["kind"], e.get("t_aligned"),
                    host=e["host"], pid=e["pid"], **d,
                )
            return rec
        # group migrate_step by step index across shards
        groups: Dict[int, List[dict]] = {}
        out_rows: List[Tuple[float, int, dict]] = []
        for order, e in enumerate(self._events):
            if e["kind"] == "migrate_step" and "step" in e:
                groups.setdefault(int(e["step"]), []).append(e)
            else:
                d = self._payload(e)
                d.update(host=e["host"], pid=e["pid"])
                out_rows.append(
                    (e.get("t_aligned", 0.0), order,
                     {"kind": e["kind"], "data": d})
                )
        for step, evs in groups.items():
            agg = {"step": step}
            for key in (
                "sent", "received", "backlog", "dropped_recv", "population"
            ):
                if any(key in self._payload(e) for e in evs):
                    agg[key] = sum(
                        int(self._payload(e).get(key, 0)) for e in evs
                    )
            for key in (
                "sent_per_rank", "received_per_rank", "population_per_rank"
            ):
                if all(key in self._payload(e) for e in evs):
                    vec: List[int] = []
                    for e in evs:
                        vec.extend(int(x) for x in self._payload(e)[key])
                    agg[key] = vec
            t = max(e.get("t_aligned", 0.0) for e in evs)
            out_rows.append(
                (t, len(self._events) + step,
                 {"kind": "migrate_step", "data": agg})
            )
        out_rows.sort(key=lambda r: (r[0], r[1]))
        for t, _, row in out_rows:
            rec.record_at(row["kind"], t, **row["data"])
        return rec

    def pod_stats(self):
        """Pod-wide ``MigrateStats``-shaped view of the merged
        ``migrate_step`` stream, for ``exchange_report`` /
        ``summarize_migrate``.

        When every shard journaled ``rank_totals=True`` vectors, the
        rank axis is the pod's full rank space (shards concatenated in
        shard order): arrays are ``[S, R_pod]``. Otherwise each shard
        collapses to one column (its per-step totals): ``[S, n_shards]``.
        Steps present in only some shards are zero-filled for the
        missing shards. Raises ``ValueError`` when no shard journaled
        migrate steps."""
        per_shard: List[Dict[int, dict]] = []
        for sh in self.shards:
            by_step = {
                int(r["step"]): r
                for r in sh.rows
                if r["kind"] == "migrate_step" and "step" in r
            }
            if by_step:
                per_shard.append(by_step)
        if not per_shard:
            raise ValueError(
                "no migrate_step events in any shard — nothing to"
                " aggregate into pod stats"
            )
        steps = sorted({s for by in per_shard for s in by})
        ranked = all(
            "sent_per_rank" in r for by in per_shard for r in by.values()
        )
        widths = []
        for by in per_shard:
            widths.append(
                len(next(iter(by.values()))["sent_per_rank"]) if ranked
                else 1
            )
        cols = sum(widths)
        names = ("sent", "received", "backlog", "dropped_recv",
                 "population")
        arrs = {n: np.zeros((len(steps), cols), np.int64) for n in names}
        for si, step in enumerate(steps):
            c0 = 0
            for by, w in zip(per_shard, widths):
                r = by.get(step)
                if r is not None:
                    for n in names:
                        if ranked and f"{n}_per_rank" in r:
                            arrs[n][si, c0:c0 + w] = r[f"{n}_per_rank"]
                        elif n in r:
                            # totals only: spread is unknowable, put the
                            # shard total in its single column
                            arrs[n][si, c0] = int(r[n])
                c0 += w
        return types.SimpleNamespace(steps=steps, **arrs)

    def flow_snapshot(self, k: int = 5) -> dict:
        """Pod-wide flow gauges merged from the shards' latest
        ``flow_snapshot`` events: moved totals summed, ``top_pairs``
        re-ranked across shards (rank indices are shard-local — pairs
        keep a ``host`` tag instead of being offset, since shards don't
        journal their rank base). Raises ``ValueError`` when no shard
        journaled a snapshot."""
        snaps = []
        for sh in self.shards:
            rows = [r for r in sh.rows if r["kind"] == "flow_snapshot"]
            if rows:
                snaps.append((sh, rows[-1]))
        if not snaps:
            raise ValueError("no flow_snapshot events in any shard")
        pairs = []
        for sh, s in snaps:
            for src, dst, rows in s.get("top_pairs", []):
                pairs.append([sh.host, int(src), int(dst), int(rows)])
        pairs.sort(key=lambda p: -p[3])
        return {
            "shards": len(snaps),
            "n_ranks": sum(int(s.get("n_ranks", 0)) for _, s in snaps),
            "moved_rows_total": sum(
                int(s.get("moved_rows_total", 0)) for _, s in snaps
            ),
            "imbalance": max(
                float(s.get("imbalance", 1.0)) for _, s in snaps
            ),
            "top_pairs": pairs[:k],
        }

    @staticmethod
    def _payload(e: dict) -> dict:
        return {
            k: v for k, v in e.items()
            if k not in _ENVELOPE and k != "t_aligned"
        }


def merge_journals(sources, align: str = "wall") -> MergedJournal:
    """Merge journal shards into one pod-wide :class:`MergedJournal`.

    ``sources`` — JSONL paths, open files, ``StepRecorder`` instances,
    or iterables of decoded event dicts (mixable). ``align``:

    * ``"wall"`` (default) — shards share a clock domain (same host, or
      NTP-synced pod); merge on repaired wall time.
    * ``"start"`` — re-base each shard to its own first event (merge on
      run-relative offsets); use when hosts' clocks disagree by more
      than the run length.
    """
    if align not in ("wall", "start"):
        raise ValueError(f"align must be 'wall' or 'start', got {align!r}")
    shards = [_coerce_shard(s, i) for i, s in enumerate(sources)]
    if not shards:
        raise ValueError("merge_journals: no sources")
    merged: List[dict] = []
    for sh in shards:
        t0 = None
        prev = -float("inf")
        for r in sh.rows:
            t = float(r.get("time", 0.0))
            if t0 is None:
                t0 = t
            # monotone repair: a backward wall-clock step cannot reorder
            # events within the shard (seq is the intra-shard truth)
            prev = max(prev, t)
            e = dict(r)
            e["host"], e["pid"] = sh.host, sh.pid
            e["t_aligned"] = prev - (t0 if align == "start" else 0.0)
            merged.append(e)
    merged.sort(
        key=lambda e: (
            e["t_aligned"], e["host"], e["pid"], e.get("seq", 0)
        )
    )
    return MergedJournal(shards, merged, align)
