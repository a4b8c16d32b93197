"""Step recorder: bounded host-side ring buffer of structured events (the
port's copy of the JAX package's ``telemetry/recorder.py``, same event
kinds, payload keys and JSON Lines).

Events are plain host-side dicts: recording one is a lock-guarded deque
append and NEVER reads the device, so the recorder can stay on in
steady-state loops. The ring is bounded (default 4096 events); all-time
per-kind counts survive eviction, so ``counts()`` is exact even when the
ring has wrapped.

Locking: one recorder may be shared across threads. Every mutation
(:meth:`~StepRecorder.record`, :meth:`~StepRecorder.record_at`,
:meth:`~StepRecorder.clear`) and every reader of the ring, counts and
sequence takes the internal lock; exports copy the retained window under
the lock and write files outside it.

Event kinds the port's instruments emit:

* ``redistribute`` / ``halo``: one per public API call (call index,
  capacities, rows);
* ``capacity_grow`` / ``halo_grow``: a measured overflow grew a capacity;
* ``overflow_window_scheduled`` / ``_clean`` / ``_loss``: the deferred
  check's lifecycle;
* ``engine_resolved``: the engine a call resolved to, with the reason;
* ``mover_cap_grow`` / ``cross_cap_grow``: the count-driven engines'
  blocks ratcheted;
* ``migrate_step`` / ``fast_path``: per-step counters of a step-stacked
  ``MigrateStats`` (:func:`record_migrate_steps`,
  :func:`record_fast_path_steps`).

The stats readers take tensors on any device (or NumPy arrays) and read
each leaf to the host once, at the call the caller chose.
"""

from __future__ import annotations

import collections
import io
import json
import os
import socket
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from mpi_grid_redistribute_tpu_torch.telemetry import context as context_lib


class Event(NamedTuple):
    """One recorded event: monotone sequence number, host wall time
    (``time.time()``), kind tag, and a flat JSON-serializable payload."""

    seq: int
    time: float
    kind: str
    data: dict

    def to_json(self, tags: Optional[dict] = None) -> str:
        """JSON for one journal line; ``tags`` adds envelope fields
        (e.g. the recorder's ``host``/``pid``) without touching the
        payload — payload keys win on collision so replayed journals
        round-trip."""
        doc = {"seq": self.seq, "time": self.time, "kind": self.kind}
        if tags:
            doc.update(tags)
        doc.update(self.data)
        return json.dumps(doc, sort_keys=True)


class StepRecorder:
    """Bounded ring buffer of :class:`Event` with all-time kind counts.

    ``capacity`` bounds retained events (oldest evicted first); the
    per-kind counters in :meth:`counts` are all-time, so operators can
    distinguish "no growth events ever" from "growth events scrolled
    off". ``enabled=False`` turns :meth:`record` into a no-op counter
    bump — the shape of the API stays, the memory goes away.

    ``host``/``pid`` identify the writing process on every exported
    journal line (multi-host shard merging keys on them; see
    :mod:`.aggregate`). They default to this process but are
    overridable — pod emulations on one machine label virtual hosts,
    and shard replay preserves the original writer.
    """

    def __init__(
        self,
        capacity: int = 4096,
        enabled: bool = True,
        host: Optional[str] = None,
        pid: Optional[int] = None,
    ):
        if int(capacity) < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._ring: collections.deque = collections.deque(
            maxlen=int(capacity)
        )
        self._counts: Dict[str, int] = {}
        self._seq = 0
        # guards _ring/_counts/_seq: the step loop records while the
        # snapshot writer exports and the scrape path reads (see the
        # module docstring's locking contract)
        self._lock = threading.Lock()
        self.enabled = bool(enabled)
        self.host = socket.gethostname() if host is None else str(host)
        self.pid = os.getpid() if pid is None else int(pid)

    @property
    def capacity(self) -> int:
        with self._lock:
            return self._ring.maxlen

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def total_recorded(self) -> int:
        with self._lock:
            return self._seq

    @property
    def evicted(self) -> int:
        """Events recorded but no longer retained (ring wrapped)."""
        with self._lock:
            return self._seq - len(self._ring)

    def record(self, kind: str, **data) -> None:
        """Append one event. Host-side only; values must already be host
        scalars (int/float/str) — pass ``int(...)``/``float(...)`` of any
        device value at a point where syncing is acceptable, or better,
        record only host-derived control-flow facts (capacities, call
        indices, window bounds), which is what the in-repo hooks do."""
        with self._lock:
            self._record_locked(kind, None, data)

    def record_at(self, kind: str, when: Optional[float], **data) -> None:
        """:meth:`record` with an explicit wall time — the replay path.

        Journal rehydration (``scripts/trace_export.py``) and multi-host
        shard merging (:mod:`.aggregate`) re-record events that already
        happened; stamping them with *this* process's clock would destroy
        the cross-shard ordering the merge just computed. ``when=None``
        falls back to ``time.time()`` (same as :meth:`record`)."""
        with self._lock:
            self._record_locked(kind, when, data)

    def _record_locked(
        self, kind: str, when: Optional[float], data: dict
    ) -> None:
        # caller holds self._lock
        self._counts[kind] = self._counts.get(kind, 0) + 1
        self._seq += 1
        if self.enabled:
            # Merge the recording thread's active StepContext into the
            # envelope (telemetry/context.py). Payload keys win: replayed
            # events (record_at from aggregate/trace_export) already carry
            # their original attribution and must not be restamped.
            env = context_lib.envelope_fields()
            if env:
                for k, v in env.items():
                    if k not in data:
                        data[k] = v
            t = time.time() if when is None else float(when)
            self._ring.append(Event(self._seq, t, kind, data))

    def events(self, kind: Optional[str] = None) -> List[Event]:
        """Retained events, oldest first; optionally filtered by kind.
        Returns a snapshot copied under the lock — callers iterate it
        without racing concurrent appends."""
        with self._lock:
            if kind is None:
                return list(self._ring)
            return [e for e in self._ring if e.kind == kind]

    def last(self, kind: Optional[str] = None) -> Optional[Event]:
        evs = self.events(kind)
        return evs[-1] if evs else None

    def counts(self) -> Dict[str, int]:
        """All-time events per kind (survives ring eviction)."""
        with self._lock:
            return dict(self._counts)

    def clear(self) -> None:
        """Drop retained events AND all-time counts (fresh journal)."""
        with self._lock:
            self._ring.clear()
            self._counts.clear()
            self._seq = 0

    def to_jsonl(self, path_or_file) -> int:
        """Write retained events as JSON Lines; returns events written.

        Accepts a path or an open text file. Every line carries the
        recorder's ``host``/``pid`` envelope tags so shards from
        different processes stay attributable after they are merged
        (SCHEMA.md "Envelope"). The export is the retained window only —
        pair with :meth:`counts` (exact all-time totals) when the ring
        may have wrapped.
        """
        events = self.events()
        tags = {"host": self.host, "pid": self.pid}
        if isinstance(path_or_file, (str, bytes)):
            with open(path_or_file, "w") as f:
                for e in events:
                    f.write(e.to_json(tags) + "\n")
        else:
            f = path_or_file
            for e in events:
                f.write(e.to_json(tags) + "\n")
        return len(events)

    def dumps_jsonl(self) -> str:
        buf = io.StringIO()
        self.to_jsonl(buf)
        return buf.getvalue()


def record_migrate_steps(
    recorder: StepRecorder,
    stats,
    max_steps: Optional[int] = None,
    rank_totals: bool = False,
) -> int:
    """Feed a step-stacked ``MigrateStats`` into ``recorder`` as one
    ``migrate_step`` event per step (sent/received/backlog/dropped/
    population totals). This is the bridge from the migrate loops — whose
    stats come back as ``[S, R]`` device arrays — to the host journal;
    calling it forces ONE host transfer of the (tiny) stats pytree, so
    call it where the bench drivers already read stats, not inside a hot
    loop. ``max_steps`` keeps only the trailing window.
    ``rank_totals=True`` additionally records the per-rank vectors
    (``sent_per_rank``/``received_per_rank``/``population_per_rank``
    lists) each step — the per-rank view the flow path's imbalance rules
    consume. Returns the number of events recorded.

    Every counter leaf must have the same shape as ``sent`` — a
    mismatched hand-built pytree raises a named ValueError here instead
    of silently reshaping into wrong per-step totals (or dying in numpy
    with an opaque broadcast error)."""
    from mpi_grid_redistribute_tpu_torch.utils.stats import host_arrays

    names = ("received", "backlog", "dropped_recv", "population")
    sent0, *rest = host_arrays(
        [stats.sent] + [getattr(stats, name) for name in names])
    sent = sent0.reshape(-1, sent0.shape[-1])
    leaves = {}
    for name, a in zip(names, rest):
        if a.size != sent.size:
            raise ValueError(
                f"MigrateStats.{name} has shape {a.shape} "
                f"({a.size} elements) but sent has shape "
                f"{sent0.shape} ({sent.size} elements) "
                f"— stats leaves must be shape-congruent per step"
            )
        leaves[name] = a.reshape(sent.shape)
    recv, backlog = leaves["received"], leaves["backlog"]
    dropped, pop = leaves["dropped_recv"], leaves["population"]
    start = 0 if max_steps is None else max(0, sent.shape[0] - max_steps)
    for s in range(start, sent.shape[0]):
        extra = {}
        if rank_totals:
            extra = {
                "sent_per_rank": [int(x) for x in sent[s]],
                "received_per_rank": [int(x) for x in recv[s]],
                "population_per_rank": [int(x) for x in pop[s]],
            }
        recorder.record(
            "migrate_step",
            step=s,
            sent=int(sent[s].sum()),
            received=int(recv[s].sum()),
            backlog=int(backlog[s].sum()),
            dropped_recv=int(dropped[s].sum()),
            population=int(pop[s].sum()),
            **extra,
        )
    return sent.shape[0] - start


def record_fast_path_steps(
    recorder: StepRecorder,
    stats,
    mover_cap: Optional[int] = None,
    max_steps: Optional[int] = None,
) -> int:
    """Feed a step-stacked ``MigrateStats`` from a sparse-capable engine
    into ``recorder`` as one ``fast_path`` event per step: whether the
    mover-sparse branch ran (``taken``) or the step fell back to the
    dense planar engine, plus the exact mover count that drove the
    routing guard (``movers = sent + backlog`` — granted sends plus
    held-back leavers) and, when given, the static ``mover_cap`` the
    count was checked against. Same host-transfer contract as
    :func:`record_migrate_steps`: call it where the driver already reads
    stats. ``max_steps`` keeps only the trailing window. Returns events
    recorded.

    Raises a named ValueError when ``stats.fast_path`` is None — that
    means the loop was built without ``mover_cap`` and carries no sparse
    path, so journaling a 0% hit rate for it would misread as "always
    falling back"."""
    if stats.fast_path is None:
        raise ValueError(
            "MigrateStats.fast_path is None: this loop was built without"
            " mover_cap (no sparse path to journal); build it with"
            " engine='auto'/'sparse' on a sparse-eligible config first"
        )
    from mpi_grid_redistribute_tpu_torch.utils.stats import host_arrays

    fp, sent, backlog = host_arrays(
        [stats.fast_path, stats.sent, stats.backlog])
    fp = fp.reshape(-1, fp.shape[-1])
    sent = sent.reshape(fp.shape)
    backlog = backlog.reshape(fp.shape)
    start = 0 if max_steps is None else max(0, fp.shape[0] - max_steps)
    extra = {} if mover_cap is None else {"mover_cap": int(mover_cap)}
    for s in range(start, fp.shape[0]):
        recorder.record(
            "fast_path",
            step=s,
            # the guard is one scalar broadcast across ranks: any() == all()
            taken=int(bool(fp[s].any())),
            movers=int((sent[s] + backlog[s]).sum()),
            movers_max_rank=int((sent[s] + backlog[s]).max()),
            **extra,
        )
    return fp.shape[0] - start


def record_chunk_steps(
    recorder: StepRecorder,
    first_step: int,
    seconds_per_step: float,
    dropped,
) -> int:
    """Fold one chunk of steps into the per-step journal surface: one
    ``step_latency`` event per step, with the wall apportioned evenly
    over the chunk and the dropped-row counts the caller already read.
    Same host-transfer contract as :func:`record_migrate_steps`: the
    caller passes host values at a chunk boundary, never tensors from a
    hot loop. Steps are numbered
    ``first_step, first_step + 1, ...`` — the post-increment numbering
    the eager loop journals — so the SLO window rules and the
    ``grid_step_latency_seconds`` / ``grid_dropped_rows`` histogram
    scrape see an identical event stream for any chunk length. Returns
    the number of events recorded."""
    n = 0
    for i, d in enumerate(dropped):
        recorder.record(
            "step_latency",
            step=int(first_step) + i,
            seconds=float(seconds_per_step),
            dropped=int(d),
        )
        n += 1
    return n


def fast_path_hit_rate(recorder: StepRecorder) -> Optional[float]:
    """Fraction of retained ``fast_path`` events with ``taken=1``; None
    when no sparse-engine steps have been journaled."""
    ev = recorder.events("fast_path")
    if not ev:
        return None
    return sum(int(e.data.get("taken", 0)) for e in ev) / len(ev)
