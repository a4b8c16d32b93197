"""Runtime thread-access sanitizer for the telemetry journal (the port's
copy of the JAX package's ``telemetry/tsan.py``).

This module checks the recorder's locking contract DYNAMICALLY, the way
the fault matrix checks the restart policy: :class:`ThreadAccessTracer` arms a
live :class:`~.recorder.StepRecorder` by swapping its ``_lock`` /
``_ring`` / ``_counts`` for traced wrappers, then every touch of the
journal's shared state is logged with the touching thread's identity
and whether the recorder lock was held at that instant. A touch without
the lock is a **violation** — detected deterministically on the first
unguarded access, no race timing required, even in a single-threaded
test (which is what makes it CI-able: strip the lock from one call path
and ``assert_clean()`` fails every run, not one run in fifty).

The tracer journals its own lifecycle into the recorder it audits
(``thread_audit`` events): ``action="arm"`` before the wrap
(so the event itself is recorded untraced) and ``action="disarm"``
after the restore, carrying the audit tallies. An audited run is thus
self-describing — a journal shard shows when the sanitizer was on.

Scope: the tracer audits the recorder's internal mutable state.
``_seq`` is a rebound ``int`` rather
than a mutated object, so it cannot be wrapped the same way; ``_ring``
and ``_counts`` are touched by every mutation path that touches
``_seq``, so coverage is not reduced. Tracing costs one dict append per
access — use in tests, not in steady-state loops.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, List, Optional

from mpi_grid_redistribute_tpu_torch.telemetry.recorder import StepRecorder


@dataclasses.dataclass(frozen=True)
class ThreadAccess:
    """One audited touch of a traced field."""

    thread_id: int
    thread_name: str
    label: str      # which traced object ("recorder" by default)
    field: str      # "_ring" | "_counts" | "_lock"
    op: str         # "read" | "write" | "acquire" | "release"
    lock_held: bool  # recorder lock owned by the touching thread

    @property
    def is_violation(self) -> bool:
        return self.op in ("read", "write") and not self.lock_held


class _TracedLock:
    """Wraps the recorder's ``threading.Lock`` to track which thread
    owns it (stdlib ``Lock`` has no owner concept; RLock's ``_is_owned``
    is private). Drop-in for ``with``/``acquire``/``release``/
    ``locked``."""

    def __init__(self, inner, tracer: "ThreadAccessTracer"):
        self._inner = inner
        self._tracer = tracer
        self._owner: Optional[int] = None

    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()

    def acquire(self, *args, **kwargs) -> bool:
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._owner = threading.get_ident()
            self._tracer._note("_lock", "acquire", True)
        return got

    def release(self) -> None:
        self._tracer._note("_lock", "release", True)
        self._owner = None
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _TracedDeque(collections.deque):
    """Ring-buffer proxy: every mutation/read is audited. Built as a
    real ``deque`` subclass so ``maxlen`` eviction semantics (the whole
    point of the ring) are inherited, not re-implemented."""

    def __init__(self, items, maxlen, tracer):
        super().__init__(items, maxlen)
        self._tracer = tracer

    def append(self, item):
        self._tracer._note("_ring", "write")
        super().append(item)

    def appendleft(self, item):
        self._tracer._note("_ring", "write")
        super().appendleft(item)

    def clear(self):
        self._tracer._note("_ring", "write")
        super().clear()

    def __iter__(self):
        self._tracer._note("_ring", "read")
        return super().__iter__()

    def __len__(self):
        self._tracer._note("_ring", "read")
        return super().__len__()

    def __getitem__(self, i):
        self._tracer._note("_ring", "read")
        return super().__getitem__(i)


class _TracedDict(dict):
    """Counts proxy: mutators and readers audited. ``clear()`` keeps
    object identity, matching ``StepRecorder.clear``'s contract of
    mutating (never rebinding) ``_counts``."""

    def __init__(self, items, tracer):
        super().__init__(items)
        self._tracer = tracer

    def __setitem__(self, k, v):
        self._tracer._note("_counts", "write")
        super().__setitem__(k, v)

    def __delitem__(self, k):
        self._tracer._note("_counts", "write")
        super().__delitem__(k)

    def clear(self):
        self._tracer._note("_counts", "write")
        super().clear()

    def update(self, *a, **kw):
        self._tracer._note("_counts", "write")
        super().update(*a, **kw)

    def get(self, k, default=None):
        self._tracer._note("_counts", "read")
        return super().get(k, default)

    def __getitem__(self, k):
        self._tracer._note("_counts", "read")
        return super().__getitem__(k)

    def items(self):
        self._tracer._note("_counts", "read")
        return super().items()

    def keys(self):
        self._tracer._note("_counts", "read")
        return super().keys()

    def values(self):
        self._tracer._note("_counts", "read")
        return super().values()


class ThreadAccessTracer:
    """Field-level runtime sanitizer for one :class:`StepRecorder`.

    Usage (the fault-matrix tests wrap whole scenario replays)::

        tracer = ThreadAccessTracer(rd.telemetry)
        with tracer:
            ...drive steps / snapshots / scrapes concurrently...
        tracer.assert_clean()

    ``violations()`` returns every journal-state touch made without the
    recorder lock; with the shipped locked recorder it is empty no
    matter how the threads interleave, and it is NON-empty on the first
    step if any mutation path loses its ``with self._lock``: a
    deterministic regression tripwire.
    """

    def __init__(self, recorder: StepRecorder, label: str = "recorder"):
        self.recorder = recorder
        self.label = label
        self._accesses: List[ThreadAccess] = []
        self._audit_lock = threading.Lock()
        self._armed = False
        self._muted = False  # True while arm/disarm touch traced state
        self._orig_lock = None
        self._orig_ring = None
        self._orig_counts = None
        self._traced_lock: Optional[_TracedLock] = None

    # called by the traced wrappers on every touch
    def _note(self, field: str, op: str, lock_op: bool = False) -> None:
        if self._muted:
            return
        held = (
            lock_op
            or (
                self._traced_lock is not None
                and self._traced_lock.held_by_me()
            )
        )
        t = threading.current_thread()
        acc = ThreadAccess(
            thread_id=threading.get_ident(),
            thread_name=t.name,
            label=self.label,
            field=field,
            op=op,
            lock_held=held,
        )
        with self._audit_lock:
            self._accesses.append(acc)

    def arm(self) -> "ThreadAccessTracer":
        if self._armed:
            return self
        rec = self.recorder
        # journal BEFORE wrapping: the arm event itself goes through the
        # untraced path, so access tallies start at zero
        rec.record("thread_audit", action="arm", label=self.label)
        self._orig_lock = rec._lock
        self._orig_ring = rec._ring
        self._orig_counts = rec._counts
        self._traced_lock = _TracedLock(rec._lock, self)
        rec._lock = self._traced_lock
        rec._ring = _TracedDeque(
            self._orig_ring, self._orig_ring.maxlen, self
        )
        rec._counts = _TracedDict(self._orig_counts, self)
        self._armed = True
        return self

    def disarm(self) -> "ThreadAccessTracer":
        if not self._armed:
            return self
        rec = self.recorder
        # restore first (carrying state mutated while traced), then
        # journal the tallies through the untraced path; the copy-back
        # reads the traced wrappers, so mute the audit around it
        self._muted = True
        try:
            self._orig_ring.clear()
            self._orig_ring.extend(rec._ring)
            self._orig_counts.clear()
            self._orig_counts.update(rec._counts)
            rec._lock = self._orig_lock
            rec._ring = self._orig_ring
            rec._counts = self._orig_counts
        finally:
            self._muted = False
        self._armed = False
        rec.record(
            "thread_audit",
            action="disarm",
            label=self.label,
            accesses=len(self._accesses),
            violations=len(self.violations()),
            threads=len({a.thread_id for a in self._accesses}),
        )
        return self

    def __enter__(self) -> "ThreadAccessTracer":
        return self.arm()

    def __exit__(self, *exc) -> bool:
        self.disarm()
        return False

    @property
    def accesses(self) -> List[ThreadAccess]:
        with self._audit_lock:
            return list(self._accesses)

    def violations(self) -> List[ThreadAccess]:
        return [a for a in self.accesses if a.is_violation]

    def by_thread(self) -> Dict[str, int]:
        """Access count per thread name: the observed thread topology."""
        out: Dict[str, int] = {}
        for a in self.accesses:
            out[a.thread_name] = out.get(a.thread_name, 0) + 1
        return out

    def assert_clean(self) -> None:
        v = self.violations()
        if v:
            lines = "\n".join(
                f"  {a.thread_name}({a.thread_id}): {a.label}."
                f"{a.field} {a.op} WITHOUT the recorder lock"
                for a in v[:10]
            )
            raise AssertionError(
                f"{len(v)} unguarded journal-state access(es) "
                f"detected by ThreadAccessTracer:\n{lines}"
            )
