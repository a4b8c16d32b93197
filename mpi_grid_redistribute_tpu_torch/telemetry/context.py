"""Causal step context: thread-local attribution for journal events (the
port's copy of the JAX package's ``telemetry/context.py``).

Every ``StepRecorder`` event answers *what* happened; this module makes
the envelope answer *on whose behalf*. A :class:`StepContext` is a tiny
host-side record (trace id, step index, redistribute call index, restart
attempt, origin thread) that the recorder merges into every event it
journals while the context is active on the recording thread
(``recorder._record_locked`` calls :func:`envelope_fields`).

Contexts are immutable and cheap: the envelope dict is precomputed at
construction. Payload keys always win over context keys, so an event
that already carries ``step`` / ``attempt`` is never clobbered; the
context rides along under the ``trace`` / ``ctx_*`` names of the JAX
package's ``telemetry/SCHEMA.md``.

Propagation is explicit: thread-locals do not cross threads, so code
handing work to another thread captures :func:`current` and activates a
:meth:`StepContext.child` on the other side. Children inherit the trace
id.

This module imports neither torch nor numpy.
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, Optional

__all__ = [
    "StepContext",
    "activate",
    "current",
    "current_trace",
    "envelope_fields",
    "new_trace_id",
    "scoped",
    "use",
]

# Sentinel distinguishing "not passed" from an explicit None override in
# StepContext.child (child(step=None) clears the field; child() keeps it).
_UNSET = object()


def new_trace_id() -> str:
    """A fresh 12-hex-digit trace id (random; inject ids for tests)."""
    return uuid.uuid4().hex[:12]


class StepContext:
    """Immutable attribution record merged into journal envelopes.

    Fields:
      trace    correlation id shared by every event of one logical run
               (supervised run, demo loop, test); children inherit it.
      step     1-based simulation step the work belongs to, or None.
      call     ``GridRedistributor`` redistribute-call index, or None.
      attempt  supervisor restart attempt (0 = first), or None.
      origin   logical name of the thread/component that activated the
               context (defaults to the current thread's name).
    """

    __slots__ = ("trace", "step", "call", "attempt", "origin", "_envelope")

    def __init__(
        self,
        trace: Optional[str] = None,
        step: Optional[int] = None,
        call: Optional[int] = None,
        attempt: Optional[int] = None,
        origin: Optional[str] = None,
    ):
        object.__setattr__(
            self, "trace", new_trace_id() if trace is None else str(trace)
        )
        object.__setattr__(self, "step", None if step is None else int(step))
        object.__setattr__(self, "call", None if call is None else int(call))
        object.__setattr__(
            self, "attempt", None if attempt is None else int(attempt)
        )
        object.__setattr__(
            self,
            "origin",
            threading.current_thread().name if origin is None else str(origin),
        )
        env: Dict[str, object] = {"trace": self.trace}
        if self.step is not None:
            env["ctx_step"] = self.step
        if self.call is not None:
            env["ctx_call"] = self.call
        if self.attempt is not None:
            env["ctx_attempt"] = self.attempt
        env["ctx_origin"] = self.origin
        object.__setattr__(self, "_envelope", env)

    def __setattr__(self, name, value):
        raise AttributeError("StepContext is immutable; use child()")

    def envelope(self) -> Dict[str, object]:
        """The envelope fields this context contributes (do not mutate)."""
        return self._envelope

    def child(
        self,
        step=_UNSET,
        call=_UNSET,
        attempt=_UNSET,
        origin=_UNSET,
    ) -> "StepContext":
        """A derived context sharing this trace, with fields overridden.

        Unpassed fields are inherited; an explicit ``None`` clears the
        field (``origin=None`` re-derives from the current thread, which
        is what a cross-thread handoff usually wants).
        """
        return StepContext(
            trace=self.trace,
            step=self.step if step is _UNSET else step,
            call=self.call if call is _UNSET else call,
            attempt=self.attempt if attempt is _UNSET else attempt,
            origin=self.origin if origin is _UNSET else origin,
        )

    def __repr__(self) -> str:
        parts = [f"trace={self.trace!r}"]
        for name in ("step", "call", "attempt"):
            v = getattr(self, name)
            if v is not None:
                parts.append(f"{name}={v}")
        parts.append(f"origin={self.origin!r}")
        return f"StepContext({', '.join(parts)})"


_tls = threading.local()


def current() -> Optional[StepContext]:
    """The context active on this thread, or None."""
    return getattr(_tls, "ctx", None)


def current_trace() -> Optional[str]:
    """The active trace id on this thread, or None."""
    ctx = getattr(_tls, "ctx", None)
    return None if ctx is None else ctx.trace


def envelope_fields() -> Optional[Dict[str, object]]:
    """Envelope dict of the active context, or None. Recorder fast path.

    Callers treat the result as read-only — it is the context's own
    precomputed dict, not a copy.
    """
    ctx = getattr(_tls, "ctx", None)
    return None if ctx is None else ctx._envelope


def activate(ctx: Optional[StepContext]) -> Optional[StepContext]:
    """Make ``ctx`` this thread's active context; returns the previous one.

    Prefer the :class:`use` / :func:`scoped` context managers, which
    restore the previous context on exit even when the body raises.
    """
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


class use:
    """``with use(ctx): ...`` — activate ``ctx``, restore the previous
    context on exit (exception-safe). Reentrant and nestable."""

    def __init__(self, ctx: Optional[StepContext]):
        self._ctx = ctx
        self._prev: Optional[StepContext] = None

    def __enter__(self) -> Optional[StepContext]:
        self._prev = activate(self._ctx)
        return self._ctx

    def __exit__(self, exc_type, exc, tb) -> bool:
        _tls.ctx = self._prev
        return False


def scoped(**fields) -> use:
    """A :class:`use` over a child of the active context (or a fresh
    root when none is active), with ``fields`` overriding.

    The common one-liner for per-step / per-call scoping::

        with context.scoped(step=step):
            ... journal events carry ctx_step=step ...
    """
    cur = getattr(_tls, "ctx", None)
    ctx = cur.child(**fields) if cur is not None else StepContext(**fields)
    return use(ctx)
