"""Programmatic profiler sessions over ``torch.profiler`` (the port's
counterpart of the JAX package's ``telemetry/profiler.py``).

:class:`ProfilerSession` is a context manager any driver can hold around
its hot region, gated by a directory (the argument, or the
``GRID_PROFILE_DIR`` environment variable, the reference's knob), and
journaled as a ``profile_session`` event so the capture is discoverable
from the journal alone (trace file, wall duration, whether the profiler
armed). It writes one Chrome trace (``<dir>/<label>.trace.json``),
which loads in Perfetto.

Profiling never takes the caller down: no directory disables the
session outright (nothing journaled); a profiler that fails to start or
stop degrades to a no-op that still journals the attempt with
``armed=False`` and the error.
"""

from __future__ import annotations

import os
import time
from typing import Optional

PROFILE_DIR_ENV = "GRID_PROFILE_DIR"


def profile_dir_from_env() -> Optional[str]:
    """The environment's knob (``GRID_PROFILE_DIR``); empty/unset = off."""
    d = os.environ.get(PROFILE_DIR_ENV, "").strip()
    return d or None


class ProfilerSession:
    """Gated ``torch.profiler`` session around a code region.

    ``with ProfilerSession(log_dir, recorder=rec, label="run"):`` — when
    ``log_dir`` is None the environment's knob is read; when both are
    unset the session is a no-op (``enabled`` False, nothing journaled).
    The CUDA activity is traced when a card is present."""

    def __init__(self, log_dir: Optional[str] = None, recorder=None,
                 label: str = "session"):
        self.log_dir = log_dir if log_dir else profile_dir_from_env()
        self.recorder = recorder
        self.label = label
        self.enabled = self.log_dir is not None
        self.armed = False
        self.error: Optional[str] = None
        self.trace_path: Optional[str] = None
        self._prof = None
        self._t0: Optional[float] = None

    def __enter__(self) -> "ProfilerSession":
        if not self.enabled:
            return self
        self._t0 = time.perf_counter()
        try:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self.armed = True
        except Exception as e:  # profiling unavailable: degrade, never die
            self.error = f"{type(e).__name__}: {e}"
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if not self.enabled:
            return False
        duration = time.perf_counter() - (self._t0 or time.perf_counter())
        if self.armed:
            try:
                self._prof.stop()
                path = os.path.join(self.log_dir, f"{self.label}.trace.json")
                self._prof.export_chrome_trace(path)
                self.trace_path = path
            except Exception as e:
                self.error = f"{type(e).__name__}: {e}"
                self.armed = False
        if self.recorder is not None:
            self.recorder.record(
                "profile_session",
                trace_dir=self.log_dir,
                label=self.label,
                duration_s=duration,
                armed=self.armed,
                error=self.error,
            )
        return False
