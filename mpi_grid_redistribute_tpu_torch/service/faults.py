"""Deterministic fault injection for the service loop (the JAX
package's ``service/faults.py``).

Every failure mode the supervisor claims to survive has an injector
here. Injectors are plain objects with ``before_step(driver)`` /
``after_snapshot(driver, path)`` hooks the
:class:`~.driver.ServiceDriver` calls at fixed points; a
:class:`FaultPlan` is an ordered bag of them. Plans are deterministic:
an injector fires at an explicit step (or snapshot ordinal), and
:meth:`FaultPlan.seeded` derives those steps from a seed with
``np.random.default_rng``, the reference's generator, so a seed gives
the reference's schedule.

Each injection journals a ``fault_injected`` event *before* the damage,
so the journal explains what the recovery events that follow recover
from. The eight injectors:

* :class:`CrashFault`: raise :class:`InjectedCrash` (or ``os._exit``
  with ``hard=True``); ``step=None`` crashes every run, the crash loop
  that must trip the supervisor's circuit breaker;
* :class:`TornSnapshotFault`: corrupt a committed snapshot shard on
  disk, then crash, so the restore must skip it;
* :class:`StallFault`: sleep through the watchdog budget
  (:class:`StallError`);
* :class:`JournalShardLossFault`: delete the exported journal shard; the
  next export heals it (``restore`` with ``what="journal"``);
* :class:`FallbackFloodFault`: journal dense-fallback ``fast_path``
  events until the driver degrades ``engine -> planar`` once;
* :class:`LatencySpikeFault`: journal slow ``step_latency`` events until
  the ``slo_latency_p99`` rule raises :class:`SLOBreachError`;
* :class:`StateCorruptionFault`: write NaN into live position rows of
  the state (the device tensor on the torch backend); armed probes must
  catch it before the next snapshot (:class:`StateCorruptionError`);
* :class:`DeviceLossFault`: answer the restore-time ``device_budget``
  query with fewer survivors, forcing a shrink-to-fit re-shard.
"""

from __future__ import annotations

# gridlint: service-path

import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch


class InjectedCrash(RuntimeError):
    """A deliberate mid-step process failure from :class:`CrashFault`."""


class StallError(RuntimeError):
    """A step exceeded the driver's watchdog budget (stalled step is a
    failure, not a wait — the supervisor restarts from snapshot)."""


class SLOBreachError(RuntimeError):
    """The driver's health check found a sustained SLO breach (p99
    step-latency or dropped-rows over the configured window). Raised out
    of the run loop so the supervisor treats it as a restartable failure
    — and, on repeat, as the trigger for a mesh shrink."""


#: Health rules whose ALERT the state-health boundary gate converts into
#: a :class:`StateCorruptionError` (rules of ``telemetry/health.py``).
_STATE_RULES = ("nan_detected", "conservation_drift", "bounds_violation")


class StateCorruptionError(RuntimeError):
    """An armed state-health probe (``DriverConfig.probes``) found
    corruption — NaN/Inf components, out-of-bounds positions, or a
    nonzero conservation residual — in the particle state. Raised at the
    chunk boundary BEFORE the snapshot hook, so the newest snapshot
    always predates the corruption and the supervisor's restore rolls
    the damage back instead of faithfully preserving it. Restartable,
    like :class:`SLOBreachError`, but never feeds the shrink policy:
    corrupt state is not a capacity problem."""


class CrashFault:
    """Crash at ``step`` (``None`` = every run: the crash-loop case).

    ``hard=True`` exits the process with ``os._exit(exit_code)`` — the
    subprocess kill path (the CLI's ``--hard-crash``); the default
    raises :class:`InjectedCrash` for in-process supervision tests.
    """

    kind = "crash"

    def __init__(self, step: Optional[int], hard: bool = False,
                 exit_code: int = 13):
        self.step = None if step is None else int(step)
        self.hard = bool(hard)
        self.exit_code = int(exit_code)
        self.fired = False

    def before_step(self, driver) -> None:
        if self.step is not None and (self.fired or driver.step != self.step):
            return
        self.fired = True
        driver.recorder.record(
            "fault_injected", fault=self.kind, step=driver.step,
            hard=self.hard,
        )
        if self.hard:
            os._exit(self.exit_code)
        raise InjectedCrash(f"injected crash at step {driver.step}")

    def next_step(self, step: int) -> Optional[int]:
        if self.step is None:
            return step  # crash-loop: may fire at any step
        if self.fired or self.step < step:
            return None
        return self.step


class StallFault:
    """Sleep ``seconds`` inside step ``step`` — longer than the driver's
    watchdog budget, so the step is *treated as a failure* (the watchdog
    raises :class:`StallError` after the step completes late)."""

    kind = "stall"

    def __init__(self, step: int, seconds: float):
        self.step = int(step)
        self.seconds = float(seconds)
        self.fired = False

    def before_step(self, driver) -> None:
        if self.fired or driver.step != self.step:
            return
        self.fired = True
        driver.recorder.record(
            "fault_injected", fault=self.kind, step=driver.step,
            seconds=self.seconds,
        )
        time.sleep(self.seconds)

    def next_step(self, step: int) -> Optional[int]:
        if self.fired or self.step < step:
            return None
        return self.step


class TornSnapshotFault:
    """Corrupt one shard of the ``snapshot_index``-th committed snapshot
    (0-based), then crash on the next step.

    The atomic publish in ``utils/checkpoint.py`` makes torn *writes*
    impossible, so this models at-rest corruption (bit rot, partial
    disk failure) of an already-committed snapshot: the shard file is
    truncated in place. The supervisor's restore must then skip the
    corrupt snapshot (checksum mismatch) and fall back to the previous
    valid one — defaulting to index 1 so a valid index-0 snapshot
    exists to fall back to.
    """

    kind = "torn_snapshot"

    def __init__(self, snapshot_index: int = 1, shard: int = 0):
        self.snapshot_index = int(snapshot_index)
        self.shard = int(shard)
        self.fired = False
        self._seen = 0
        self._crash_pending = False

    def after_snapshot(self, driver, path: str) -> None:
        ordinal = self._seen
        self._seen += 1
        if self.fired or ordinal != self.snapshot_index:
            return
        self.fired = True
        driver.join_snapshot_writer()  # corrupt the COMMITTED bytes
        shard_path = os.path.join(path, f"shard_{self.shard:05d}.npz")
        size = os.path.getsize(shard_path)
        with open(shard_path, "r+b") as f:
            f.truncate(max(1, size // 2))
        driver.recorder.record(
            "fault_injected", fault=self.kind, step=driver.step,
            path=shard_path,
        )
        self._crash_pending = True

    def before_step(self, driver) -> None:
        if self._crash_pending:
            self._crash_pending = False
            raise InjectedCrash(
                f"injected crash after torn snapshot at step {driver.step}"
            )

    def next_step(self, step: int) -> Optional[int]:
        return step if self._crash_pending else None


class JournalShardLossFault:
    """Delete the driver's exported journal shard at ``step``. The next
    journal export must notice the loss and re-export the retained
    window (journaled as ``restore`` with ``what="journal"``) — shard
    loss heals, it never silently truncates history."""

    kind = "journal_loss"

    def __init__(self, step: int):
        self.step = int(step)
        self.fired = False

    def before_step(self, driver) -> None:
        if self.fired or driver.step != self.step:
            return
        path = driver.journal_path
        if path is None or not os.path.exists(path):
            return  # nothing exported yet: keep waiting past self.step
        self.fired = True
        driver.recorder.record(
            "fault_injected", fault=self.kind, step=driver.step, path=path,
        )
        os.remove(path)

    def next_step(self, step: int) -> Optional[int]:
        # may keep waiting past self.step until a shard exists to delete
        if self.fired:
            return None
        return max(step, self.step)


class FallbackFloodFault:
    """Journal ``steps`` synthetic dense-fallback ``fast_path`` events
    starting at ``start_step`` — the signature of an undersized
    ``mover_cap`` (or a workload that stopped being mover-sparse). The
    ``fast_path_fallback`` health rule must WARN and the driver must
    degrade ``engine -> planar`` exactly once (journaled ``degrade``),
    instead of flapping between engines."""

    kind = "fallback_flood"

    def __init__(self, start_step: int, steps: int = 24):
        self.start_step = int(start_step)
        self.steps = int(steps)
        self.fired = False

    def before_step(self, driver) -> None:
        if not self.start_step <= driver.step < self.start_step + self.steps:
            return
        if not self.fired:
            self.fired = True
            driver.recorder.record(
                "fault_injected", fault=self.kind, step=driver.step,
                steps=self.steps,
            )
        driver.recorder.record(
            "fast_path", step=driver.step, taken=0, movers=0,
        )

    def next_step(self, step: int) -> Optional[int]:
        if step >= self.start_step + self.steps:
            return None
        return max(step, self.start_step)


class LatencySpikeFault:
    """Journal synthetic slow ``step_latency`` events (``seconds`` each)
    from ``start_step`` until a budget of ``spikes`` is spent — the
    signature of a mesh limping along (straggler device, contended
    host). The ``slo_latency_p99`` health rule must see the window p99
    blow through the SLO and raise :class:`SLOBreachError`; the
    supervisor restarts, and on repeated breach shrinks the mesh. The
    finite budget means the fault eventually clears, so the run proves
    recovery as well as detection."""

    kind = "latency_spike"

    def __init__(self, start_step: int, seconds: float = 1.0,
                 spikes: int = 8):
        self.start_step = int(start_step)
        self.seconds = float(seconds)
        self.spikes = int(spikes)
        self.fired = False
        self._left = int(spikes)

    def before_step(self, driver) -> None:
        if self._left <= 0 or driver.step < self.start_step:
            return
        if not self.fired:
            self.fired = True
            driver.recorder.record(
                "fault_injected", fault=self.kind, step=driver.step,
                seconds=self.seconds, spikes=self.spikes,
            )
        self._left -= 1
        driver.recorder.record(
            "step_latency", step=driver.step, seconds=self.seconds,
            dropped=0,
        )

    def next_step(self, step: int) -> Optional[int]:
        if self._left <= 0:
            return None
        return max(step, self.start_step)


class StateCorruptionFault:
    """NaN-burst the particle state at ``step``: overwrite
    the position components of the first ``rows`` LIVE rows of shard 0
    with NaN — silent data corruption (bad kernel, cosmic ray, host DMA
    fault) that no system-level signal catches. With
    ``DriverConfig.probes`` armed, the next ``state_health`` event must
    show a nonzero ``nan_pos`` count, the ``nan_detected`` rule must
    ALERT (freezing an incident bundle that names the step), and the
    boundary gate must raise :class:`StateCorruptionError` BEFORE the
    snapshot hook — so the supervisor restores a pre-corruption
    snapshot. The injector fires once (``fired``), so the restored
    attempt proves recovery instead of re-corrupting forever."""

    kind = "state_corruption"

    def __init__(self, step: int, rows: int = 4):
        if rows < 1:
            raise ValueError(f"rows must be >= 1, got {rows}")
        self.step = int(step)
        self.rows = int(rows)
        self.fired = False

    def before_step(self, driver) -> None:
        if self.fired or driver.step != self.step:
            return
        self.fired = True
        driver.recorder.record(
            "fault_injected", fault=self.kind, step=driver.step,
            rows=self.rows,
        )
        pos, vel, ids, count = driver.state
        k = min(self.rows, int(count[0]))
        # head rows of shard 0 are live (prefix layout); a fresh tensor or
        # array, so a snapshot copy taken earlier is never touched
        if isinstance(pos, torch.Tensor):
            pos = pos.clone()
            pos[:k] = float("nan")
        else:
            pos = np.array(pos, copy=True)
            pos[:k] = np.nan
        driver.state = (pos, vel, ids, count)

    def next_step(self, step: int) -> Optional[int]:
        if self.fired or self.step < step:
            return None
        return self.step


class DeviceLossFault:
    """On restart, the mesh reports only ``devices`` survivors (M < R).

    Consulted via the :meth:`device_budget` hook rather than a step
    hook: ``ServiceDriver.restore_latest`` asks the plan for a device
    budget before building its grid, and this injector answers with
    ``devices`` once the journal shows at least ``after_restarts``
    supervisor restarts — i.e. the device died WITH the crash, and every
    restore after it sees the smaller mesh. The driver must then
    shrink-to-fit the grid and re-shard the snapshot (journaled
    ``reshard``) instead of failing on the shape mismatch."""

    kind = "device_loss"

    def __init__(self, devices: int, after_restarts: int = 1):
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        self.devices = int(devices)
        self.after_restarts = int(after_restarts)
        self.fired = False

    def device_budget(self, driver) -> Optional[int]:
        counts = driver.recorder.counts()
        if counts.get("restart", 0) < self.after_restarts:
            return None
        if not self.fired:
            self.fired = True
            driver.recorder.record(
                "fault_injected", fault=self.kind, step=driver.step,
                devices=self.devices,
            )
        return self.devices


class FaultPlan:
    """An ordered bag of injectors the driver consults at its hooks."""

    def __init__(self, faults: Sequence[object] = ()):
        self.faults: List[object] = list(faults)

    def __bool__(self) -> bool:
        return bool(self.faults)

    def before_step(self, driver) -> None:
        for f in self.faults:
            hook = getattr(f, "before_step", None)
            if hook is not None:
                hook(driver)

    def after_snapshot(self, driver, path: str) -> None:
        for f in self.faults:
            hook = getattr(f, "after_snapshot", None)
            if hook is not None:
                hook(driver, path)

    def next_step(self, step: int) -> Optional[int]:
        """Earliest step >= ``step`` at which any ``before_step`` hook
        might act (``None`` = never again). The chunked driver bounds
        every resident macro-step with this so no fault step ever falls
        strictly inside a chunk — the deterministic fault matrix fires
        at exactly the same steps for every chunk size. An injector that
        has a ``before_step`` hook but no ``next_step`` probe answers
        ``step`` conservatively: the driver then runs it eagerly, one
        step per chunk, which is always correct."""
        nxt: Optional[int] = None
        for f in self.faults:
            if getattr(f, "before_step", None) is None:
                continue
            probe = getattr(f, "next_step", None)
            n = step if probe is None else probe(step)
            if n is not None and (nxt is None or n < nxt):
                nxt = n
        return nxt

    def device_budget(self, driver) -> Optional[int]:
        """Surviving-device count the mesh would report at restore time:
        the tightest answer across injectors (``None`` = full mesh)."""
        budget: Optional[int] = None
        for f in self.faults:
            hook = getattr(f, "device_budget", None)
            if hook is None:
                continue
            b = hook(driver)
            if b is not None and (budget is None or b < budget):
                budget = b
        return budget

    @classmethod
    def seeded(
        cls,
        seed: int,
        steps: int,
        kinds: Sequence[str] = (
            "crash", "stall", "torn_snapshot", "journal_loss",
            "fallback_flood",
        ),
        stall_seconds: float = 0.3,
    ) -> "FaultPlan":
        """Deterministic schedule: injection steps drawn (without
        replacement) from ``[1, steps)`` by a seeded generator — the
        same ``(seed, steps, kinds)`` always yields the same plan."""
        if steps < 2:
            raise ValueError(f"steps must be >= 2, got {steps}")
        rng = np.random.default_rng(seed)
        picks = rng.choice(
            np.arange(1, steps), size=min(len(kinds), steps - 1),
            replace=False,
        )
        faults: List[object] = []
        for kind, at in zip(kinds, picks):
            at = int(at)
            if kind == "crash":
                faults.append(CrashFault(at))
            elif kind == "stall":
                faults.append(StallFault(at, stall_seconds))
            elif kind == "torn_snapshot":
                faults.append(TornSnapshotFault())
            elif kind == "journal_loss":
                faults.append(JournalShardLossFault(at))
            elif kind == "fallback_flood":
                faults.append(FallbackFloodFault(at))
            elif kind == "latency_spike":
                faults.append(LatencySpikeFault(at))
            elif kind == "state_corruption":
                faults.append(StateCorruptionFault(at))
            elif kind == "device_loss":
                faults.append(DeviceLossFault(1))
            else:
                raise ValueError(f"unknown fault kind {kind!r}")
        return cls(faults)
