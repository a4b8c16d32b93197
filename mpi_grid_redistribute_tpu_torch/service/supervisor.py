"""Supervised restart for the service driver (the JAX package's
``service/supervisor.py``).

The :class:`Supervisor` owns the restart policy the driver must not
know about: it builds a fresh :class:`~.driver.ServiceDriver` per
attempt from a caller-supplied factory, restores it from the latest
valid snapshot, runs it, and decides what a failure means:

* an exception out of ``run()`` (injected crash, watchdog
  :class:`~.faults.StallError`, snapshot-write error) -> restart;
* a clean completion whose ``/healthz`` answers 503 (ALERT) -> also a
  failure;
* too many restarts inside a sliding window -> the circuit breaker
  trips and the supervisor gives up (``gave_up=True``; CLI exit code 3);
* ``shrink_after`` consecutive :class:`~.faults.SLOBreachError` failures
  -> the next attempt is built on :func:`..parallel.mesh.shrink_shape`
  of the current grid (journaled ``restart`` with ``action="shrink"``),
  and the driver's elastic restore re-shards the snapshot onto it.

Between restarts it sleeps a bounded exponential backoff with seeded
jitter (``sleep_fn``/``clock`` are injectable for tests). Every decision
is journaled as a ``restart`` event in the recorder shared across
attempts.
"""

from __future__ import annotations

# gridlint: service-path

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np

from mpi_grid_redistribute_tpu_torch.telemetry import StepRecorder
from mpi_grid_redistribute_tpu_torch.telemetry import context as context_lib


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """Knobs of the restart decision (README "Service mode")."""

    max_restarts: int = 5      # breaker: give up at this many in window
    window_s: float = 300.0    # sliding window the breaker counts over
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    jitter: float = 0.25       # backoff *= 1 + jitter*U[0,1)
    seed: int = 0              # jitter stream (deterministic schedules)
    # grid-shrink policy: after this many CONSECUTIVE
    # SLO-breach failures, restart onto shrink_shape(grid) — the mesh
    # cannot hold the SLO, so stop thrashing restarts and re-shard onto
    # fewer vranks. 0 = never; needs a driver_factory accepting an
    # optional grid_shape kwarg.
    shrink_after: int = 0

    def backoff_s(self, attempt: int, rng: np.random.Generator) -> float:
        base = min(
            self.backoff_cap_s, self.backoff_base_s * (2.0 ** attempt)
        )
        return base * (1.0 + self.jitter * float(rng.random()))


class SupervisorVerdict(NamedTuple):
    """Terminal outcome of a supervised run."""

    ok: bool
    restarts: int
    gave_up: bool
    reason: str        # "" on success; last failure / breaker message
    step: int          # driver step at exit
    health: str        # final /healthz status string (OK/WARN/ALERT)


class Supervisor:
    """Run a driver factory to completion through restarts.

    ``driver_factory`` must return a FRESH driver per call, all sharing
    one recorder (so the journal spans the incident) and, in tests, one
    fault plan (so already-fired injectors stay fired across restarts).
    ``sleep_fn``/``clock`` are injectable for deterministic tests.
    """

    def __init__(
        self,
        driver_factory: Callable[[], "ServiceDriver"],
        policy: Optional[RestartPolicy] = None,
        recorder: Optional[StepRecorder] = None,
        sleep_fn: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.driver_factory = driver_factory
        self.policy = policy if policy is not None else RestartPolicy()
        self._recorder = recorder
        self.sleep_fn = sleep_fn
        self.clock = clock
        self.driver = None  # last driver instance (final state lives here)

    @property
    def recorder(self) -> StepRecorder:
        if self._recorder is None:
            # adopt the factory's recorder so restart events land in the
            # same journal as the driver's snapshot/fault events
            self._recorder = self.driver.recorder if self.driver is not None \
                else self.driver_factory().recorder
        return self._recorder

    def run(self) -> SupervisorVerdict:
        policy = self.policy
        rng = np.random.default_rng(policy.seed)
        restart_times: List[float] = []
        attempt = 0
        breaches = 0          # CONSECUTIVE SLO-breach failures
        grid_override = None  # set once the shrink policy fires
        # one causal trace spans the whole supervised incident; each
        # attempt runs under a child context carrying ctx_attempt, so
        # every journal line — including this loop's restart decisions —
        # names the restart generation it belongs to (telemetry/context)
        root = context_lib.current()
        if root is None:
            root = context_lib.StepContext(
                trace=f"sup-{policy.seed:08x}", origin="supervisor"
            )
        while True:
            with context_lib.use(
                root.child(attempt=attempt, origin="supervisor")
            ):
                if grid_override is None:
                    driver = self.driver_factory()
                else:
                    driver = self.driver_factory(grid_shape=grid_override)
                self.driver = driver
                if self._recorder is None:
                    self._recorder = driver.recorder
                failure: Optional[str] = None
                try:
                    if not driver.restore_latest():
                        driver.init_state()
                    driver.run()
                    driver.close()
                except Exception as e:
                    failure = f"{type(e).__name__}: {e}"
                    note = driver.abandon()
                    if note is not None:
                        failure = f"{failure} ({note})"
                if failure is None:
                    code, verdict = driver.healthz()
                    if code == 503:
                        # a clean exit with an ALERTing health verdict is
                        # a failure: restart, let recovery clear the alert
                        reasons = "; ".join(
                            f["reason"] for f in verdict["findings"]
                            if f["severity"] == "ALERT"
                        )
                        failure = f"healthz 503: {reasons or 'ALERT'}"
                    else:
                        return SupervisorVerdict(
                            ok=True, restarts=attempt, gave_up=False,
                            reason="", step=driver.step,
                            health=verdict["status"],
                        )
                # SLOBreachError failures feed the shrink policy; any
                # other failure mode resets the consecutive-breach count
                # (a crash between breaches is not evidence the MESH is
                # too slow)
                if "SLOBreachError" in failure:
                    breaches += 1
                else:
                    breaches = 0
                now = self.clock()
                restart_times = [
                    t for t in restart_times if now - t <= policy.window_s
                ]
                if len(restart_times) >= policy.max_restarts:
                    reason = (
                        f"circuit breaker: {len(restart_times)} restarts "
                        f"in {policy.window_s:.0f}s window "
                        f"(last: {failure})"
                    )
                    self.recorder.record(
                        "restart", action="give_up", attempt=attempt,
                        reason=reason, step=driver.step,
                    )
                    # the breaker verdict must not leave the daemon
                    # snapshot writer running behind it: the failing
                    # driver was closed or abandoned above, but a
                    # restore/teardown path that re-armed the writer
                    # would otherwise escape here
                    if driver._writer is not None:
                        driver.abandon()
                    _, verdict = driver.healthz()
                    return SupervisorVerdict(
                        ok=False, restarts=attempt, gave_up=True,
                        reason=reason, step=driver.step,
                        health=verdict["status"],
                    )
                if policy.shrink_after and breaches >= policy.shrink_after:
                    from mpi_grid_redistribute_tpu_torch.parallel import (
                        mesh as mesh_lib,
                    )

                    old = tuple(driver.cfg.grid_shape)
                    new = mesh_lib.shrink_shape(old)
                    if new != old:
                        self.recorder.record(
                            "restart", action="shrink", attempt=attempt,
                            reason=failure, old_grid=list(old),
                            new_grid=list(new), step=driver.step,
                        )
                        grid_override = new
                        breaches = 0
                backoff = policy.backoff_s(attempt, rng)
                self.recorder.record(
                    "restart", action="restart", attempt=attempt,
                    reason=failure, backoff_s=backoff, step=driver.step,
                )
                self.sleep_fn(backoff)
                restart_times.append(self.clock())
                attempt += 1
