"""Long-running service driver: the drift -> redistribute loop as a
process (the JAX package's ``service/driver.py``).

:class:`ServiceDriver` owns the particle state, advances it through the
public :class:`~..api.GridRedistribute` step after step, and on a step
cadence:

* snapshots the particle state through :mod:`..utils.checkpoint`
  (atomic publish, a checksum a shard), by default on a background
  writer thread that writes host copies the loop made before it
  started;
* exports its journal as a per-process JSONL shard, detecting and
  healing a lost shard;
* evaluates the :class:`~..telemetry.health.HealthMonitor` rules,
  degrades ``engine -> planar`` once if ``fast_path_fallback`` fires,
  raises :class:`~.faults.SLOBreachError` on an SLO rule, and with
  ``rebalance`` runs the closed loop (ALERT -> plan -> guard -> one
  ``apply_assignment``);
* with ``store_dir``, drains the journal ring into a durable
  :class:`~..telemetry.store.JournalStore` at every chunk boundary; with
  ``incident_dir``, freezes an incident bundle
  (:mod:`..telemetry.incident`) on every ALERT and injected fault.

A wall-clock watchdog turns a stalled step into a
:class:`~.faults.StallError`, a failure the supervisor restarts from a
snapshot. Every transition is journaled (``snapshot`` / ``restore`` /
``reshard`` / ``degrade`` / ``rebalance``), with the reference's event
kinds and fields.

Where the state lives. On the ``"torch"`` backend the state is four
tensors on the driver's device (``DriverConfig.device``; ``None`` means
the GPU and raises without one) and stays there: a step drifts on the
device (:func:`~..models.nbody.eager_drift`, NumPy's ``%`` arithmetic,
the reference's host drift) and runs one ``redistribute()``, whose
engine reads back only the call's drop counters and needs (one host read
a step, ``read_every_call``) and so heals a drop in the step that made
it, where the reference's deferred window would only report it. The
reference's
eager loop instead pulls the whole state to the host every step; the
port copies it to the host only for a snapshot, ``--final-out`` and
:meth:`host_state`. The ``"numpy"`` backend is the meshless oracle loop
on host arrays, as in the reference.

Chunks. With ``chunk > 1`` the loop issues ``chunk`` steps at a time
(:func:`~.resident.make_chunk_fn`, or with ``pipeline``
:func:`~.pipeline.make_pipelined_chunk_fn`) with nothing read back
inside; the per-step observables (drop counters, needed capacity,
counts, probes) are copied into pinned host buffers without blocking,
behind a CUDA event recorded right after the chunk and before the next
one is issued, and the chunk's wall time is the device's, from an event
recorded at dispatch to that one (a chunk issued while its predecessor
still runs starts when the predecessor ends). When the next chunk has no
boundary work at its start it is issued before this one's host reads,
so journal work overlaps the device. A chunk that dropped rows is
discarded, with any chunk issued after it, and re-run eagerly after the
engine grows. The driver runs every rank as a vrank on one device; the
reference builds a device mesh when it sees enough devices.

CLI (``python -m mpi_grid_redistribute_tpu_torch.service``)::

    python -m mpi_grid_redistribute_tpu_torch.service --device cpu \\
        --grid 2,2,2 --steps 60 --snapshot-every 5 --snapshot-dir /tmp/snaps
"""

from __future__ import annotations

# gridlint: service-path

import dataclasses
import os
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch import _device
from mpi_grid_redistribute_tpu_torch.service.faults import (
    FaultPlan,
    StallError,
)
from mpi_grid_redistribute_tpu_torch.telemetry import StepRecorder
from mpi_grid_redistribute_tpu_torch.telemetry import context as context_lib
from mpi_grid_redistribute_tpu_torch.telemetry.health import HealthMonitor
from mpi_grid_redistribute_tpu_torch.telemetry.probes import (
    ProbeConfig,
    record_probe_steps,
    summarize_host,
)
from mpi_grid_redistribute_tpu_torch.telemetry.profiler import (
    ProfilerSession,
)
from mpi_grid_redistribute_tpu_torch.utils import checkpoint
from mpi_grid_redistribute_tpu_torch.utils.checkpoint import _host

BACKENDS = ("torch", "numpy")
_DTYPES = (np.float32, np.float32, np.int32, np.int32)
_TORCH_DTYPES = (torch.float32, torch.float32, torch.int32, torch.int32)


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    """Static configuration of one service run (hashable: two drivers
    built from the same config are interchangeable). The reference's
    fields and defaults, with ``backend`` ``"torch"`` | ``"numpy"`` and
    ``device`` added."""

    grid_shape: Tuple[int, ...] = (2, 2, 2)
    n_local: int = 4096       # padded rows per shard (state shape, fixed)
    # live fraction: the per-rank population is a bounded random walk
    # around uniform, so the headroom must cover several sigma of skew
    fill: float = 0.8
    steps: int = 64           # service horizon
    dt: float = 1.0
    seed: int = 0
    migration: float = 0.02   # ~fraction of live rows crossing a face/step
    backend: str = "torch"    # "torch" | "numpy" (the oracle; meshless)
    engine: str = "auto"
    snapshot_every: int = 0   # steps between snapshots; 0 = snapshots off
    snapshot_dir: Optional[str] = None
    keep_snapshots: int = 4   # retained snapshots (>= 2: torn-skip fallback)
    snapshot_async: bool = True
    journal_dir: Optional[str] = None
    watchdog_s: float = 0.0   # wall budget per step; 0 = watchdog off
    health_every: int = 0     # extra health cadence; 0 = at snapshots only
    step_sleep: float = 0.0   # pacing, so external kills land mid-run
    # steps issued a dispatch (service/resident.py); 1 = the eager loop;
    # chunks are split at every snapshot/health boundary and fault step
    chunk: int = 1
    # the software-pipelined chunk (service/pipeline.py); infeasible
    # schedules degrade to the sequential chunk, journaled
    pipeline: bool = False
    # state-health probe tier ("off" | "counters" | "moments"): one
    # state_health event a step, and corruption fails the next boundary
    # with StateCorruptionError before the snapshot hook
    probes: str = "off"
    # re-shard a snapshot whose layout differs from this config onto the
    # configured grid; off = ElasticRestoreError
    auto_reshard: bool = True
    # SLO rules; a breach raises SLOBreachError out of the run loop
    slo_latency_p99_s: float = 0.0   # p99 step-latency budget; 0 = off
    slo_dropped_p99: int = -1        # p99 dropped-rows budget; -1 = off
    slo_window: int = 16             # step_latency events per SLO window
    # the closed rebalance loop (telemetry/rebalance.py)
    rebalance: bool = False
    rebalance_on: Tuple[str, ...] = ("imbalance_ratio", "backlog_growth")
    rebalance_threshold: float = 2.0  # imbalance_ratio ALERT threshold
    rebalance_cells: int = 2          # fine cells per grid cell per axis
    rebalance_horizon: int = 256      # guard amortization horizon (steps)
    rebalance_cooldown: int = 64      # min steps between applied remaps
    rebalance_min_improvement: float = 0.05
    # one torch.profiler session a run() call (GRID_PROFILE_DIR too)
    profile_dir: Optional[str] = None
    # the incident flight recorder (telemetry/incident.py): every ALERT
    # finding, and every injected fault scanned at boundaries and close,
    # freezes a debounced bundle here; keyed on the shared journal, so
    # its debounce and counter survive supervisor restarts
    incident_dir: Optional[str] = None
    incident_debounce_s: float = 60.0  # per-rule bundle debounce window
    # the durable journal store (telemetry/store.py): the ring is drained
    # here at the end of every chunk (every step when eager) and at
    # close(), never inside a chunk; a restarted driver resumes from the
    # manifest's watermark
    store_dir: Optional[str] = None
    store_segment_events: int = 4096   # events per segment before rotation
    store_retain_bytes: int = 64 * 1024 * 1024  # closed-segment disk budget
    store_compact_after: int = 2       # newest raw segments kept uncompacted
    # multi-window burn-rate alerting over the SLO thresholds (alerting
    # only: no SLOBreachError)
    burn_rate_alerts: bool = False
    # the torch backend's device; None = the GPU (raises without one)
    device: Optional[str] = None


class ServiceDriver:
    """One supervised instance of the streaming loop.

    Lifecycle: ``restore_latest()`` (or ``init_state()``), ``run()``,
    ``close()``. The supervisor builds a fresh driver per restart from
    the same config and a shared recorder; all recovery state lives in
    snapshots and the journal, never in the object.
    """

    def __init__(
        self,
        cfg: DriverConfig,
        recorder: Optional[StepRecorder] = None,
        monitor: Optional[HealthMonitor] = None,
        faults: Optional[FaultPlan] = None,
    ):
        if cfg.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {cfg.backend!r}"
            )
        if cfg.snapshot_every and not cfg.snapshot_dir:
            raise ValueError("snapshot_every set but snapshot_dir is None")
        if cfg.snapshot_every and cfg.keep_snapshots < 2:
            raise ValueError(
                "keep_snapshots must be >= 2 so a corrupt newest snapshot "
                "always has a valid predecessor to fall back to"
            )
        self.cfg = cfg
        self.device = (_device.resolve(cfg.device)
                       if cfg.backend == "torch" else None)
        self.recorder = recorder if recorder is not None else StepRecorder()
        self.monitor = (
            monitor if monitor is not None else HealthMonitor(self.recorder)
        )
        self.faults = faults if faults is not None else FaultPlan()
        self.engine = cfg.engine
        self.degraded = False
        self.step = 0
        self.state = None
        self.journal_path: Optional[str] = None
        self._rd = None
        self._wall_ema: Optional[float] = None
        self._last_dropped = 0
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[str] = None
        # guards _writer_error: written by the snapshot-writer thread,
        # read-and-cleared (exactly once) by join_snapshot_writer
        self._writer_lock = threading.Lock()
        self._last_snapshot_path: Optional[str] = None
        # the live assignment-aware edges survive engine rebuilds (a
        # degrade that dropped them would undo the rebalance)
        self._edges = None
        self._planner = None
        self._guard = None
        # macro-step cache keyed on everything that changes the issued
        # program, and the host time the last chunk was retired
        self._chunk_cache = {}
        self._chunk_done: Optional[float] = None
        self._probes = ProbeConfig(tier=cfg.probes)
        self._state_breach = False
        self._install_slo_rules()
        self._install_rebalance_rule()
        self._flight = self._install_flight_recorder()
        self._store = self._install_store()

    def _install_slo_rules(self) -> None:
        # the monitor is SHARED across supervisor restarts: install by
        # rule name, never append a second copy
        from mpi_grid_redistribute_tpu_torch.telemetry import (
            health as health_lib,
        )

        cfg = self.cfg
        have = {r.name for r in self.monitor.rules}
        if cfg.slo_latency_p99_s > 0 and "slo_latency_p99" not in have:
            self.monitor.rules.append(
                health_lib.slo_latency_p99(
                    cfg.slo_latency_p99_s, window=cfg.slo_window
                )
            )
        if cfg.slo_dropped_p99 >= 0 and "slo_dropped_rows" not in have:
            self.monitor.rules.append(
                health_lib.slo_dropped_rows(
                    cfg.slo_dropped_p99, window=cfg.slo_window
                )
            )
        if not cfg.burn_rate_alerts:
            return
        slow = 4 * cfg.slo_window
        if cfg.slo_latency_p99_s > 0 and "burn_rate_latency" not in have:
            self.monitor.rules.append(
                health_lib.burn_rate_latency(
                    cfg.slo_latency_p99_s,
                    fast_window=cfg.slo_window,
                    slow_window=slow,
                )
            )
        if cfg.slo_dropped_p99 >= 0 and "burn_rate_dropped" not in have:
            self.monitor.rules.append(
                health_lib.burn_rate_dropped(
                    cfg.slo_dropped_p99,
                    fast_window=cfg.slo_window,
                    slow_window=slow,
                )
            )

    def _install_store(self):
        # one JournalStore per store root; a supervisor-restarted driver
        # re-opens the same root and the manifest's drain watermark (seq
        # against the SHARED recorder) keeps drains exactly-once
        if not self.cfg.store_dir:
            return None
        from mpi_grid_redistribute_tpu_torch.telemetry.store import (
            JournalStore,
        )

        return JournalStore(
            self.cfg.store_dir,
            segment_events=self.cfg.store_segment_events,
            retain_bytes=self.cfg.store_retain_bytes,
            compact_after=self.cfg.store_compact_after,
        )

    def _install_flight_recorder(self):
        # idempotent per shared recorder: a restarted driver re-registers
        # the SAME flight recorder on its fresh monitor, so debounce
        # clocks and the bundle counter survive the restart
        if not self.cfg.incident_dir:
            return None
        from mpi_grid_redistribute_tpu_torch.telemetry import (
            incident as incident_lib,
        )

        return incident_lib.install(
            self.monitor,
            self.recorder,
            self.cfg.incident_dir,
            debounce_s=self.cfg.incident_debounce_s,
        )

    def _install_rebalance_rule(self) -> None:
        # the stock WARN imbalance_ratio rule becomes an ALERT copy at the
        # actuation threshold (installed once on a shared monitor)
        from mpi_grid_redistribute_tpu_torch.telemetry import (
            health as health_lib,
        )

        cfg = self.cfg
        if not cfg.rebalance:
            return
        if any(
            r.name == "imbalance_ratio" and r.severity == health_lib.ALERT
            for r in self.monitor.rules
        ):
            return
        self.monitor.rules = [
            r for r in self.monitor.rules if r.name != "imbalance_ratio"
        ]
        self.monitor.rules.append(
            health_lib.imbalance_ratio(
                cfg.rebalance_threshold, severity=health_lib.ALERT
            )
        )

    # ---------------------------------------------------------- build

    @property
    def nranks(self) -> int:
        from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid

        return ProcessGrid(self.cfg.grid_shape).nranks

    def _ensure_built(self) -> None:
        if self._rd is not None:
            return
        from mpi_grid_redistribute_tpu_torch.api import GridRedistribute
        from mpi_grid_redistribute_tpu_torch.domain import (
            Domain,
            ProcessGrid,
        )

        cfg = self.cfg
        self._rd = GridRedistribute(
            Domain(0.0, 1.0, periodic=True),
            ProcessGrid(cfg.grid_shape),
            backend=cfg.backend,
            device=self.device,
            # capacity = n_local: the self-pair carries every resident row
            # in a drift regime, so anything smaller guarantees overflow
            capacity=cfg.n_local,
            on_overflow="grow",
            # the step's one host read is the engine's: every call's drop
            # counters, so a drop is healed in the step that made it
            read_every_call=True,
            engine=self.engine,
            # re-install the live assignment-aware edges across rebuilds
            edges=self._edges,
        )
        # one journal for the whole service: the engine's own events land
        # in the driver's ring next to snapshot/restore/fault events
        self._rd.telemetry = self.recorder
        self._rd.monitor = self.monitor
        self._chunk_cache.clear()  # macro fns close over the old engine

    # ---------------------------------------------------------- state

    def _to_state(self, pos, vel, ids, count):
        """The state tuple in the backend's form: tensors on the device
        (torch) or host arrays (numpy), float32/float32/int32/int32."""
        if self.cfg.backend == "numpy":
            return tuple(np.asarray(_host(a), t)
                         for a, t in zip((pos, vel, ids, count), _DTYPES))
        out = []
        for a, t in zip((pos, vel, ids, count), _TORCH_DTYPES):
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.ascontiguousarray(a))
            out.append(a.to(self.device, t))
        return tuple(out)

    def host_state(self) -> Tuple[np.ndarray, ...]:
        """Host copies of ``(pos, vel, ids, count)`` (reads the device)."""
        return tuple(_host(a) for a in self.state)

    def init_state(self) -> None:
        """Fresh seeded state (the reference's): rows pre-placed on their
        owning shard, velocities sized for ``cfg.migration``, every row a
        stable int32 id (its initial global slot), so the particle SET is
        identifiable across restarts and grid reshapes."""
        from mpi_grid_redistribute_tpu_torch.bench import common as bcommon

        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        v_scale, _, _ = bcommon.drift_sizing(
            cfg.grid_shape, cfg.n_local, cfg.fill, cfg.migration
        )
        pos, vel, _ = bcommon.uniform_state(
            cfg.grid_shape, cfg.n_local, 1.0, rng, vel_scale=v_scale
        )
        ids = np.arange(self.nranks * cfg.n_local, dtype=np.int32)
        count = np.full(
            (self.nranks,), int(cfg.fill * cfg.n_local), np.int32
        )
        self.state = self._to_state(pos, vel, ids, count)
        self.step = 0

    def restore_latest(self, grid_shape: Optional[Tuple[int, ...]] = None
                       ) -> bool:
        """Restore from the newest VALID snapshot (corrupt ones are
        skipped and the skip count journaled). Returns False when no valid
        snapshot exists (the caller falls back to :meth:`init_state`).

        ``grid_shape`` overrides the configured grid (the supervisor's
        shrink), and the fault plan's ``device_budget`` may report fewer
        devices than the target needs: the grid then shrinks to fit
        (:func:`..parallel.mesh.shrink_to_fit`). When the snapshot's
        ``(nranks, rows_per_shard)`` differs from the target, the state
        is re-sharded in one canonical redistribute on the host
        (:func:`.elastic.reshard_state`), the config rewritten to the new
        grid, and a ``reshard`` event journaled; with ``auto_reshard``
        off a mismatch raises :class:`~.elastic.ElasticRestoreError`
        naming both shapes."""
        from mpi_grid_redistribute_tpu_torch.service.elastic import (
            ElasticRestoreError,
        )

        cfg = self.cfg
        if not cfg.snapshot_dir:
            return False
        latest = checkpoint.load_latest(cfg.snapshot_dir)
        if latest is None:
            return False
        a = dict(latest.arrays)
        man = latest.manifest
        snap_r = int(man["nranks"])
        snap_rows = int(man["rows_per_shard"])
        snap_grid = (man.get("extra") or {}).get("grid_shape")
        snap_desc = (
            f"grid {tuple(snap_grid)}" if snap_grid
            else f"{snap_r} shards"
        ) + f" x {snap_rows} rows"
        if "ids" not in a:
            # a snapshot without ids: stable slot-index ids
            a["ids"] = np.arange(snap_r * snap_rows, dtype=np.int32)
        target = tuple(
            int(x) for x in (grid_shape or cfg.grid_shape)
        )
        budget = self.faults.device_budget(self)
        if budget is not None:
            from mpi_grid_redistribute_tpu_torch.parallel import (
                mesh as mesh_lib,
            )

            fit = mesh_lib.shrink_to_fit(target, budget)
            if fit != target and not cfg.auto_reshard:
                raise ElasticRestoreError(
                    f"snapshot {latest.path!r} ({snap_desc}) needs "
                    f"{int(np.prod(target))} devices for grid {target}, "
                    f"but the mesh reports only {budget} and "
                    f"auto_reshard is disabled"
                )
            target = fit
        same_layout = (
            target == tuple(cfg.grid_shape)
            and snap_r == self.nranks
            and snap_rows == cfg.n_local
        )
        if same_layout:
            self.state = self._to_state(a["pos"], a["vel"], a["ids"],
                                        a["count"])
        else:
            if not cfg.auto_reshard:
                raise ElasticRestoreError(
                    f"snapshot {latest.path!r} ({snap_desc}) does not "
                    f"match the configured grid {tuple(cfg.grid_shape)} "
                    f"x {cfg.n_local} rows and auto_reshard is disabled"
                )
            from mpi_grid_redistribute_tpu_torch.service.elastic import (
                reshard_state,
            )

            res = reshard_state(a, man, target)
            self.cfg = cfg = dataclasses.replace(
                cfg, grid_shape=target, n_local=res.n_local
            )
            self._rd = None  # rebuilt on the new grid at the next step
            out = res.arrays
            self.state = self._to_state(out["pos"], out["vel"], out["ids"],
                                        out["count"])
            self.recorder.record(
                "reshard",
                old_grid=list(snap_grid) if snap_grid else None,
                old_shards=snap_r,
                old_rows_per_shard=snap_rows,
                new_grid=list(target),
                new_rows_per_shard=res.n_local,
                rows=res.live_rows,
                moved=res.moved_rows,
                step=int(man["step"]),
                path=latest.path,
            )
        self.step = int(man["step"])
        self.recorder.record(
            "restore",
            what="state",
            step=self.step,
            path=latest.path,
            snapshots_skipped=latest.skipped,
        )
        return True

    # ------------------------------------------------------ snapshots

    def join_snapshot_writer(self) -> None:
        """Block until the in-flight snapshot write (if any) has
        committed; re-raise its failure, once."""
        t = self._writer
        if t is not None:
            t.join()
            self._writer = None
        # swap-and-clear under the lock so the error surfaces exactly once
        with self._writer_lock:
            err, self._writer_error = self._writer_error, None
        if err is not None:
            raise RuntimeError(f"async snapshot write failed: {err}")

    def snapshot(self) -> str:
        """Write one snapshot of the particle state; journal it. The host
        copies are made here, on the loop's thread, before the writer
        starts: a device tensor the next step overwrites never reaches
        the writer."""
        cfg = self.cfg
        step = self.step
        path = os.path.join(cfg.snapshot_dir, f"step_{step:08d}")
        pos, vel, ids, count = self.host_state()
        arrays = {"pos": pos, "vel": vel, "ids": ids, "count": count}
        extra = {
            "seed": cfg.seed,
            "engine": self.engine,
            "grid_shape": list(cfg.grid_shape),
        }
        # thread-locals don't cross the spawn: hand the writer a child of
        # the loop's context
        ctx = context_lib.current()
        wctx = (
            ctx.child(step=step, origin="snapshot-writer")
            if ctx is not None
            else None
        )

        def write() -> None:
            with context_lib.use(wctx):
                try:
                    checkpoint.save(
                        path, arrays, nranks=self.nranks, step=step,
                        extra=extra,
                    )
                except Exception as e:  # surfaced by join_snapshot_writer
                    with self._writer_lock:
                        self._writer_error = f"{type(e).__name__}: {e}"

        self.join_snapshot_writer()  # at most one write in flight
        cadence_s = float(cfg.snapshot_every) * float(self._wall_ema or 0.0)
        self.recorder.record(
            "snapshot",
            step=step,
            path=path,
            cadence_s=cadence_s,
            rows=int(count.sum()),
            asynchronous=bool(cfg.snapshot_async),
        )
        if cfg.snapshot_async:
            t = threading.Thread(target=write, daemon=True)
            self._writer = t
            t.start()
        else:
            write()
            self.join_snapshot_writer()
        self._last_snapshot_path = path
        self._prune_snapshots()
        self.export_journal()
        return path

    def _prune_snapshots(self) -> None:
        import shutil

        keep = self.cfg.keep_snapshots
        for path in checkpoint.list_snapshots(self.cfg.snapshot_dir)[keep:]:
            if path == self._last_snapshot_path:
                continue  # never the one just written (possibly in flight)
            shutil.rmtree(path)

    def export_journal(self) -> Optional[str]:
        """Export the retained journal window as this process's shard. A
        previously exported shard that vanished is detected here and
        healed by re-exporting, with a journaled ``restore``."""
        cfg = self.cfg
        if not cfg.journal_dir:
            return None
        os.makedirs(cfg.journal_dir, exist_ok=True)
        rec = self.recorder
        path = os.path.join(
            cfg.journal_dir, f"driver.{rec.host}.{rec.pid}.jsonl"
        )
        if self.journal_path is not None and not os.path.exists(
            self.journal_path
        ):
            rec.record("restore", what="journal", path=self.journal_path)
        rec.to_jsonl(path)
        self.journal_path = path
        return path

    # ------------------------------------------------------------ run

    def _advance(self, pos, vel, ids, count):
        """One eager step: drift, one redistribute, one host read of the
        dropped counters."""
        cfg = self.cfg
        if cfg.backend == "numpy":
            one = np.float32(1.0)
            pos = (pos + vel * np.float32(cfg.dt)) % one
            # float32 `%` can round a tiny negative up to exactly 1.0
            pos = np.where(pos >= one, pos - one, pos)
        else:
            from mpi_grid_redistribute_tpu_torch.models import nbody

            pos = nbody.eager_drift(pos, vel, cfg.dt)
        res = self._rd.redistribute(pos, vel, ids, count=count)
        if cfg.backend == "numpy":
            st = res.stats
            self._last_dropped = 0 if st is None else (
                int(np.asarray(st.dropped_send).sum())
                + int(np.asarray(st.dropped_recv).sum()))
        else:
            # read_every_call: the engine read this call's counters and
            # returns clean (grown and re-run) or raises
            self._last_dropped = 0
        return self._to_state(res.positions, res.fields[0], res.fields[1],
                              res.count)

    def _refresh_flow(self) -> None:
        # fold the latest stats into the flow gauge and journal a
        # flow_snapshot, so imbalance_ratio sees the CURRENT decomposition
        if self._rd is not None and self._rd._last_stats is not None:
            self._rd.flow(update=True)

    def _health_check(self) -> dict:
        from mpi_grid_redistribute_tpu_torch.service.faults import (
            SLOBreachError,
        )

        if self.cfg.rebalance:
            self._refresh_flow()
        verdict = self.monitor.evaluate()
        if not self.degraded and self.engine != "planar":
            for f in verdict["findings"]:
                if f["rule"] == "fast_path_fallback":
                    self._degrade(f["reason"])
                    break
        if self.cfg.rebalance:
            # actuate BEFORE the slo_ raise: a rebalance that fixes the
            # hot rank must not be pre-empted by a restart the imbalance
            # itself provoked
            trigger_on = set(self.cfg.rebalance_on)
            for f in verdict["findings"]:
                if f["rule"] in trigger_on and f["severity"] == "ALERT":
                    self._maybe_rebalance(f)
                    break
        for f in verdict["findings"]:
            if f["rule"].startswith("slo_"):
                raise SLOBreachError(f"{f['rule']}: {f['reason']}")
        return verdict

    def _maybe_rebalance(self, finding: dict) -> None:
        """ALERT -> plan -> guard -> (maybe) one ``apply_assignment``.
        Journals a ``rebalance`` event on every path, applied or
        declined. The occupancy is binned on the state's device; the LPT
        runs on the host over the histogram."""
        from mpi_grid_redistribute_tpu_torch.domain import (
            Domain,
            ProcessGrid,
        )
        from mpi_grid_redistribute_tpu_torch.telemetry import flow as flow_lib
        from mpi_grid_redistribute_tpu_torch.telemetry import (
            rebalance as reb_lib,
        )

        cfg = self.cfg
        if self._planner is None:
            self._planner = reb_lib.RebalancePlanner(
                Domain(0.0, 1.0, periodic=True),
                ProcessGrid(cfg.grid_shape),
                cells_per_rank_axis=cfg.rebalance_cells,
            )
        if self._guard is None:
            self._guard = reb_lib.AmortizationGuard(
                horizon_steps=cfg.rebalance_horizon,
                cooldown_steps=cfg.rebalance_cooldown,
                min_improvement=cfg.rebalance_min_improvement,
            )
        pos, vel, ids, count = self.state
        plan = self._planner.plan(pos, count=count)
        if plan is None:
            self.recorder.record(
                "rebalance",
                step=self.step,
                applied=False,
                reason="no live rows to balance",
                rule=finding["rule"],
                trigger=finding["reason"],
            )
            return
        step_s = float(self._wall_ema or 0.0)
        d = self._guard.consider(
            step=self.step,
            step_seconds=step_s,
            old_imbalance=plan.old_imbalance,
            projected_imbalance=plan.projected_imbalance,
        )
        if not d.apply:
            self.recorder.record(
                "rebalance",
                step=self.step,
                applied=False,
                reason=d.reason,
                rule=finding["rule"],
                trigger=finding["reason"],
                old_imbalance=plan.old_imbalance,
                projected_imbalance=plan.projected_imbalance,
                projected_saving_s=d.projected_saving_s,
                cost_s=d.cost_s,
            )
            return
        t0 = time.perf_counter()
        res = self._rd.apply_assignment(plan.edges, pos, vel, ids,
                                        count=count)
        self.state = self._to_state(res.positions, res.fields[0],
                                    res.fields[1], res.count)
        new_counts = _host(self.state[3]).astype(np.float64)  # waits
        cost = time.perf_counter() - t0
        self._edges = plan.edges  # survives _rd rebuilds (_ensure_built)
        m = flow_lib.flow_matrix_of(res.stats)[-1]
        rows_moved = int(m.sum() - np.trace(m))
        realized = (
            float(new_counts.max() / new_counts.mean())
            if new_counts.mean() > 0 else 1.0
        )
        realized_saving_s = (
            step_s * (1.0 - realized / plan.old_imbalance)
            if plan.old_imbalance > 0 else 0.0
        )
        self._guard.note_applied(self.step, cost)
        self.recorder.record(
            "rebalance",
            step=self.step,
            applied=True,
            reason=d.reason,
            rule=finding["rule"],
            trigger=finding["reason"],
            old_imbalance=plan.old_imbalance,
            projected_imbalance=plan.projected_imbalance,
            realized_imbalance=realized,
            rows_moved=rows_moved,
            projected_saving_s=d.projected_saving_s,
            realized_saving_s=realized_saving_s,
            cost_s=cost,
            n_cells=plan.n_cells,
            occupied_cells=plan.occupied_cells,
        )
        # refresh the gauge from the post-apply stats: the stale snapshot
        # must not re-fire the ALERT at the next boundary
        self._refresh_flow()

    def _degrade(self, reason: str) -> None:
        self.recorder.record(
            "degrade",
            **{"from": self.engine, "to": "planar", "reason": reason},
        )
        self.engine = "planar"
        self.degraded = True
        self._rd = None  # rebuilt with the pinned engine on next step

    def snapshots_corrupt(self) -> int:
        """Corrupt snapshots skipped over by restores, summed from the
        retained ``restore`` events."""
        return sum(
            int(e.data.get("snapshots_skipped", 0) or 0)
            for e in self.recorder.events("restore")
            if e.data.get("what") == "state"
        )

    def healthz(self) -> Tuple[int, dict]:
        """The ``/healthz`` contract for the supervisor: read-only rule
        evaluation, 503 on ALERT, with ``snapshots_corrupt``."""
        verdict = self.monitor.evaluate(record=False)
        verdict["snapshots_corrupt"] = self.snapshots_corrupt()
        return (503 if verdict["status"] == "ALERT" else 200), verdict

    # -------------------------------------------- chunked run machinery

    def _chunk_len_from(self, step: int, end: int) -> int:
        """Steps the next chunk may advance from ``step``: ``cfg.chunk``
        clipped to the horizon and split at the next snapshot/health
        boundary and the next fault-eligible step, so every boundary
        lands where the eager loop puts it; a fault eligible at ``step``
        forces a singleton chunk."""
        cfg = self.cfg
        n = min(max(1, int(cfg.chunk)), end - step)
        if n > 1:
            for every in (cfg.snapshot_every, cfg.health_every):
                if every:
                    n = min(n, every - step % every)
        if n > 1 and self.faults:
            nf = self.faults.next_step(step)
            if nf is not None:
                n = min(n, max(1, nf - step))
        return max(1, n)

    def _boundary_free(self, step: int) -> bool:
        # True when completing `step` triggers no snapshot/health work and
        # no fault is eligible there: the chunk starting at `step` may be
        # issued before its predecessor is retired
        cfg = self.cfg
        if cfg.snapshot_every and step % cfg.snapshot_every == 0:
            return False
        if cfg.health_every and step % cfg.health_every == 0:
            return False
        if self.faults:
            nf = self.faults.next_step(step)
            if nf is not None and nf <= step:
                return False
        return True

    def _resident_ok(self) -> bool:
        # a chunk needs out_capacity == n_local; a receive-side grow
        # pins the driver to the eager loop
        rd = self._rd
        return rd is not None and (
            rd.out_capacity is None
            or int(rd.out_capacity) == int(self.cfg.n_local)
        )

    def _macro_fn(self, n: int):
        """The ``n``-step macro fn (and its capacities), cached on
        everything that changes the issued program."""
        from mpi_grid_redistribute_tpu_torch.service import (
            pipeline,
            resident,
        )

        rd = self._rd
        pos, vel, ids, _ = self.state
        pipelined = bool(self.cfg.pipeline) and n >= 2
        key = (
            n, pos.shape[0], rd.capacity, rd.out_capacity,
            rd._mover_cap, rd.edges, self.engine, pipelined,
            self._probes,
        )
        entry = self._chunk_cache.get(key)
        if entry is None:
            build = (
                pipeline.make_pipelined_chunk_fn
                if pipelined
                else resident.make_chunk_fn
            )
            entry = build(
                rd, self.cfg.dt, n, pos, vel, ids, probes=self._probes
            )
            self._chunk_cache[key] = entry
        return entry

    def _finish_steps(self, n, compute_s, budget_s, dropped) -> None:
        """Fold one completed chunk into the per-step surfaces: n
        ``step_latency`` events (wall apportioned from the chunk), the
        monitor's step times, the snapshot-cadence EMA and the watchdog.
        ``cfg.step_sleep`` is excluded from ``compute_s`` but included in
        ``budget_s``: pacing is not latency, but a stalled sleep is still
        a stall."""
        from mpi_grid_redistribute_tpu_torch import telemetry as telemetry_lib

        cfg = self.cfg
        per = compute_s / n
        first = self.step + 1
        self.step += n
        for _ in range(n):
            self.monitor.note_step_time(per)
        telemetry_lib.record_chunk_steps(self.recorder, first, per, dropped)
        self._last_dropped = int(dropped[-1])
        for _ in range(n):
            self._wall_ema = (
                per if self._wall_ema is None
                else 0.2 * per + 0.8 * self._wall_ema
            )
        per_budget = budget_s / n
        if cfg.watchdog_s and per_budget > cfg.watchdog_s:
            raise StallError(
                f"step {self.step} took {per_budget:.3f}s "
                f"(> {cfg.watchdog_s:.3f}s watchdog)"
            )

    def _note_probe_steps(self, probe) -> None:
        """Journal one ``state_health`` event per probed step (host
        arrays) and latch the breach flag on any corruption counter."""
        record_probe_steps(self.recorder, self.step + 1, probe)
        for k in ("nan_pos", "nan_vel", "oob", "residual"):
            if np.asarray(probe[k]).any():
                self._state_breach = True
                break

    def _state_health_gate(self) -> None:
        # corruption fails the boundary BEFORE the snapshot hook, so the
        # newest snapshot always predates it
        if not self._state_breach:
            return
        from mpi_grid_redistribute_tpu_torch.service.faults import (
            _STATE_RULES,
            StateCorruptionError,
        )

        self._state_breach = False
        verdict = self.monitor.evaluate()
        reasons = [
            f"{f['rule']}: {f['reason']}"
            for f in verdict["findings"]
            if f["rule"] in _STATE_RULES
        ]
        raise StateCorruptionError(
            "; ".join(reasons)
            or "state_health breach (events evicted before the gate)"
        )

    def _run_boundary(self) -> None:
        # snapshot/health hooks at the step the chunk just ended at
        cfg = self.cfg
        # freeze fault bundles BEFORE the health pass: a finding the fault
        # provoked may raise (SLOBreachError) out of the check
        if self._flight is not None:
            self._flight.scan_faults()
        try:
            self._state_health_gate()
            if cfg.snapshot_every and self.step % cfg.snapshot_every == 0:
                path = self.snapshot()
                self.faults.after_snapshot(self, path)
                self._health_check()
            elif cfg.health_every and self.step % cfg.health_every == 0:
                self._health_check()
        finally:
            # drain AFTER the health pass (its alerts make this boundary's
            # segment) and even when it raised: the evidence of a breach
            # reaches disk before the restart. The ring holds host values
            # only, so the drain reads nothing from the device.
            if self._store is not None:
                self._store.drain(self.recorder)

    def _run_chunk_eager(self, n: int, fire_faults: bool = True) -> None:
        """Advance ``n`` steps through the eager per-step path: the numpy
        backend at any chunk length, singleton chunks (fault steps,
        ``chunk=1``) and the re-run of a chunk that overflowed."""
        cfg = self.cfg
        t0 = time.perf_counter()
        if fire_faults:
            self.faults.before_step(self)
        armed = self._probes.armed
        if armed:
            # the chunk's conservation ledger, anchored as in the chunk:
            # live rows at entry, dropped rows accumulated a step (the
            # summary reads host copies of the state)
            live0 = int(_host(self.state[3]).sum())
            cum = 0
        dropped = []
        for i in range(n):
            self.state = self._advance(*self.state)
            dropped.append(self._last_dropped)
            if armed:
                cum += self._last_dropped
                pos, vel, _, count = self.host_state()
                payload = summarize_host(
                    pos, vel, count, live0, cum, self._probes
                )
                self.recorder.record(
                    "state_health", step=self.step + 1 + i, **payload
                )
                if (
                    payload["nan_pos"] or payload["nan_vel"]
                    or payload["oob"] or payload["residual"]
                ):
                    self._state_breach = True
        compute = time.perf_counter() - t0
        if cfg.step_sleep:
            time.sleep(cfg.step_sleep * n)
        budget = time.perf_counter() - t0
        self._finish_steps(n, compute, budget, dropped)
        self._run_boundary()

    def _stage_ys(self, ys, start):
        """Queue the host copies a chunk's retirement needs, without
        waiting: drop counters, needed capacity and counts as one int32
        ``[4, n, R]`` block (and the probe leaves), into pinned host
        buffers on the card, behind an event recorded right after the
        chunk, before anything later is issued."""
        st = ys["stats"]
        block = torch.stack([
            st.dropped_send.to(torch.int32), st.dropped_recv.to(torch.int32),
            st.needed_capacity.to(torch.int32), ys["count"].to(torch.int32),
        ])
        leaves = {"block": block}
        probe = ys.get("probe")
        if probe is not None:
            leaves.update({f"probe.{k}": v for k, v in probe.items()})
        if self.device.type != "cuda":
            return leaves, None, None
        host = {}
        for k, v in leaves.items():
            buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            buf.copy_(v, non_blocking=True)
            host[k] = buf
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        return host, start, end

    def _wait_staged(self, staged):
        """Wait for a chunk's staged host copies: its own event, so a
        chunk issued after it keeps running."""
        if staged[2] is not None:
            staged[2].synchronize()
        return staged

    def _mark(self):
        """A timing event recorded now on the card (None elsewhere)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _dispatch_chunk(self, n: int):
        """Issue one macro-step; returns at once with the carry, the ys
        and their queued host copies."""
        self.faults.before_step(self)  # no-op by construction: any
        # eligible injector forced a singleton chunk via _chunk_len_from
        t0 = time.perf_counter()
        start = self._mark()
        self._ensure_built()
        macro, cap, out_cap = self._macro_fn(n)
        entry = self.state
        carry, ys = macro(*entry)
        return (n, t0, cap, out_cap, entry, carry, ys,
                self._stage_ys(ys, start))

    def _retire_chunk(self, pending, end: int):
        """Wait for an issued chunk's host copies, fold them into the
        per-step surfaces and run the boundary hooks. When the NEXT chunk
        has no boundary work at its start, it is issued from the carry
        BEFORE this chunk's host reads. Returns that chunk (or None)."""
        from mpi_grid_redistribute_tpu_torch.service import resident

        cfg = self.cfg
        n, t0, cap, out_cap, entry, carry, ys, staged = pending
        step_after = self.step + n
        nxt = None
        if step_after < end and self._boundary_free(step_after):
            n2 = self._chunk_len_from(step_after, end)
            if n2 > 1:
                t0b = time.perf_counter()
                start2 = self._mark()
                macro2, cap2, out2 = self._macro_fn(n2)
                carry2, ys2 = macro2(*carry)
                nxt = (n2, t0b, cap2, out2, carry, carry2, ys2,
                       self._stage_ys(ys2, start2))
        host, ev_start, ev_end = self._wait_staged(staged)
        block = host["block"].numpy()
        ds, dr, needed_cap, counts = block[0], block[1], block[2], block[3]
        now = time.perf_counter()
        if ev_end is not None:
            # the device's wall from dispatch (or the predecessor's end)
            # to the chunk's last kernel
            compute = ev_start.elapsed_time(ev_end) / 1e3
        else:
            anchor = t0 if self._chunk_done is None else max(
                t0, self._chunk_done
            )
            compute = now - anchor
        if ds.any() or dr.any():
            # overflow inside the chunk: grow from the measured need, drop
            # the chunk (and any successor, which consumed the lossy
            # carry) and re-run these n steps eagerly
            needed = int(needed_cap.max())
            needed_out = int((counts + dr).max())
            self._rd._grow(
                int(ds.sum()), int(dr.sum()), needed, needed_out,
                int(self.cfg.n_local), cap, out_cap,
            )
            self._chunk_cache.clear()
            self.state = entry
            self._run_chunk_eager(n, fire_faults=False)
            self._chunk_done = time.perf_counter()
            return None
        budget = compute
        if cfg.step_sleep:
            t_sleep = time.perf_counter()
            time.sleep(cfg.step_sleep * n)
            budget += time.perf_counter() - t_sleep
        self.state = carry
        self._rd._last_stats = resident.final_stats(ys["stats"])
        # the per-step engine surface: the `redistribute` events the eager
        # loop journals (one resolved engine, one wire model a chunk)
        rd = self._rd
        wire = rd._last_wire or {}
        wire_bytes = (
            wire.get("engine_cols", 0)
            * (rd._last_row_bytes or 0)
            * wire.get("shards", 0)
        )
        for _ in range(n):
            rd._call_index += 1
            self.recorder.record(
                "redistribute",
                call=rd._call_index,
                n_local=int(cfg.n_local),
                capacity=cap,
                out_capacity=out_cap,
                engine=wire.get("engine", self.engine),
                wire_bytes=wire_bytes,
            )
        if "probe.live" in host:
            self._note_probe_steps({
                k[len("probe."):]: v.numpy() for k, v in host.items()
                if k.startswith("probe.")
            })
        dropped = (ds.sum(axis=1) + dr.sum(axis=1)).tolist()
        self._finish_steps(n, compute, budget, dropped)
        self._chunk_done = time.perf_counter()
        self._run_boundary()
        return nxt

    def run(self, max_steps: Optional[int] = None):
        """Advance up to ``max_steps`` (default: to ``cfg.steps``) and
        return the state. With ``cfg.chunk > 1`` on the torch backend each
        iteration issues one chunk and folds its ys into the per-step
        journal/SLO/health surfaces at the chunk boundary; ``chunk=1``
        (and the numpy backend) is the eager loop, and any chunk gives
        the eager loop's final particle set."""
        cfg = self.cfg
        if self.state is None:
            self.init_state()
        end = cfg.steps
        if max_steps is not None:
            end = min(end, self.step + int(max_steps))
        pending = None
        session = ProfilerSession(
            cfg.profile_dir,
            recorder=self.recorder,
            label=f"run@{self.step}",
        )
        # inherit the supervisor's per-attempt context, else a
        # deterministic root trace from the seed; each iteration scopes
        # to the chunk's first step
        cur = context_lib.current()
        root = (
            cur.child(origin="driver")
            if cur is not None
            else context_lib.StepContext(
                trace=f"svc-{cfg.seed:08x}", origin="driver"
            )
        )
        with context_lib.use(root), session:
            while self.step < end:
                with context_lib.scoped(step=self.step + 1):
                    self._ensure_built()
                    if pending is not None:
                        pending = self._retire_chunk(pending, end)
                        continue
                    n = self._chunk_len_from(self.step, end)
                    if (
                        n == 1
                        or cfg.backend != "torch"
                        or not self._resident_ok()
                    ):
                        self._run_chunk_eager(n)
                        continue
                    pending = self._dispatch_chunk(n)
        return self.state

    def close(self) -> None:
        """Orderly shutdown: commit the in-flight snapshot, resolve the
        engine's deferred overflow windows, export the final journal."""
        self.join_snapshot_writer()
        if self._rd is not None:
            self._rd.flush_overflow_checks()
        if self._flight is not None:
            # a fault that crashed the attempt before the next boundary
            # still leaves its incident bundle behind
            self._flight.scan_faults()
        if self._store is not None:
            # final drain, rotate, compact and retention BEFORE the
            # journal export, so the shard holds the last store_drain
            self._store.close(self.recorder)
        self.export_journal()

    def abandon(self) -> Optional[str]:
        """Failure-path teardown: :meth:`close`, but a secondary error is
        returned as a string for the supervisor to append to the primary
        failure instead of raising over it."""
        try:
            self.close()
        except Exception as e:
            return f"teardown after failure also failed: " \
                   f"{type(e).__name__}: {e}"
        return None


# ------------------------------------------------------------------ CLI


def _write_final(path: str, drv: ServiceDriver) -> None:
    pos, vel, ids, count = drv.host_state()
    np.savez(path, pos=pos, vel=vel, ids=ids, count=count, step=drv.step)


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(
        prog="mpi_grid_redistribute_tpu_torch.service",
        description="long-running drift->redistribute service loop",
    )
    p.add_argument("--grid", default="2,2,2")
    p.add_argument("--n-local", type=int, default=4096)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--fill", type=float, default=0.9)
    p.add_argument("--migration", type=float, default=0.02)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default="torch", choices=BACKENDS)
    p.add_argument(
        "--device", default=None,
        help="torch backend's device (default: the GPU; raises without "
             "one); 'cpu' runs the plain versions on the CPU",
    )
    p.add_argument("--engine", default="auto")
    p.add_argument("--snapshot-every", type=int, default=0)
    p.add_argument("--snapshot-dir", default=None)
    p.add_argument("--journal-dir", default=None)
    p.add_argument(
        "--store-dir", default=None, metavar="DIR",
        help="durable journal store root (telemetry/store.py): the "
             "recorder ring is drained here at the end of every chunk "
             "and at close",
    )
    p.add_argument("--keep-snapshots", type=int, default=4)
    p.add_argument("--sync-snapshots", action="store_true")
    p.add_argument("--watchdog", type=float, default=0.0)
    p.add_argument("--step-sleep", type=float, default=0.0)
    p.add_argument(
        "--chunk", type=int, default=1,
        help="steps issued a dispatch (torch backend; 1 = eager loop)",
    )
    p.add_argument(
        "--pipeline", action="store_true",
        help="software-pipelined chunk: overlap each step's exchange with "
             "the next step's binning (degrades to the sequential chunk "
             "when the schedule is infeasible)",
    )
    p.add_argument(
        "--probes", default="off", choices=("off", "counters", "moments"),
        help="state-health probe tier: journal state_health events a step "
             "and fail the boundary on NaN / out-of-bounds / "
             "conservation drift",
    )
    p.add_argument(
        "--no-resume", action="store_true",
        help="ignore existing snapshots; start from the seeded state",
    )
    p.add_argument(
        "--supervise", action="store_true",
        help="run under the Supervisor (restore/backoff/circuit breaker)",
    )
    p.add_argument("--max-restarts", type=int, default=5)
    p.add_argument("--window-s", type=float, default=300.0)
    p.add_argument("--backoff-base", type=float, default=0.05)
    p.add_argument("--backoff-cap", type=float, default=2.0)
    p.add_argument(
        "--slo-p99", type=float, default=0.0, metavar="SECONDS",
        help="p99 step-latency SLO; sustained breach restarts (0 = off)",
    )
    p.add_argument(
        "--no-reshard", action="store_true",
        help="disable elastic restore (mesh-mismatched snapshots error)",
    )
    p.add_argument(
        "--rebalance", action="store_true",
        help="close the loop: imbalance_ratio ALERT -> plan -> "
             "amortization guard -> one-shot apply_assignment",
    )
    p.add_argument("--rebalance-threshold", type=float, default=2.0)
    p.add_argument("--rebalance-cells", type=int, default=2)
    p.add_argument("--rebalance-horizon", type=int, default=256)
    p.add_argument("--rebalance-cooldown", type=int, default=64)
    p.add_argument(
        "--shrink-after", type=int, default=0, metavar="N",
        help="supervise mode: shrink the grid after N consecutive "
             "SLO-breach restarts (0 = never)",
    )
    p.add_argument(
        "--inject-crash", type=int, default=None, metavar="STEP",
        help="inject a crash at STEP (-1 = every run: crash-loop)",
    )
    p.add_argument(
        "--hard-crash", action="store_true",
        help="crash via os._exit (subprocess kill tests) instead of raise",
    )
    p.add_argument(
        "--profile-dir", default=None, metavar="DIR",
        help="write a torch.profiler trace of each run() into DIR",
    )
    p.add_argument(
        "--incident-dir", default=None, metavar="DIR",
        help="freeze a debounced incident bundle into DIR on every "
             "ALERT / injected fault (telemetry/incident.py; inspect with "
             "python -m mpi_grid_redistribute_tpu_torch.tools.incident)",
    )
    p.add_argument(
        "--final-out", default=None,
        help="write the final state (pos/vel/ids/count/step npz) here",
    )
    args = p.parse_args(argv)

    cfg = DriverConfig(
        grid_shape=tuple(int(x) for x in args.grid.split(",")),
        n_local=args.n_local,
        fill=args.fill,
        steps=args.steps,
        seed=args.seed,
        migration=args.migration,
        backend=args.backend,
        device=args.device,
        engine=args.engine,
        snapshot_every=args.snapshot_every,
        snapshot_dir=args.snapshot_dir,
        keep_snapshots=args.keep_snapshots,
        snapshot_async=not args.sync_snapshots,
        journal_dir=args.journal_dir,
        store_dir=args.store_dir,
        watchdog_s=args.watchdog,
        step_sleep=args.step_sleep,
        chunk=args.chunk,
        pipeline=args.pipeline,
        probes=args.probes,
        auto_reshard=not args.no_reshard,
        slo_latency_p99_s=args.slo_p99,
        rebalance=args.rebalance,
        rebalance_threshold=args.rebalance_threshold,
        rebalance_cells=args.rebalance_cells,
        rebalance_horizon=args.rebalance_horizon,
        rebalance_cooldown=args.rebalance_cooldown,
        profile_dir=args.profile_dir,
        incident_dir=args.incident_dir,
    )
    faults = FaultPlan()
    if args.inject_crash is not None:
        from mpi_grid_redistribute_tpu_torch.service.faults import CrashFault

        step = None if args.inject_crash < 0 else args.inject_crash
        faults.faults.append(CrashFault(step, hard=args.hard_crash))

    if args.supervise:
        from mpi_grid_redistribute_tpu_torch.service.supervisor import (
            RestartPolicy,
            Supervisor,
        )

        recorder = StepRecorder()

        def factory(grid_shape=None):
            c = cfg
            if grid_shape is not None:
                c = dataclasses.replace(c, grid_shape=tuple(grid_shape))
            return ServiceDriver(c, recorder=recorder, faults=faults)

        sup = Supervisor(
            factory,
            policy=RestartPolicy(
                max_restarts=args.max_restarts,
                window_s=args.window_s,
                backoff_base_s=args.backoff_base,
                backoff_cap_s=args.backoff_cap,
                shrink_after=args.shrink_after,
            ),
            recorder=recorder,
        )
        verdict = sup.run()
        print(json.dumps(verdict._asdict()), flush=True)
        if args.final_out and sup.driver is not None and (
            sup.driver.state is not None
        ):
            _write_final(args.final_out, sup.driver)
        return 0 if verdict.ok else 3

    drv = ServiceDriver(cfg, faults=faults)
    if not args.no_resume:
        drv.restore_latest()
    drv.run()
    drv.close()
    if args.final_out:
        _write_final(args.final_out, drv)
    print(
        json.dumps(
            {"ok": True, "step": drv.step,
             "counts": drv.recorder.counts()}
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
