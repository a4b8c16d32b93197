"""Config 8: the service soak, sustained throughput with snapshots on (the
twin of the JAX package's ``bench/config8_soak.py``, the same legs, keys
and gate).

The other configs time the engine; this one times the service: the
:class:`~..service.driver.ServiceDriver` loop (drift, the public
``redistribute()``, journal, watchdog) with the checkpoint cadence on.

* **What does durability cost?** ``snapshot_overhead`` compares min-of-k
  segment timings (segments of 2 cadences) of the same driver loop with
  snapshots off and on (the asynchronous writer). The gate is <= 2% of
  step time.
* **Does recovery preserve the trajectory?** The crash leg runs a short
  supervised soak with one injected crash, restores from the latest
  snapshot, and byte-compares the final state with an uninterrupted run
  (``bit_identical_resume``).
* **Does recovery survive losing devices?** The elastic leg crashes AND
  reports half the devices on restart
  (:class:`~..service.faults.DeviceLossFault`): the supervisor
  shrink-restores the snapshot onto the smaller grid (journaled
  ``reshard``) and the final particle set, sorted by id, must equal the
  uninterrupted run's (``elastic_set_identical``).
* **Does the observatory catch corrupted physics?** The corruption leg
  soaks with the state-health probes armed and injects a NaN burst
  (:class:`~..service.faults.StateCorruptionFault`): a ``state_health``
  event with a nonzero NaN count, a ``nan_detected`` ALERT, an incident
  bundle whose index names the step, exactly one restart and a restore
  from before the corruption (``corruption_recovered``).

The headline is ``soak_pps``: live particles a second through the whole
service loop with snapshots on. The reference runs its NumPy driver on
fewer than 8 devices (so on one TPU chip); the port runs
``backend="torch"`` on the card with the grid's ranks as vranks.

Env knobs (the reference's): ``BENCH_SCALE`` (scales ``n_local``, 2^14
rows a vrank at 1), ``BENCH_GRID`` (default ``2,2,2``),
``BENCH_SOAK_N_LOCAL``, ``BENCH_SOAK_EVERY`` (snapshot cadence, 16),
``BENCH_SOAK_K`` (min-of-k samples, 5), ``BENCH_SOAK_STEPS`` (the crash,
elastic and corruption legs' horizon, 24).

    python -m mpi_grid_redistribute_tpu_torch.bench.config8_soak [--soak]

``--soak`` fails (exit 1) on any of the gate's clauses. It runs on the
GPU and raises without one (``--device cpu`` runs the plain versions on
the CPU).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import sys
import tempfile
import time

from mpi_grid_redistribute_tpu_torch.bench import common


def _grid():
    return tuple(
        int(x) for x in os.environ.get("BENCH_GRID", "2,2,2").split(",")
    )


def _make_driver(grid, n_local, steps, snapshot_every, snap_dir, device,
                 recorder=None, faults=None, probes="off",
                 incident_dir=None):
    from mpi_grid_redistribute_tpu_torch.service import (
        DriverConfig,
        ServiceDriver,
    )

    cfg = DriverConfig(
        grid_shape=grid,
        n_local=n_local,
        steps=steps,
        seed=11,
        backend="torch",
        device=device,
        snapshot_every=snapshot_every,
        snapshot_dir=snap_dir,
        keep_snapshots=3,
        probes=probes,
        incident_dir=incident_dir,
    )
    return ServiceDriver(cfg, recorder=recorder, faults=faults)


def _segment_seconds(driver, seg: int) -> float:
    # the eager loop reads each step's drop counters back, so the wall
    # of a segment ends after its last step's work on the device
    t0 = time.perf_counter()
    driver.run(max_steps=seg)
    return (time.perf_counter() - t0) / seg


def _supervise(factory, recorder):
    from mpi_grid_redistribute_tpu_torch.service import (
        RestartPolicy,
        Supervisor,
    )

    sup = Supervisor(
        factory,
        policy=RestartPolicy(backoff_base_s=0.01, backoff_cap_s=0.05),
        recorder=recorder,
    )
    return sup, sup.run()


def run(n_local: int = None, reps: int = None, device=None) -> dict:
    """One soak capture: the overhead measurement and the crash, elastic
    and corruption legs."""
    from mpi_grid_redistribute_tpu_torch import _device
    from mpi_grid_redistribute_tpu_torch.service import (
        CrashFault,
        DeviceLossFault,
        FaultPlan,
        StateCorruptionFault,
        particle_set,
    )
    from mpi_grid_redistribute_tpu_torch.telemetry import (
        StepRecorder,
        incident,
        regress,
    )

    dev = _device.resolve(device)
    grid = _grid()
    R = math.prod(grid)
    if n_local is None:
        scale = float(os.environ.get("BENCH_SCALE", 1.0))
        n_local = int(os.environ.get(
            "BENCH_SOAK_N_LOCAL", max(1024, int(scale * (1 << 14)))))
    every = int(os.environ.get("BENCH_SOAK_EVERY", 16))
    k = reps if reps is not None else int(os.environ.get("BENCH_SOAK_K", 5))
    seg = 2 * every  # a segment spans 2 cadences: joins land inside samples
    warm = 4
    steps = warm + k * seg

    def make(*args, **kw):
        return _make_driver(grid, *args, device=dev, **kw)

    root = tempfile.mkdtemp(prefix="config8_soak_")
    try:
        # --- base: the same loop, snapshots off ---------------------------
        base_drv = make(n_local, steps, 0, None)
        base_drv.init_state()
        base_drv.run(max_steps=warm)  # kernel builds and caches
        base = regress.min_of_k(lambda: _segment_seconds(base_drv, seg), k=k)
        base_drv.close()

        # --- soak: snapshots on (the asynchronous writer) -----------------
        soak_drv = make(n_local, steps, every, os.path.join(root, "snaps"))
        soak_drv.init_state()
        soak_drv.run(max_steps=warm)
        soak = regress.min_of_k(lambda: _segment_seconds(soak_drv, seg), k=k)
        snapshots = len(soak_drv.recorder.events("snapshot"))
        soak_fill = soak_drv.cfg.fill
        soak_drv.close()
        overhead = (soak["min"] - base["min"]) / base["min"]

        # --- crash leg: one injected crash, supervised restore ------------
        n_small = max(256, n_local // 8)
        crash_steps = int(os.environ.get("BENCH_SOAK_STEPS", 24))
        crash_every = max(2, crash_steps // 4)
        crash_at = max(2, 5 * crash_steps // 8)
        ref = make(n_small, crash_steps, crash_every,
                   os.path.join(root, "ref_snaps"))
        ref.init_state()
        ref.run()
        ref.close()
        ref_state = ref.host_state()

        rec = StepRecorder()
        plan = FaultPlan([CrashFault(crash_at)])
        sup, verdict = _supervise(
            lambda: make(n_small, crash_steps, crash_every,
                         os.path.join(root, "soak_snaps"), recorder=rec,
                         faults=plan),
            rec,
        )
        bit_identical = bool(
            verdict.ok
            and all(a.tobytes() == b.tobytes()
                    for a, b in zip(ref_state, sup.driver.host_state()))
        )

        # --- elastic leg: crash + device loss -> shrink-restore -----------
        rec2 = StepRecorder()
        plan2 = FaultPlan(
            [CrashFault(crash_at), DeviceLossFault(max(1, R // 2))]
        )

        def elastic_factory(grid_shape=None):
            g = tuple(grid_shape) if grid_shape is not None else grid
            return _make_driver(
                g, n_small, crash_steps, crash_every,
                os.path.join(root, "elastic_snaps"), dev, recorder=rec2,
                faults=plan2,
            )

        sup2, verdict2 = _supervise(elastic_factory, rec2)
        # the grids differ, so compare the particle SET (sorted by id),
        # not the padded per-vrank layout
        elastic_set_identical = bool(
            verdict2.ok
            and particle_set(*ref_state)
            == particle_set(*sup2.driver.state)
        )
        resharded = len(rec2.events("reshard"))
        elastic_grid = list(sup2.driver.cfg.grid_shape)
        elastic_restarts = verdict2.restarts

        # --- corruption leg: a NaN burst with the probes armed ------------
        # the boundary gate raises before the snapshot hook, so the
        # supervisor restores a snapshot from before the damage
        corrupt_at = crash_at
        inc_dir = os.path.join(root, "corrupt_incidents")
        rec3 = StepRecorder()
        plan3 = FaultPlan([StateCorruptionFault(corrupt_at, rows=8)])
        _, verdict3 = _supervise(
            lambda: make(n_small, crash_steps, crash_every,
                         os.path.join(root, "corrupt_snaps"), recorder=rec3,
                         faults=plan3, probes="counters",
                         incident_dir=inc_dir),
            rec3,
        )
        nan_steps = sorted(
            e.data["step"]
            for e in rec3.events("state_health")
            if e.data.get("nan_pos") or e.data.get("nan_vel")
        )
        nan_alerts = [
            e for e in rec3.events("alert")
            if e.data.get("rule") == "nan_detected"
        ]
        restores3 = [
            e for e in rec3.events("restore")
            if e.data.get("what") == "state"
        ]
        # the restore must land strictly before the step the NaNs hit
        restored_pre = bool(
            restores3
            and nan_steps
            and int(restores3[-1].data["step"]) < nan_steps[0]
        )
        step_named = any(
            idx.get("rule") == "nan_detected"
            and nan_steps
            and f"step {nan_steps[0]}" in str(idx.get("reason", ""))
            for idx in incident.list_bundles(inc_dir)
        )
        corruption_recovered = bool(
            verdict3.ok
            and verdict3.restarts == 1
            and nan_steps
            and nan_alerts
            and restored_pre
            and step_named
        )
        corruption_restarts = verdict3.restarts
        corruption_step = nan_steps[0] if nan_steps else None
    finally:
        shutil.rmtree(root, ignore_errors=True)

    live = int(soak_fill * n_local) * R
    out = {
        "metric": "soak_pps",
        "value": round(live / soak["min"], 2),
        "unit": "particles/s",
        "engine": "torch",
        "grid": list(grid),
        "rows": live,
        "ms_per_step": round(soak["min"] * 1e3, 3),
        "timing_spread": round(soak["spread"], 4),
        "timing_k": soak["k"],
        "snapshot_every": every,
        "snapshots_written": snapshots,
        "snapshot_overhead": round(overhead, 4),
        "restarts": verdict.restarts,
        "bit_identical_resume": bit_identical,
        "elastic_restarts": elastic_restarts,
        "elastic_grid": elastic_grid,
        "elastic_set_identical": elastic_set_identical,
        "resharded": resharded,
        "corruption_restarts": corruption_restarts,
        "corruption_step": corruption_step,
        "corruption_recovered": corruption_recovered,
    }
    common.log(
        f"config8: soak {live / soak['min']:.3e} pps "
        f"({soak['min'] * 1e3:.3f} ms/step against {base['min'] * 1e3:.3f} "
        f"with snapshots off, snapshots every {every}), "
        f"snapshot overhead {overhead * 100:+.2f}%, "
        f"crash leg: restarts={verdict.restarts} "
        f"bit_identical={bit_identical}, "
        f"elastic leg: grid {list(grid)}->{elastic_grid} "
        f"resharded={resharded} set_identical={elastic_set_identical}, "
        f"corruption leg: nan at step {corruption_step} "
        f"restarts={corruption_restarts} recovered={corruption_recovered}"
    )
    return out


def _soak_gate(out: dict, overhead_max: float = 0.02) -> list:
    """The soak verdict: hard failures as a list of reasons."""
    failures = []
    if not out["bit_identical_resume"]:
        failures.append(
            "resumed trajectory is NOT bit-identical to the "
            "uninterrupted run"
        )
    if out["restarts"] != 1:
        failures.append(
            f"crash leg restarted {out['restarts']} times, expected 1"
        )
    if out["snapshot_overhead"] > overhead_max:
        failures.append(
            f"snapshot overhead {out['snapshot_overhead'] * 100:.2f}% "
            f"exceeds the {overhead_max * 100:.0f}% budget"
        )
    if out["snapshots_written"] < 1:
        failures.append("soak run wrote no snapshots")
    if not out["elastic_set_identical"]:
        failures.append(
            "shrink-restored particle set is NOT identical to the "
            "uninterrupted full-grid run"
        )
    if out["elastic_restarts"] != 1:
        failures.append(
            f"elastic leg restarted {out['elastic_restarts']} times, "
            f"expected 1"
        )
    if out["resharded"] < 1:
        failures.append(
            "elastic leg journaled no reshard event (restore never "
            "re-decomposed the snapshot)"
        )
    if not out["corruption_recovered"]:
        failures.append(
            "corruption leg did not close the observatory loop "
            "(expected: nan state_health event -> nan_detected ALERT -> "
            "bundle naming the step -> one restart -> pre-corruption "
            "restore -> healthy finish)"
        )
    if out["corruption_restarts"] != 1:
        failures.append(
            f"corruption leg restarted {out['corruption_restarts']} "
            f"times, expected 1"
        )
    return failures


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="mpi_grid_redistribute_tpu_torch.bench.config8_soak")
    p.add_argument(
        "--soak", action="store_true",
        help="gate mode: fail on the overhead budget or a recovery clause",
    )
    p.add_argument(
        "--overhead-max", type=float,
        default=float(os.environ.get("SOAK_OVERHEAD_MAX", 0.02)),
    )
    p.add_argument(
        "--device", default=None,
        help="default: the GPU (raises without one); 'cpu' runs the plain "
             "versions on the CPU",
    )
    args = p.parse_args(argv)
    out = run(device=args.device)
    print(json.dumps(out), flush=True)
    if not args.soak:
        return 0
    failures = _soak_gate(out, args.overhead_max)
    if failures:
        for f in failures:
            common.log(f"soak FAIL: {f}")
        return 1
    common.log(
        f"soak OK: crash+restore bit-identical, snapshot overhead "
        f"{out['snapshot_overhead'] * 100:.2f}% <= "
        f"{args.overhead_max * 100:.0f}%"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
