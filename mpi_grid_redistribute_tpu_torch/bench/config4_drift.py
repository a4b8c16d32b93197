"""Config 4 on one GPU: the periodic N-body drift loop, redistributed every
step, the strong-scaling configuration and the workload of the headline
(the twin of the JAX package's ``bench/config4_drift.py``): a 2x2x2 grid
as 8 vranks, ``n_local`` slots a vrank (``max(2^12, BENCH_SCALE *
2^20)``) at 90% fill, ~``migration`` of the live rows crossing a face a
step at dt = 1.0, the loop's default engine (the mover-sparse one here,
kernels 1 and 2 once a step).

    python -m mpi_grid_redistribute_tpu_torch.bench.config4_drift

``BENCH_DRIFT_BIAS=1`` replaces the velocities with a convergent flight
plan into one shard: the workload unbalances, the sink's grants dry up
and the health verdict must end in ALERT. Without the bias, two wire
captures follow the loop: :func:`canonical_wire_capture` (the
count-driven canonical exchange's scheduled wire) and
:func:`hierarchical_wire_capture` (the two-level engine's bytes over
the slower and the faster tier, on a virtual two-pod split).

The timing and checks are the headline's
(:func:`.headline.device_pipeline`: CUDA-event samples of runs of 8 and
``min(72, max(16, steps))`` steps differenced, no drop, rows conserved,
kernels 1 and 2 once a step on the card), over the reference's start
state.

:func:`run_rebalance` is the closed-loop rebalance leg: twin
:class:`~..service.driver.ServiceDriver` runs under one convergent drift
bias, the loop off and on; :func:`rebalance_smoke` gates it
(``python -m mpi_grid_redistribute_tpu_torch.bench.config4_drift
--rebalance``: the torch backend on the GPU; ``--backend numpy`` runs the
reference's host oracle loop instead).
"""

from __future__ import annotations

import json
import os

import numpy as np

from mpi_grid_redistribute_tpu_torch import _device, api, telemetry
from mpi_grid_redistribute_tpu_torch.bench import common
from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid
from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib
from mpi_grid_redistribute_tpu_torch.telemetry import report as report_lib


def _drift_rows(grid_shape, migration: float, n_local: int):
    """``(pos [R * n_local, 3], ids, flat destination cell)``: uniform
    rows on their own rank, the first ``m = round(migration * n_local)``
    of each rank moved one subdomain along the six faces in turn (the
    drift workload's pattern), from ``default_rng(7)``."""
    grid = ProcessGrid(grid_shape)
    R = grid.nranks
    m = max(1, int(round(migration * n_local)))
    rng = np.random.default_rng(7)
    pos = np.empty((R * n_local, 3), np.float32)
    for r in range(R):
        cell = grid.cell_of_rank(r)
        sl = slice(r * n_local, (r + 1) * n_local)
        for a in range(3):
            w = 1.0 / grid_shape[a]
            pos[sl, a] = (cell[a] + rng.random(n_local)) * w
        for i in range(m):
            axis = (i % 6) // 2
            sign = 1.0 if i % 2 == 0 else -1.0
            j = r * n_local + i
            pos[j, axis] = np.mod(pos[j, axis] + sign / grid_shape[axis],
                                  1.0)
    ids = np.arange(R * n_local, dtype=np.int32)
    shape = np.asarray(grid_shape)
    cells = np.floor(pos * shape).astype(np.int64) % shape
    flat = (cells[:, 0] * shape[1] + cells[:, 1]) * shape[2] + cells[:, 2]
    return pos, ids, flat


def _away(grid, grid_shape, flat, r: int, n_local: int):
    """Rank ``r``'s rows' destination cells other than its own."""
    shape = np.asarray(grid_shape)
    c = grid.cell_of_rank(r)
    home = (c[0] * shape[1] + c[1]) * shape[2] + c[2]
    away = flat[r * n_local:(r + 1) * n_local]
    return away[away != home]


def canonical_wire_capture(grid_shape, migration: float,
                           n_local: int = 1 << 12, device=None) -> dict:
    """The count-driven canonical exchange's scheduled wire on the drift
    workload's shape: ``wire_bytes_per_step`` (the pool the engine
    schedules) beside ``dense_wire_bytes_per_step`` (the dense ``[K, R *
    C]`` one). On one card the ranks are vranks, so the engine is
    ``"sparse"`` (the reference picks it when it has fewer devices than
    ranks). The mover block is sized from the measured per-destination
    peak with 1.5x headroom (an undersized block would fall back dense
    and show in the metric). Returns ``report()``'s keys."""
    grid = ProcessGrid(grid_shape)
    pos, ids, flat = _drift_rows(grid_shape, migration, n_local)
    peak = 0
    for r in range(grid.nranks):
        away = _away(grid, grid_shape, flat, r, n_local)
        if away.size:
            peak = max(peak, int(np.bincount(away).max()))
    rd = api.GridRedistribute(
        grid=grid_shape, lo=(0.0,) * 3, hi=(1.0,) * 3,
        periodic=(True,) * 3, engine="sparse",
        mover_cap=max(2, int(peak * 1.5)), device=device,
    )
    rd.redistribute(pos, ids)
    rep = rd.report()
    return {k: rep[k] for k in ("engine", "wire_bytes_per_step",
                                "dense_wire_bytes_per_step") if k in rep}


def hierarchical_wire_capture(grid_shape, dcn_shape=(2, 1, 1),
                              migration: float = 0.02,
                              n_local: int = 1 << 12, device=None) -> dict:
    """:func:`canonical_wire_capture` through the hierarchical two-level
    engine on a virtual pod split (``dcn_shape``): ``dcn_bytes_per_step``
    (the per-(pod, pod) condensed blocks the slow cross-pod link carries)
    beside ``ici_bytes_per_step`` (the in-pod stencil blocks and the
    fan-out pool). The cross block is sized from the measured
    per-destination-pod peak with 1.5x headroom. Returns ``report()``'s
    keys."""
    grid = ProcessGrid(grid_shape)
    pos, ids, flat = _drift_rows(grid_shape, migration, n_local)
    hm = mesh_lib.HierarchicalMesh(grid, dcn_shape)
    peak = peak_cross = 0
    for r in range(grid.nranks):
        away = _away(grid, grid_shape, flat, r, n_local)
        if away.size:
            peak = max(peak, int(np.bincount(away).max()))
            pods = np.asarray([hm.pod_of[int(d)] for d in away], np.int64)
            pods = pods[pods != hm.pod_of[r]]
            if pods.size:
                peak_cross = max(peak_cross, int(np.bincount(pods).max()))
    rd = api.GridRedistribute(
        grid=grid_shape, lo=(0.0,) * 3, hi=(1.0,) * 3,
        periodic=(True,) * 3, engine="hierarchical",
        mover_cap=max(2, int(peak * 1.5)), dcn_shape=dcn_shape,
        cross_cap=max(2, int(peak_cross * 1.5)), device=device,
    )
    rd.redistribute(pos, ids)
    rep = rd.report()
    return {k: rep[k] for k in (
        "engine", "wire_bytes_per_step", "dense_wire_bytes_per_step",
        "dcn_bytes_per_step", "ici_bytes_per_step") if k in rep}


def start_state(n_local: int, migration: float, bias: bool, s2: int):
    """The reference's start rows ``(pos, vel, alive)`` from
    ``default_rng(0)``: the headline's slab placement, then velocities
    drawn for ~``migration`` a step, or with ``bias`` the flight plan
    ``(sink - pos) / s2 * 0.65`` into the shard of ``(0.25, 0.25,
    0.25)``."""
    grid_shape = (2, 2, 2)
    rng = np.random.default_rng(0)
    v_scale, _, _ = common.drift_sizing(grid_shape, n_local, 0.9, migration)
    pos, _, alive = common.uniform_state(grid_shape, n_local, 0.9, rng)
    if bias:
        sink = np.asarray([0.25, 0.25, 0.25], np.float32)
        vel = ((sink[None, :] - pos) / s2 * 0.65).astype(np.float32)
    else:
        vel = (v_scale * (rng.random(pos.shape, dtype=np.float32) * 2.0
                          - 1.0)).astype(np.float32)
    return pos, vel, alive


def run(n_local: int = None, migration: float = 0.02, steps: int = 100,
        bias: bool = None, device=None) -> dict:
    """Time the loop and return the reference's keys: particles/s, ms a
    step, the exchange report, the health verdict, the flow snapshot and
    the fast-path hit rate (and, unbiased, the wire captures under
    ``"report"``)."""
    # headline imports this module for its captures
    from mpi_grid_redistribute_tpu_torch.bench import headline

    dev = _device.resolve(device)
    scale = float(os.environ.get("BENCH_SCALE", 1.0))
    n_local = n_local or max(1 << 12, int(scale * (1 << 20)))
    if bias is None:
        bias = os.environ.get("BENCH_DRIFT_BIAS") == "1"
    s2 = min(72, max(16, steps))
    loop = headline.device_pipeline(
        n_local, migration, 8, s2, 2, dev,
        state=start_state(n_local, migration, bias, s2))
    per_step, stats = loop["per_step"], loop["out"][3]
    report = report_lib.exchange_report(stats, headline.ROW_BYTES,
                                        step_seconds=per_step, domain="hbm",
                                        n_chips=1)
    if not bias:
        wire = canonical_wire_capture((2, 2, 2), migration, device=dev)
        report["wire_engine"] = wire.get("engine")
        report["wire_bytes_per_step"] = wire.get("wire_bytes_per_step")
        report["dense_wire_bytes_per_step"] = wire.get(
            "dense_wire_bytes_per_step")
        hwire = hierarchical_wire_capture((2, 2, 2), (2, 1, 1), migration,
                                          device=dev)
        report["hier_wire_engine"] = hwire.get("engine")
        report["dcn_bytes_per_step"] = hwire.get("dcn_bytes_per_step")
        report["ici_bytes_per_step"] = hwire.get("ici_bytes_per_step")
    rec, acc, monitor = headline.step_journal(stats, per_step)
    verdict = monitor.evaluate()
    common.write_journal_shard(rec, "config4_drift")
    res = {
        "metric": "config4_drift_pps_per_chip",
        "value": round(loop["total"] / per_step, 2),
        "unit": "particles/s",
        "n_total": loop["total"],
        "chips": 1,
        "ms_per_step": round(per_step * 1e3, 2),
        "report": report,
        "health": verdict,
        "flow": acc.snapshot(k=5),
    }
    hit = telemetry.fast_path_hit_rate(rec)
    if hit is not None:
        res["fast_path_hit_rate"] = round(hit, 4)
    if bias:
        res["metric"] = "config4_drift_bias_pps_per_chip"
        res["bias"] = True
    common.log(f"config4: {per_step * 1e3:.2f} ms/step, "
               f"health={verdict['status']}")
    return res


def run_rebalance(
    n_local: int = 4096,
    steps: int = 128,
    backend: str = "torch",
    threshold: float = 1.5,
    device=None,
) -> dict:
    """Closed-loop adaptive-rebalance leg (the reference's): twin service
    drivers share one seeded state and one convergent drift bias (slowed
    so the cloud never collapses to a point), the loop off and on. It
    proves the loop end to end: the ALERT fired and a ``rebalance``
    applied, the imbalance after it is <= 1.1x, the particle SET is
    bit-identical with the loop on and off, nothing dropped, and the
    steady ms/step (median of the last quarter of the journaled step
    walls) of both twins. The default ``backend="torch"`` runs the
    drivers on ``device`` (``None``: the GPU, raising without one);
    ``backend="numpy"`` is the reference's default, the host oracle
    loop."""
    from mpi_grid_redistribute_tpu_torch.service import elastic
    from mpi_grid_redistribute_tpu_torch.service.driver import (
        DriverConfig,
        ServiceDriver,
    )

    def one(rebalance: bool):
        cfg = DriverConfig(
            grid_shape=(2, 2, 2),
            n_local=n_local,
            fill=0.5,
            steps=steps,
            backend=backend,
            device=device,
            health_every=4,
            rebalance=rebalance,
            rebalance_threshold=threshold,
            rebalance_cells=8,
            rebalance_cooldown=16,
            # the saving is projected over the service horizon, not the
            # short leg, so the guard can fire inside the run
            rebalance_horizon=512,
        )
        drv = ServiceDriver(cfg)
        drv.init_state()
        pos, vel, ids, count = drv.host_state()
        # convergent flight plan into one shard, slowed so rows are only
        # ~60% of the way to the sink at run end
        sink = np.asarray([0.25, 0.25, 0.25], np.float32)
        vel = ((sink[None, :] - pos)
               / np.float32(1.6 * steps)).astype(np.float32)
        drv.state = drv._to_state(pos, vel, ids, count)
        drv.run()
        drv.close()
        dropped = sum(
            int(e.data.get("dropped", 0))
            for e in drv.recorder.events("step_latency")
        )
        lat = [
            float(e.data["seconds"])
            for e in drv.recorder.events("step_latency")
        ]
        steady = (
            float(np.median(lat[3 * len(lat) // 4:]))
            if lat else float("nan")
        )
        counts = drv.host_state()[3].astype(np.float64)
        return {
            "driver": drv,
            "steady_s": steady,
            "dropped": dropped,
            "final_imbalance": (
                float(counts.max() / counts.mean())
                if counts.mean() > 0 else 1.0
            ),
            "particle_set": elastic.particle_set(*drv.state),
            "out_capacity": int(drv._rd.out_capacity or n_local),
        }

    base = one(False)
    reb = one(True)
    drv = reb["driver"]
    events = [e.data for e in drv.recorder.events("rebalance")]
    applied = [e for e in events if e.get("applied")]
    alerts = [
        e for e in drv.recorder.events("alert")
        if e.data.get("rule") == "imbalance_ratio"
    ]
    res = {
        "metric": "config4_rebalance_steady_ms",
        "value": round(reb["steady_s"] * 1e3, 3),
        "unit": "ms/step",
        "steady_ms_per_step": round(reb["steady_s"] * 1e3, 3),
        "baseline_steady_ms_per_step": round(base["steady_s"] * 1e3, 3),
        "speedup": round(base["steady_s"] / reb["steady_s"], 3)
        if reb["steady_s"] > 0 else None,
        "alerts": len(alerts),
        "rebalances": len(events),
        "rebalances_applied": len(applied),
        "post_rebalance_imbalance": (
            max(float(e["realized_imbalance"]) for e in applied)
            if applied else None
        ),
        "final_imbalance": round(reb["final_imbalance"], 4),
        "baseline_final_imbalance": round(base["final_imbalance"], 4),
        "rows_moved": sum(int(e.get("rows_moved", 0)) for e in applied),
        "dropped": reb["dropped"] + base["dropped"],
        "out_capacity": reb["out_capacity"],
        "baseline_out_capacity": base["out_capacity"],
        "bit_identical": bool(
            reb["particle_set"] == base["particle_set"]
        ),
    }
    common.log(
        f"config4 rebalance: {res['steady_ms_per_step']:.3f} ms/step vs "
        f"{res['baseline_steady_ms_per_step']:.3f} no-rebalance, "
        f"{len(applied)} applied, post-imbalance "
        f"{res['post_rebalance_imbalance']}, "
        f"bit_identical={res['bit_identical']}"
    )
    return res


def rebalance_checks(res: dict) -> dict:
    """The rebalance leg's acceptance clauses, name -> held."""
    return {
        "imbalance_ratio ALERT fired": res["alerts"] >= 1,
        "a rebalance applied": res["rebalances_applied"] >= 1,
        "post-rebalance imbalance <= 1.1": (
            res["post_rebalance_imbalance"] is not None
            and res["post_rebalance_imbalance"] <= 1.1
        ),
        "zero dropped rows": res["dropped"] == 0,
        "particle set bit-identical": res["bit_identical"],
    }


def rebalance_smoke(backend: str = "torch", device=None, **kwargs) -> int:
    """The rebalance gate: run :func:`run_rebalance` and return 1 unless
    every clause of :func:`rebalance_checks` holds. The ms/step itself
    is not gated here (a smoke box's timing is noise)."""
    res = run_rebalance(backend=backend, device=device, **kwargs)
    print(json.dumps(res), flush=True)
    failed = [name for name, ok in rebalance_checks(res).items() if not ok]
    for name in failed:
        common.log(f"rebalance-smoke FAIL: {name}")
    if not failed:
        common.log("rebalance-smoke: all gates green")
    return 1 if failed else 0


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="config4_drift")
    p.add_argument("--rebalance", action="store_true",
                   help="run the closed-loop rebalance gate instead")
    p.add_argument("--backend", default="torch", choices=("torch", "numpy"),
                   help="the rebalance leg's driver backend (numpy: the "
                        "host oracle loop)")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    if args.rebalance:
        return rebalance_smoke(backend=args.backend, device=args.device)
    print(json.dumps(run(device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
