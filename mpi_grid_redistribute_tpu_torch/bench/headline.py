"""Headline benchmark of the port: particles redistributed per second per
card, the twin of the repository root's ``bench.py``.

    python -m mpi_grid_redistribute_tpu_torch.bench.headline

Prints ONE JSON line with exactly ``bench.py``'s keys. The workload is
``bench.py``'s: the periodic drift loop (``models.nbody.
make_migrate_loop`` with its default engine, the mover-sparse one on this
layout, so kernels 1 and 2 run every step) over a 2x2x2 grid run as 8
vranks on one card, ``BENCH_N_LOCAL`` rows a vrank (default 2^20) at 90%
fill, velocities sized for ``BENCH_MIGRATION`` (default 0.02) of the live
rows to cross a face a step at dt = 1.0, capacity and budget from
:func:`.common.drift_sizing`, the state drawn from ``default_rng(0)``.

Timing: :func:`..utils.profiling.time_per_step_samples` (CUDA events on
the card) over runs of ``BENCH_S1`` and ``BENCH_S2`` steps (8 and 72),
``BENCH_REPS`` (4) long runs; ``ms_per_step`` is the minimum,
``timing_spread`` (max - min) / min over ``timing_k`` samples.

``vs_baseline`` divides the card's rate by the port's NumPy oracle drift
loop (the 8-rank CPU stand-in of ``bench.py``'s ``time_cpu_oracle``, the
reference-equivalent digitize + stable argsort pipeline) over
``BENCH_BASELINE_N`` rows (default: the card run's population);
``vs_our_native_cpu`` and ``cpu_native_pps`` time the same loop on the
C++ host runtime (:mod:`..utils.native`), ``null`` when it cannot be
built. The exchange's bytes a step, rate and utilization are against the
card's HBM3 roof (``exchange_domain`` ``"hbm"``). After the timed
loop come two of the captures ``bench.py`` appends: ``stress``, config
7's full reshuffle (:func:`.config7_stress.run`; ``BENCH_STRESS=0``
skips it, ``BENCH_STRESS_N`` picks one size), and ``hier``, config 4's
hierarchical wire capture on a virtual two-pod split ``(2, 1, 1)``
(:func:`.config4_drift.hierarchical_wire_capture`; ``BENCH_HIER=0``
skips it), whose ``dcn_bytes_per_step``/``ici_bytes_per_step`` fill
``exchange_dcn_bytes_per_step``/``exchange_ici_bytes_per_step``.
``rebalance`` is config 4's closed-loop rebalance leg
(:func:`.config4_drift.run_rebalance` on the torch backend on the same
device, the reference's ``n_local`` 4096 and 128 steps;
``BENCH_REBALANCE=0`` skips it) and ``service`` config 10's capture
(:func:`.config10_service.run`, its ``BENCH_SERVICE_*`` knobs;
``BENCH_SERVICE=0`` skips it). ``soak`` is config 8's service soak
(:func:`.config8_soak.run` on the same device, its ``BENCH_SOAK_*``
knobs; ``BENCH_SOAK=0`` skips it). ``env`` fingerprints this machine
(:func:`..telemetry.regress.env_fingerprint`);
``progprofile_hash`` and ``attribution_hash`` hash TPU programs and are
``null``.

After timing it checks that no arrival was dropped, that the rows are
conserved and, on the card, that kernels 1 and 2 launched once a step;
a failed check raises. ``BENCH_JOURNAL_DIR=dir`` writes the run's journal
shard as ``bench.py`` does. It runs on the GPU and raises without one;
``measure(..., device="cpu")`` runs the plain versions on the CPU.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch import _device, oracle, telemetry
from mpi_grid_redistribute_tpu_torch.bench import (
    common, config4_drift, config7_stress, config8_soak, config10_service,
)
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.models import nbody
from mpi_grid_redistribute_tpu_torch.ops import _build
from mpi_grid_redistribute_tpu_torch.telemetry import regress
from mpi_grid_redistribute_tpu_torch.utils import native, profiling
from mpi_grid_redistribute_tpu_torch.utils.stats import host_arrays

GRID = tuple(int(x) for x in os.environ.get("BENCH_GRID", "2,2,2").split(","))
R = math.prod(GRID)
FILL = 0.9  # fraction of slots occupied; holes give arrival headroom
# K fused 4-byte columns a row: pos 3 + vel 3 + alive 1
ROW_BYTES = 4 * (2 * 3 + 1)
# the kernels of the loop's step (1: drift, wrap and bin; 2: the landing)
STEP_KERNELS = ("drift_wrap_bin", "overlay_scatter_planar")


def _initial_state(n_local: int, migration: float, rng):
    """The shared slab placement with velocities sized so ~``migration``
    of live rows cross a subdomain face a step (dt = 1)."""
    v_scale, _, _ = common.drift_sizing(GRID, n_local, FILL, migration)
    return common.uniform_state(GRID, n_local, FILL, rng, vel_scale=v_scale)


def step_journal(stats, per_step: float):
    """The loop's journal: migrate and fast-path steps, a flow snapshot
    and the step time. Returns ``(recorder, flow accumulator, health
    monitor)``."""
    rec = telemetry.StepRecorder()
    telemetry.record_migrate_steps(rec, stats, rank_totals=True)
    if stats.fast_path is not None:
        telemetry.record_fast_path_steps(rec, stats)
    acc = telemetry.FlowAccumulator()
    acc.update(stats)
    telemetry.record_flow_snapshot(rec, acc)
    monitor = telemetry.HealthMonitor(rec)
    monitor.note_step_time(per_step)
    return rec, acc, monitor


def device_pipeline(n_local: int, migration: float, s1: int, s2: int,
                    reps: int, device=None, state=None) -> dict:
    """Time the drift loop on ``device`` and check its output. ``state``
    is the start ``(pos [N, 3], vel [N, 3], alive [N])`` as NumPy rows
    (default: :func:`_initial_state` from ``default_rng(0)``). Returns
    ``per_step`` (s), the timing ``detail``, the long run's output
    ``out`` (planar pos, vel, alive, stats), ``total`` live rows and
    ``xbytes`` a step."""
    dev = _device.resolve(device)
    _, cap, budget = common.drift_sizing(GRID, n_local, FILL, migration)
    cfg = nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True),
        grid=ProcessGrid((1,) * len(GRID)), dt=1.0, capacity=cap,
        n_local=n_local, local_budget=budget,
    )
    vgrid = ProcessGrid(GRID)
    if state is None:
        state = _initial_state(n_local, migration, np.random.default_rng(0))
    pos, vel, alive = state
    inputs = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in (nbody.rows_to_planar(pos, 1),
                             nbody.rows_to_planar(vel, 1), alive))

    def make_run(S):
        loop = nbody.make_migrate_loop(cfg, S, vgrid=vgrid, device=dev)
        return lambda: loop(*inputs)

    before = _build.counts()
    t0 = time.perf_counter()
    detail, out = profiling.time_per_step_samples(make_run, s1, s2, reps,
                                                  device=dev)
    wall = time.perf_counter() - t0
    after = _build.counts()
    steps = (reps + 1) * (s1 + s2)  # a warm-up and ``reps`` runs a length
    launches = {k: (after.get(k, 0) - before.get(k, 0)) / steps
                for k in STEP_KERNELS}
    per_step = detail["min"]
    stats = out[3]
    sent, backlog, dropped, pop = host_arrays(
        [stats.sent, stats.backlog, stats.dropped_recv, stats.population])
    live = int(host_arrays([out[2].sum()])[0])
    total = int(FILL * n_local) * R
    xbytes = profiling.exchange_bytes_per_step(stats, ROW_BYTES)
    common.log(
        f"device: 1 card, grid {GRID} as vranks, n/slab={n_local}, "
        f"cap/pair={cap}, budget={budget}, timing wall {wall:.1f} s")
    common.log(
        f"  per-step {per_step * 1e3:.4f} ms (spread "
        f"{detail['spread'] * 100:.1f}% over k={detail['k']}); "
        f"migration/step {sent.sum(axis=1).mean() / total:.3%} (backlog "
        f"{int(backlog.sum())}, dropped {int(dropped.sum())}); exchange "
        f"{xbytes / 1e6:.2f} MB/step (hbm); kernel launches a step "
        f"{launches}")
    if int(dropped.sum()):
        raise RuntimeError(f"{int(dropped.sum())} arrivals dropped")
    if live != total or not (pop.sum(axis=1) == total).all():
        raise RuntimeError(
            f"rows not conserved: {live} live, populations "
            f"{pop.sum(axis=1).tolist()}, {total} placed")
    if dev.type == "cuda":
        for k, n in launches.items():
            if n != 1:
                raise RuntimeError(f"kernel {k} launched {n} times a step")
    return dict(per_step=per_step, detail=detail, out=out, total=total,
                xbytes=xbytes)


def time_cpu_oracle(n_total: int, migration: float, n_steps: int = 5,
                    native_ok: bool = False) -> float:
    """Particles/s of the 8-rank CPU oracle drift loop, the CPU-MPI
    stand-in: ``native_ok=False`` is the reference-equivalent NumPy
    pipeline (digitize, stable argsort, buffer copies), ``True`` the C++
    host runtime."""
    grid = ProcessGrid(GRID)
    domain = Domain(0.0, 1.0, periodic=True)
    n_local = n_total // R
    cap = n_local
    pos, vel, _ = _initial_state(n_local, migration, np.random.default_rng(0))
    # the card run's fill: keep the live prefix of each slab
    n_live = int(FILL * n_local)
    keep = np.tile(np.arange(n_local) < n_live, R)
    pos, vel = pos[keep], vel[keep]
    n_local = n_live
    count = np.full((R,), n_local, dtype=np.int32)

    def one_step(pos, vel, count):
        pos = (pos + vel * np.float32(1.0)) % np.float32(1.0)
        pos, count, (vel,), _ = oracle.redistribute_oracle_padded(
            domain, grid, pos, count, [vel], cap, n_local,
            native_ok=native_ok)
        return pos, vel, count

    pos, vel, count = one_step(pos, vel, count)  # warm
    t0 = time.perf_counter()
    for _ in range(n_steps):
        pos, vel, count = one_step(pos, vel, count)
    return (R * n_local) / ((time.perf_counter() - t0) / n_steps)


def measure(n_local=None, device=None, migration=None, s1=None, s2=None,
            reps=None, baseline_n=None) -> dict:
    """The headline dict (``bench.py``'s keys); arguments left ``None``
    come from the environment (``BENCH_*``) or the defaults."""
    dev = _device.resolve(device)
    env = os.environ
    n_local = int(n_local or env.get("BENCH_N_LOCAL", 2 ** 20))
    migration = float(migration or env.get("BENCH_MIGRATION", 0.02))
    s1 = int(s1 or env.get("BENCH_S1", 8))
    s2 = int(s2 or env.get("BENCH_S2", 72))
    reps = int(reps or env.get("BENCH_REPS", 4))
    # the CPU comparator prices the card run's population
    baseline_n = int(baseline_n or env.get("BENCH_BASELINE_N", R * n_local))

    run = device_pipeline(n_local, migration, s1, s2, reps, dev)
    per_step, xbytes = run["per_step"], run["xbytes"]
    if env.get("BENCH_JOURNAL_DIR"):
        common.write_journal_shard(step_journal(run["out"][3], per_step)[0],
                                   "bench_headline")
    pps = run["total"] / per_step
    common.log(f"device pipeline: {pps:.6e} particles/s")
    cpu_pps = time_cpu_oracle(baseline_n, migration, native_ok=False)
    common.log(f"8-rank CPU baseline (reference-equivalent numpy): "
               f"{cpu_pps:.6e} particles/s")
    cpu_native_pps = None
    if native.build():
        cpu_native_pps = time_cpu_oracle(baseline_n, migration,
                                         native_ok=True)
        common.log(f"8-rank CPU with the C++ host runtime: "
                   f"{cpu_native_pps:.6e} particles/s")
    else:
        common.log("C++ host runtime not built (g++ failed or "
                   "MPI_GRID_NO_NATIVE set): cpu_native_pps and "
                   "vs_our_native_cpu are null")
    # the full-reshuffle stress (config 7): the exchange's utilization
    # when nearly every row moves every step
    stress = None
    if env.get("BENCH_STRESS", "1") != "0":
        stress = config7_stress.run(device=dev)
    # the two-level wire of config 4's capture: the same ~2% drift
    # workload on a virtual two-pod split of the grid
    hier = None
    if env.get("BENCH_HIER", "1") != "0":
        hier = config4_drift.hierarchical_wire_capture(
            (2, 2, 2), (2, 1, 1), migration, device=dev)
    # the closed-loop rebalance leg (config 4) and the chunked service
    # capture (config 10), through the service driver on this device
    rebalance = None
    if env.get("BENCH_REBALANCE", "1") != "0":
        rebalance = config4_drift.run_rebalance(backend="torch", device=dev)
    service = None
    if env.get("BENCH_SERVICE", "1") != "0":
        service = config10_service.run(device=dev)
    # the service soak (config 8): the driver loop with snapshots on,
    # and its crash, elastic and corruption legs
    soak = None
    if env.get("BENCH_SOAK", "1") != "0":
        soak = config8_soak.run(device=dev)
    n_chips = 1
    line = {
        "metric": "particles_per_sec_per_chip",
        "value": round(pps / n_chips, 2),
        "unit": "particles/s",
        "vs_baseline": round(pps / cpu_pps, 3),
        "vs_our_native_cpu": (None if cpu_native_pps is None
                              else round(pps / cpu_native_pps, 3)),
        "baseline_n": baseline_n,
        "cpu_pps": round(cpu_pps, 2),
        "cpu_native_pps": (None if cpu_native_pps is None
                           else round(cpu_native_pps, 2)),
        "ms_per_step": round(per_step * 1e3, 3),
        "timing_spread": round(run["detail"]["spread"], 4),
        "timing_k": run["detail"]["k"],
        "exchange_bytes_per_step": round(xbytes, 1),
        "exchange_bytes_per_sec": round(xbytes / per_step, 1),
        "exchange_domain": "hbm",
        "exchange_bw_util": round(
            profiling.exchange_bw_util(xbytes / per_step, "hbm", n_chips), 6),
        "stress": stress,
        "soak": soak,
        "rebalance": rebalance,
        "service": service,
        "hier": hier,
        "exchange_dcn_bytes_per_step": (
            hier.get("dcn_bytes_per_step") if hier else None),
        "exchange_ici_bytes_per_step": (
            hier.get("ici_bytes_per_step") if hier else None),
        "env": regress.env_fingerprint(dev),
        "progprofile_hash": None,
        "attribution_hash": None,
    }
    return line


def main() -> int:
    print(json.dumps(measure()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
