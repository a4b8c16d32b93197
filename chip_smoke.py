#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout. It builds the port's CUDA kernels from
``mpi_grid_redistribute_tpu_torch/csrc`` (one ``nvcc`` per source, all
started together), then, on the card:

  1. holds each kernel against its plain PyTorch version, bit for bit, at
     the shapes of the main path and on a hostile input, and times the
     kernel, the plain version and (where one exists) one PyTorch library
     call computing the same function, beside the least time the card
     could take (``bound_ms``); kernel 6 (the row scatter) at the rows
     route's shape, the bench state as row-major ``[8388608, 7]``, timed
     with its ``index_put_`` yardstick as replayed CUDA graphs (the
     device's time; eager launches beside it);
  2. drives the bench configuration (a 2x2x2 grid as 8 vranks on one
     device, 2^20 rows per vrank at 90% fill, ~2% migration per step,
     dt = 1.0) through the user entry point
     ``models.nbody.make_migrate_loop``, twice:
     - with ``engine="planar"`` (the dense step, a comparison run):
       timed per step, a counted run whose kernel launches equal its
       steps, conservation, ownership, zero dropped arrivals, and bit
       equality with the same loop on the plain versions;
     - with the default engine (``"auto"``, the mover-sparse engine on
       this layout: the MAIN PATH): the same checks, host syncs per step
       (1, the engine's guard), the share of steps on the fast branch, and
       bit equality with the planar run;
  3. steps the row-store landing route (``shard_migrate_vranks_fn(...,
     scatter_impl="rows")`` on the legacy float32 state, dest keys from
     kernel 1): timed per step, a counted run launching kernel 6 once per
     step, the same checks, and bit equality with its plain-version run
     and with the int32 planar loop;
  4. checks the card's loop against the port's CPU run (plain versions,
     which the CPU tests hold bit-equal to the JAX package) at a small
     width, for both engines;
  5. holds the deposit kernels against their plain versions at the
     config-5 shapes (the double-float tile scan at [262144, 256], bit
     for bit; the segmented deposit on the config-5 slab stream, bit for
     bit on dyadic data and within 2e-5 otherwise, and run-to-run
     identical), and drives config 5 (the loop with its default engine
     and the CIC deposit onto a 128^3 mesh fused into every step) through
     ``make_migrate_loop`` with ``deposit_method="mxu"`` and ``"scan"``:
     timed per step, host syncs per step, a counted run whose deposit
     kernel launches equal its steps, mass conservation, the state
     bit-equal to the loop without deposit, and the density held against
     the plain-version run and across the two methods.

Any failed check raises; nothing is caught and carried on. The last
lines are the ``nvidia-smi`` name and power limit, one JSON object with
every kernel's numbers, and ``{"ok": true, "device": {...}}``. Exits
non-zero without printing a result when no CUDA device is present or the
package is not beside this script. ``--profile DIR`` also writes a
``torch.profiler`` kernel table of a few steps of each loop to DIR, with
the deposit's share of the config-5 step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# the bench configuration (bench.py: GRID, FILL, migration, dt)
GRID = (2, 2, 2)
N_LOCAL = 1 << 20
FILL = 0.9
MIGRATION = 0.02
DT = 1.0
COUNTED_STEPS = 6
# kernels the drift/migrate loop (either engine) launches once per step
MIGRATE_KERNELS = ("drift_wrap_bin", "overlay_scatter_planar")
# kernels the row-store landing route launches once per step
ROWS_KERNELS = ("drift_wrap_bin", "scatter_rows")
# config 5: the deposit kernel each method launches once per step
DEPOSIT_KERNEL = {"mxu": "segsum_sorted", "scan": "tile_df_cumsum_rows"}

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound(bytes_moved: float, ops: float):
    """``(bound_ms, bound_by)``: the larger of the memory and compute
    times at the card's peak rates."""
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> float:
    """Largest |a - b| over entries that are finite on both sides, with
    mismatched non-finite bit patterns counted as infinite error."""
    import torch

    a64, b64 = a.double(), b.double()
    fin = torch.isfinite(a64) & torch.isfinite(b64)
    err = (a64 - b64).abs()[fin].max().item() if fin.any() else 0.0
    if a.dtype == torch.float32:
        nonfin_a = a.view(torch.int32)[~fin]
        nonfin_b = b.view(torch.int32)[~fin]
        if not torch.equal(nonfin_a, nonfin_b):
            err = float("inf")
    return float(err)


def driftbin_phase(torch, pt, driftbin, profiling, state_np):
    """Kernel 1 at the main-path shape and on a hostile input."""
    Domain, ProcessGrid = pt.Domain, pt.ProcessGrid
    V = int(np.prod(GRID))
    domain = Domain(0.0, 1.0, periodic=True)
    grid = ProcessGrid(GRID)
    flat0 = torch.from_numpy(state_np).cuda()
    m = flat0.shape[1]
    fk, kk = driftbin.drift_wrap_bin(flat0.clone(), DT, domain, grid, V, V)
    fp, kp = driftbin.drift_wrap_bin_plain(
        flat0.clone(), DT, domain, grid, V, V
    )
    torch.cuda.synchronize()
    check(torch.equal(fk, fp) and torch.equal(kk, kp),
          "drift_wrap_bin kernel != plain at the bench shape")
    err = max(
        max_abs_err(fk[:3].view(torch.float32), fp[:3].view(torch.float32)),
        max_abs_err(kk, kp),
    )

    # hostile: mixed periodic/open axes, a non-power-of-two extent, a
    # ragged width, +-inf / NaN / huge values, any dt (neither side fuses)
    hd = Domain((0.0, -2.0, 1.0), (1.0, 2.0, 4.7), periodic=(True, False, True))
    hg = ProcessGrid((2, 2, 1))
    r = np.random.default_rng(7)
    hn = 4099
    hp = ((r.random((3, 4 * hn), dtype=np.float32) * 2 - 0.5) * 3).astype(
        np.float32
    )
    hostile = np.array([np.inf, -np.inf, np.nan, 1e10, -1e10, 3e38],
                       np.float32)
    for d in range(3):
        hp[d, d * 64 : d * 64 + hostile.size * 8] = np.repeat(hostile, 8)
    hv = (r.random((3, 4 * hn), dtype=np.float32) - 0.5).astype(np.float32)
    ha = (r.random(4 * hn) < 0.9).astype(np.int32)
    hflat = torch.from_numpy(np.concatenate(
        [hp.view(np.int32), hv.view(np.int32), ha[None]], axis=0
    )).cuda()
    for dt in (1.0, 0.05):
        a = driftbin.drift_wrap_bin(hflat.clone(), dt, hd, hg, 4, 4)
        b = driftbin.drift_wrap_bin_plain(hflat.clone(), dt, hd, hg, 4, 4)
        torch.cuda.synchronize()
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"drift_wrap_bin kernel != plain on the hostile input, dt={dt}")

    work = flat0.clone()
    ms = profiling.cuda_time_ms(
        lambda: driftbin.drift_wrap_bin(work, DT, domain, grid, V, V)
    )
    plain_ms = profiling.cuda_time_ms(
        lambda: driftbin.drift_wrap_bin_plain(work, DT, domain, grid, V, V),
        iters=5,
    )
    D = 3
    bytes_moved = m * 4 * ((2 * D + 1) + (D + 1))
    # per column: D x (mul, add, sub, mul, floor, mul, compare/select,
    # add) per wrap twice + the bin's sub, mul, floor, clip, mul-add
    ops = m * D * (2 * 8 + 6)
    b_ms, b_by = bound(bytes_moved, ops)
    return {
        "name": "drift_wrap_bin",
        "route": "cuda",
        "source": "mpi_grid_redistribute_tpu_torch/csrc/driftbin.cu",
        "replaces": "mpi_grid_redistribute_tpu/ops/pallas_driftbin.py:131",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }


def overlay_phase(torch, overlay, profiling, budget):
    """Kernel 2 at the main-path shape: V * P unique targets into the
    [7, V * n] state, plus drops."""
    V = int(np.prod(GRID))
    K, m = 7, V * N_LOCAL
    P = V * budget
    g = torch.Generator(device="cuda").manual_seed(3)
    flat0 = torch.randint(-(2**31), 2**31 - 1, (K, m), dtype=torch.int32,
                          device="cuda", generator=g)
    targets = torch.randperm(m, device="cuda", generator=g)[:P].to(
        torch.int32
    )
    drop = torch.rand(P, device="cuda", generator=g) < 0.1
    targets = torch.where(drop, torch.full_like(targets, m), targets)
    targets[:16] = -1
    cols = torch.randint(-(2**31), 2**31 - 1, (K, P), dtype=torch.int32,
                         device="cuda", generator=g)
    a = overlay.overlay_scatter_planar(flat0.clone(), targets, cols)
    b = overlay.overlay_scatter_planar_plain(flat0.clone(), targets, cols)
    torch.cuda.synchronize()
    check(torch.equal(a, b), "overlay kernel != plain (int32)")
    af = overlay.overlay_scatter_planar(
        flat0.clone().view(torch.float32), targets, cols.view(torch.float32)
    )
    bf = overlay.overlay_scatter_planar_plain(
        flat0.clone().view(torch.float32), targets, cols.view(torch.float32)
    )
    torch.cuda.synchronize()
    check(torch.equal(af.view(torch.int32), bf.view(torch.int32)),
          "overlay kernel != plain (float32 bit patterns)")
    err = max_abs_err(a, b)

    work = flat0.clone()
    ms = profiling.cuda_time_ms(
        lambda: overlay.overlay_scatter_planar(work, targets, cols)
    )
    plain_ms = profiling.cuda_time_ms(
        lambda: overlay.overlay_scatter_planar_plain(work, targets, cols)
    )
    ok = (targets >= 0) & (targets < m)
    t_ok = targets[ok].long()
    c_ok = cols[:, ok].contiguous()
    rows = torch.arange(K, device="cuda")[:, None]
    library_ms = profiling.cuda_time_ms(
        lambda: work.index_put_((rows, t_ok[None, :]), c_ok)
    )
    # the same updates in ascending target order: neighbouring threads
    # then write nearby columns, which separates write locality from the
    # per-word sector cost as the cause of the kernel's distance to bound
    perm = torch.argsort(targets)
    t_sorted = targets[perm].contiguous()
    c_sorted = cols[:, perm].contiguous()
    sorted_ms = profiling.cuda_time_ms(
        lambda: overlay.overlay_scatter_planar(work, t_sorted, c_sorted)
    )
    log(f"overlay_scatter_planar: {ms:.5f} ms on random targets, "
        f"{sorted_ms:.5f} ms on the same targets sorted")
    n_ok = int(ok.sum())
    bytes_moved = 4 * P + 4 * K * P + 4 * K * n_ok
    b_ms, b_by = bound(bytes_moved, 0)
    return {
        "name": "overlay_scatter_planar",
        "route": "cuda",
        "source": "mpi_grid_redistribute_tpu_torch/csrc/overlay.cu",
        "replaces": "mpi_grid_redistribute_tpu/ops/pallas_overlay.py:317",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library_ms,
    }


def scatter_phase(torch, scatter, profiling, state_np, budget):
    """Kernel 6 at the rows route's shape: the bench state as row-major
    float32 [V * n, 7], V * P plan entries of which ~2% of the live rows
    are unique in-range targets and the rest the sentinel n_rows, plus
    negative targets and rows of NaN, +-inf and denormal bit patterns."""
    V = int(np.prod(GRID))
    flat0 = torch.from_numpy(state_np).cuda().view(torch.float32).T
    flat0 = flat0.contiguous()  # [m, 7] row-major
    m, K = flat0.shape
    P = V * budget
    live = int(state_np[-1].sum())
    n_in = int(round(MIGRATION * live))
    g = torch.Generator(device="cuda").manual_seed(6)
    targets = torch.full((P,), m, dtype=torch.int32, device="cuda")
    slots = torch.randperm(P, device="cuda", generator=g)
    targets[slots[:n_in]] = torch.randperm(m, device="cuda", generator=g)[
        :n_in].to(torch.int32)
    targets[slots[n_in : n_in + 16]] = -1
    targets[slots[n_in + 16 : n_in + 32]] = m + 5
    rows = torch.randint(-(2**31), 2**31 - 1, (P, K), dtype=torch.int32,
                         device="cuda", generator=g)
    hostile = torch.tensor(
        [0x7FC0BEEF, 0x7F800000, 0xFF800000 - 2**32, 0x00000001, 0x807FFFFF
         - 2**32, 0x7FBFFFFF, 0, -(2**31)], dtype=torch.int32, device="cuda",
    )
    rows[slots[: hostile.numel() * 64]] = hostile.repeat(64)[:, None]
    rows = rows.view(torch.float32)
    a = scatter.scatter_rows(flat0.clone(), targets, rows)
    b = scatter.scatter_rows_plain(flat0.clone(), targets, rows)
    torch.cuda.synchronize()
    check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
          "scatter_rows kernel != plain at the rows route's shape")
    err = max_abs_err(a, b)
    # the other word sizes and a ragged shape the TPU kernel refuses, each
    # with one warp's 32 targets all dropped
    for dt, n_rows, k in ((torch.float64, 4099, 3), (torch.int16, 8200, 9),
                          (torch.uint8, 777, 1), (torch.float32, 5003, 7)):
        f = torch.randint(0, 100, (n_rows, k), device="cuda",
                          generator=g).to(dt)
        r = torch.randint(0, 100, (500, k), device="cuda", generator=g).to(dt)
        t = torch.randperm(n_rows + 40, device="cuda", generator=g)[
            :500].to(torch.int32)
        t[:9] = -7
        t[32:64] = n_rows
        check(torch.equal(scatter.scatter_rows(f.clone(), t, r),
                          scatter.scatter_rows_plain(f.clone(), t, r)),
              f"scatter_rows kernel != plain for {dt} [{n_rows}, {k}]")

    # a ~10 us kernel: eager launches (PR 3's method) time the host's
    # launch cost as much as the device, so the kernel and index_put_ are
    # timed as replayed CUDA graphs of the same 20 calls
    work = flat0.clone()

    def kernel():
        scatter.scatter_rows(work, targets, rows)

    ms = profiling.cuda_graph_time_ms(kernel)
    eager_ms = profiling.cuda_time_ms(kernel)
    plain_ms = profiling.cuda_time_ms(
        lambda: scatter.scatter_rows_plain(work, targets, rows)
    )
    ok = (targets >= 0) & (targets < m)
    t_ok = targets[ok].long()
    r_ok = rows[ok].contiguous()

    def library():
        work.index_put_((t_ok,), r_ok)

    library_ms = profiling.cuda_graph_time_ms(library)
    library_eager_ms = profiling.cuda_time_ms(library)
    log(f"scatter_rows: kernel {ms:.5f} ms as a CUDA graph, {eager_ms:.5f} "
        f"ms eager; index_put_ {library_ms:.5f} ms as a graph, "
        f"{library_eager_ms:.5f} ms eager")
    n_ok = int(ok.sum())
    # the targets, and the in-range rows read once and written once (the
    # dropped rows are never needed)
    b_ms, b_by = bound(4 * P + 2 * 4 * K * n_ok, 0)
    log(f"scatter_rows: {n_ok} in-range of {P} targets into [{m}, {K}]")
    return {
        "name": "scatter_rows",
        "route": "cuda",
        "source": "mpi_grid_redistribute_tpu_torch/csrc/scatter.cu",
        "replaces": "mpi_grid_redistribute_tpu/ops/pallas_scatter.py:112",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library_ms,
    }


def rows_route_phase(torch, pt, migrate, driftbin, _build, profiling,
                     inputs, cap, budget, planar_out, profile_dir):
    """The row-store landing route: ``shard_migrate_vranks_fn(...,
    scatter_impl="rows")`` stepped on the legacy float32 fused state of
    the bench start, each step's dest key from kernel 1 on the int32 view
    of the same storage (as ``make_migrate_loop`` feeds it)."""
    label = "rows route"
    V = int(np.prod(GRID))
    domain = pt.Domain(0.0, 1.0, periodic=True)
    vgrid = pt.ProcessGrid(GRID)
    pos, vel, alive = inputs
    total = int(alive.sum().item())
    fused0 = torch.cat([pos.reshape(3, -1), vel.reshape(3, -1),
                        alive.float()[None]])  # float32 [7, V * n]

    def make_run(S, plain=False):
        mig = migrate.shard_migrate_vranks_fn(
            domain, pt.ProcessGrid((1, 1, 1)), vgrid, cap,
            local_budget=budget, scatter_impl="rows", plain=plain,
        )
        bin_fn = (driftbin.drift_wrap_bin_plain if plain
                  else driftbin.drift_wrap_bin)

        def run():
            state = migrate.init_state(fused0.clone(), vranks=V, batched=True)
            steps = []
            for _ in range(S):
                f, key = bin_fn(state.fused.view(torch.int32), DT, domain,
                                vgrid, V, V)
                state, st = mig(state._replace(fused=f.view(torch.float32)),
                                key)
                steps.append(st)
            return state, steps

        return run

    detail, _ = profiling.cuda_time_per_step_samples(
        make_run, s1=2, s2=12, reps=3
    )
    per_step = detail["min"]
    log(f"{label}: {per_step * 1e3:.4f} ms/step (min of k={detail['k']}, "
        f"median {detail['median'] * 1e3:.4f}, spread "
        f"{detail['spread'] * 100:.2f}%), {total / per_step:.6g} "
        f"particles/s")

    _, syncs2 = synced_run(torch, make_run(2))
    _build.reset_counts()
    (state, steps), syncs = synced_run(torch, make_run(COUNTED_STEPS))
    launches = _build.counts()
    syncs = (syncs - syncs2) / (COUNTED_STEPS - 2)
    log(f"{label}: launches over {COUNTED_STEPS} steps: {launches}; host "
        f"syncs per step {syncs:g}")
    check_launches(launches, ROWS_KERNELS, label)
    check(state.fused.dtype == torch.float32, f"{label}: state not float32")
    stats = type(steps[0])(*[
        None if getattr(steps[0], f) is None
        else torch.stack([getattr(st, f) for st in steps])
        for f in steps[0]._fields
    ])
    fi = state.fused.view(torch.int32)
    out = (fi[:3].reshape(-1).view(torch.float32),
           fi[3:6].reshape(-1).view(torch.float32), state.fused[-1] > 0,
           stats)
    check_state(torch, label, out[0], out[2], stats, total)
    check(torch.equal(state.fused[-1][state.fused[-1] > 0],
                      torch.ones(total, device="cuda")),
          f"{label}: alive row is not 1.0/0.0")

    ref_state, ref_steps = make_run(COUNTED_STEPS, plain=True)()
    torch.cuda.synchronize()
    check(torch.equal(fi, ref_state.fused.view(torch.int32))
          and torch.equal(state.free_stack, ref_state.free_stack)
          and torch.equal(state.n_free, ref_state.n_free),
          f"{label}: state differs from the plain-version run")
    for i, (a, b) in enumerate(zip(steps, ref_steps)):
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            check((x is None and y is None) or torch.equal(x, y),
                  f"{label}: step {i} stat {f} differs from the plain run")
    # the int32 planar loop from the same start: positions and velocities
    # as int32, the alive rows as masks, the stats exactly
    check_same_run(torch, label, out, planar_out, "the int32 planar loop")
    log(f"{label}: bit-equal to the plain-version run and to the int32 "
        f"planar loop over {COUNTED_STEPS} steps")
    busy = None
    if profile_dir:
        busy = write_profile(torch, make_run, profile_dir, per_step,
                             "rows_route")
    return {
        "ms_per_step": per_step * 1e3,
        "median_ms_per_step": detail["median"] * 1e3,
        "spread": detail["spread"],
        "particles_per_s": total / per_step,
        "host_syncs_per_step": syncs,
        "launches": launches,
        "device_busy_ms_per_step": busy,
    }


def synced_run(torch, run):
    """``(out, syncs)``: ``run()`` under torch's sync debug mode, with the
    number of synchronizing operations it reported."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in caught)


def check_launches(launches, kernels, label):
    for name, n in launches.items():
        want = COUNTED_STEPS if name in kernels else 0
        check(n == want,
              f"{label}: {name} launched {n} times in {COUNTED_STEPS} steps")


def check_state(torch, label, pos_f, alive_f, stats, total):
    """Conservation, zero drops, the stats' own accounting, finite
    positions and ownership (computed independently of the port's
    binning) of a ``COUNTED_STEPS`` run's output."""
    check(int(alive_f.sum()) == total, f"{label}: alive count not conserved")
    check(int(stats.dropped_recv.sum()) == 0, f"{label}: arrivals dropped")
    check(torch.equal(stats.population.sum(dim=1),
                      torch.full((COUNTED_STEPS,), total, dtype=torch.int32,
                                 device="cuda")),
          f"{label}: population stat disagrees with the alive count")
    check(torch.equal(stats.sent.sum(dim=1), stats.received.sum(dim=1)),
          f"{label}: sent != received")
    check(bool(torch.isfinite(pos_f).all()), f"{label}: non-finite positions")
    p = pos_f.reshape(3, -1)
    g = torch.tensor(GRID, device="cuda")[:, None]
    cell = torch.floor(p.double() * g).long().clamp_min(0)
    cell = torch.minimum(cell, g - 1)
    owner = cell[0] * GRID[1] * GRID[2] + cell[1] * GRID[2] + cell[2]
    slot = torch.arange(p.shape[1], device="cuda") // N_LOCAL
    check(bool((owner[alive_f] == slot[alive_f]).all()),
          f"{label}: a live row sits on a vrank that does not own its "
          f"position")


def check_same_run(torch, label, out, ref, what):
    """State bits and every stat (but ``fast_path``) of two loop runs."""
    for name, a, b in zip(("pos", "vel", "alive"), out[:3], ref[:3]):
        check(torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
              f"{label}: {name} differs from {what}")
    for f in out[3]._fields:
        a, b = getattr(out[3], f), getattr(ref[3], f)
        if f == "fast_path" and (a is None or b is None):
            continue  # the planar engine has no fast path
        check((a is None and b is None) or torch.equal(a, b),
              f"{label}: stat {f} differs from {what}")


def loop_path_phase(torch, pt, nbody, migrate, _build, profiling, inputs,
                    cap, budget, engine, profile_dir, planar_out=None):
    """The bench configuration through ``make_migrate_loop`` with
    ``engine``: ``"auto"`` (the default, the mover-sparse engine here:
    the main path) or ``"planar"`` (the dense step)."""
    cfg = nbody.DriftConfig(
        domain=pt.Domain(0.0, 1.0, periodic=True),
        grid=pt.ProcessGrid((1, 1, 1)), dt=DT, capacity=cap,
        n_local=N_LOCAL, local_budget=budget, engine=engine,
    )
    label = f"{engine} path"
    vgrid = pt.ProcessGrid(GRID)
    pos, vel, alive = inputs
    total = int(alive.sum().item())

    def make_run(S, plain=False):
        loop = nbody.make_migrate_loop(cfg, S, vgrid=vgrid, plain=plain)
        return lambda: loop(pos, vel, alive)

    # the step is host-bound (hundreds of small launches), so host
    # jitter is the noise: long runs, many samples, min of k
    detail, _ = profiling.cuda_time_per_step_samples(
        make_run, s1=4, s2=36, reps=7 if engine == "auto" else 5
    )
    per_step = detail["min"]
    log(f"{label}: {per_step * 1e3:.4f} ms/step (min of k={detail['k']}, "
        f"median {detail['median'] * 1e3:.4f}, "
        f"spread {detail['spread'] * 100:.2f}%), "
        f"{total / per_step:.6g} particles/s, {total} particles")
    log(f"{label} per-step samples (s): {detail['values']}")

    plain_detail, _ = profiling.cuda_time_per_step_samples(
        lambda S: make_run(S, plain=True), s1=4, s2=20, reps=3
    )
    log(f"{label} on plain versions: {plain_detail['min'] * 1e3:.4f} "
        f"ms/step")

    # ---- host syncs per step (runs of 2 and COUNTED_STEPS, differenced)
    # and the counted run: every kernel of the path launches once a step
    guard0 = migrate.HOST_SYNCS["sparse_guard"]
    _, syncs2 = synced_run(torch, make_run(2))
    guard2 = migrate.HOST_SYNCS["sparse_guard"]
    _build.reset_counts()
    out, syncs = synced_run(torch, make_run(COUNTED_STEPS))
    launches = _build.counts()
    syncs = (syncs - syncs2) / (COUNTED_STEPS - 2)
    guard = (migrate.HOST_SYNCS["sparse_guard"] - guard2 - (guard2 - guard0)) \
        / (COUNTED_STEPS - 2)
    log(f"{label}: launches over {COUNTED_STEPS} steps: {launches}; host "
        f"syncs per step {syncs:g} (sparse-guard reads {guard:g})")
    check_launches(launches, MIGRATE_KERNELS, label)
    want_syncs = 1 if engine == "auto" else 0
    check(syncs == want_syncs and guard == want_syncs,
          f"{label}: {syncs:g} host syncs and {guard:g} guard reads per "
          f"step, expected {want_syncs}")
    pos_f, _, alive_f, stats = out
    check_state(torch, label, pos_f, alive_f, stats, total)
    sent = stats.sent.sum(dim=1).tolist()
    log(f"{label}: migrants per step: {sent} ({np.mean(sent) / total:.4%} "
        f"of live rows), backlog {int(stats.backlog.sum())}")
    fast_share = None
    if engine == "auto":
        fp = stats.fast_path[:, 0]
        fast_share = float(fp.float().mean())
        log(f"{label}: fast-path share {fast_share:.4f} "
            f"({int(fp.sum())} of {COUNTED_STEPS} steps)")
        for i in torch.nonzero(fp == 0).flatten().tolist():
            movers = stats.sent[i] + stats.backlog[i]
            log(f"{label}: step {i} ran dense: movers per vrank max "
                f"{int(movers.max())} (block {budget}), arrivals max "
                f"{int(stats.received[i].max())}, backlog "
                f"{int(stats.backlog[i].sum())}")

    ref = make_run(COUNTED_STEPS, plain=True)()
    torch.cuda.synchronize()
    check_same_run(torch, label, out, ref, "the plain-version run")
    if planar_out is not None:
        check_same_run(torch, label, out, planar_out, "the planar loop")

    busy = None
    if profile_dir:
        busy = write_profile(torch, make_run, profile_dir, per_step,
                             label.replace(" ", "_"))
    return {
        "engine": engine,
        "ms_per_step": per_step * 1e3,
        "median_ms_per_step": detail["median"] * 1e3,
        "spread": detail["spread"],
        "plain_ms_per_step": plain_detail["min"] * 1e3,
        "particles_per_s": total / per_step,
        "particles": total,
        "host_syncs_per_step": syncs,
        "fast_path_share": fast_share,
        "launches": launches,
        "device_busy_ms_per_step": busy,
    }, out


def profile_steps(torch, make_run, profile_dir, label):
    """Profile runs of 2 and 6 steps; their difference gives the device
    operations and device-busy milliseconds of one step (set-up
    cancels). Writes each run's kernel table to DIR."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    seen = {}
    for S in (2, 6):
        run = make_run(S)
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        # device activities (kernels, copies, memsets), without the
        # record_function ranges the profiler mirrors onto the device
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("mig:", "dep:"))]
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        seen[S] = (len(dev), busy)
        table = prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=80
        )
        (out / f"{label}_profile_{S}steps.txt").write_text(table)
    return (seen[6][0] - seen[2][0]) / 4, (seen[6][1] - seen[2][1]) / 4


def write_profile(torch, make_run, profile_dir, per_step, label):
    """A loop's device operations and device-busy time per step, and with
    the timed ms/step the device's idle share."""
    ops, busy = profile_steps(torch, make_run, profile_dir, label)
    log(f"{label} profile: {ops:.1f} device operations/step, device busy "
        f"{busy:.4f} ms/step of {per_step * 1e3:.4f} ms/step "
        f"(idle {1 - busy / (per_step * 1e3):.2%}); tables in "
        f"{profile_dir}")
    return busy


def small_width_phase(torch, pt, nbody):
    """The loop on the card (kernels) against the port's CPU run (plain
    versions) at a small width, with each engine: the same bits."""
    from mpi_grid_redistribute_tpu_torch.bench import common

    n_local = 4096
    v, cap, budget = common.drift_sizing(GRID, n_local, FILL, MIGRATION)
    pos, vel, alive = common.uniform_state(
        GRID, n_local, FILL, np.random.default_rng(1), vel_scale=4 * v
    )
    vgrid = pt.ProcessGrid(GRID)
    for engine in ("auto", "planar"):
        cfg = nbody.DriftConfig(
            domain=pt.Domain(0.0, 1.0, periodic=True),
            grid=pt.ProcessGrid((1, 1, 1)), dt=DT, capacity=cap,
            n_local=n_local, local_budget=budget, engine=engine,
        )
        a = nbody.make_migrate_loop(cfg, 5, vgrid=vgrid)(pos, vel, alive)
        b = nbody.make_migrate_loop(cfg, 5, vgrid=vgrid, device="cpu")(
            pos, vel, alive
        )
        for x, y in zip(a[:3], b[:3]):
            check(torch.equal(x.cpu().view(torch.uint8), y.view(torch.uint8)),
                  f"card loop ({engine}) differs from the CPU run at "
                  f"n_local={n_local}")
        for f in ("sent", "received", "population", "backlog", "flow",
                  "fast_path"):
            x, y = getattr(a[3], f), getattr(b[3], f)
            check((x is None and y is None) or torch.equal(x.cpu(), y),
                  f"card stat {f} ({engine}) differs from the CPU run")
        fast = "" if a[3].fast_path is None else (
            f", fast path on {int(a[3].fast_path[:, 0].sum())} of 5 steps")
        log(f"small width, {engine}: card loop == CPU run (bits, stats"
            f"{fast})")


def dfscan_phase(torch, dfscan, profiling):
    """Kernel 5 at the config-5 scan shape: the corner-weight channels of
    the 8.4M-row stream in 256-row tiles, [8 * 32768, 256]; and on hostile
    magnitudes (huge, tiny, denormal, zero, inf, NaN) and signed zeros."""
    rows, tile = 8 * 32768, 256
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((rows, tile), device="cuda", generator=g)
    hi, lo = dfscan.tile_df_cumsum_rows(x)
    hp, lp = dfscan.tile_df_cumsum_rows_plain(x)
    torch.cuda.synchronize()
    check(torch.equal(hi.view(torch.int32), hp.view(torch.int32))
          and torch.equal(lo.view(torch.int32), lp.view(torch.int32)),
          f"tile_df_cumsum_rows kernel != plain at [{rows}, {tile}]")
    err = max(max_abs_err(hi, hp), max_abs_err(lo, lp))
    r = np.random.default_rng(77)
    mags = r.choice([1e-44, 1e-40, 1e-30, 1e-8, 1.0, 1e8, 1e30], (64, tile))
    hx = (r.standard_normal((64, tile)) * mags).astype(np.float32)
    hx[3, :8] = 0.0
    hx[5, 17] = np.inf
    hx[6, 40] = np.nan
    # signed zeros: a row of -0.0 (+0.0 after the first step's add of the
    # shifted-in zero) and rows mixing +-0.0 with values
    hx[7] = -0.0
    hx[8, ::3] = -0.0
    hx[8, 1::5] = 0.0
    hx[9] = np.where(r.random(tile) < 0.5, -0.0, 0.0)
    hxt = torch.from_numpy(hx).cuda()
    a = dfscan.tile_df_cumsum_rows(hxt)
    b = dfscan.tile_df_cumsum_rows_plain(hxt)
    torch.cuda.synchronize()
    check(all(torch.equal(u.view(torch.int32), v.view(torch.int32))
              for u, v in zip(a, b)),
          "tile_df_cumsum_rows kernel != plain on the hostile input")

    ms = profiling.cuda_time_ms(lambda: dfscan.tile_df_cumsum_rows(x))
    plain_ms = profiling.cuda_time_ms(
        lambda: dfscan.tile_df_cumsum_rows_plain(x), iters=5
    )
    n = rows * tile
    steps = (tile - 1).bit_length()
    # read x once, write hi and lo once; 11 adds/subtracts per df_add,
    # each taking an FMA's issue slot (2 of PEAK_F32's FLOPs)
    b_ms, b_by = bound(12 * n, 2 * 11 * steps * n)
    return {
        "name": "tile_df_cumsum_rows",
        "route": "cuda",
        "source": "mpi_grid_redistribute_tpu_torch/csrc/dfscan.cu",
        "replaces": "mpi_grid_redistribute_tpu/ops/pallas_dfscan.py:70",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        # no single PyTorch call computes a double-float prefix
        "library_ms": None,
    }


def config5_slab_stream(torch, deposit, cfg, vgrid, inputs):
    """The slab stream kernel 4 sees in the config-5 step: the keys and
    rel rows of the start state (rows on their own slabs), sorted slab by
    slab as ``_slab_deposit_from_keys`` sorts them."""
    pos_p, _, alive = inputs
    D = 3
    V = vgrid.nranks
    vblock = tuple(m // v for m, v in zip(cfg.deposit_shape, vgrid.shape))
    vcells = np.asarray([vgrid.cell_of_rank(v) for v in range(V)],
                        np.float32)
    lo_all = torch.from_numpy(
        (vcells / np.asarray(vgrid.shape, np.float32)).astype(np.float32)
    ).cuda()
    inv_h = torch.full((D,), float(cfg.deposit_shape[0]), device="cuda")
    key, rel, _, in_block = deposit._slab_keys_mxu(
        pos_p.reshape(D, -1), None, alive, lo_all, inv_h, vblock
    )
    check(bool(in_block), "config-5 start state is not slab-resident")
    keys_s, order = torch.sort(key, dim=1, stable=True)
    n = key.shape[1]
    col = (order + torch.arange(V, device="cuda")[:, None] * n).reshape(-1)
    rel_s = torch.index_select(torch.stack(rel).reshape(D, -1), 1, col)
    n_cells = V * int(np.prod(vblock))
    return keys_s.reshape(-1), rel_s.contiguous(), n_cells, vblock


def segdep_phase(torch, segdep, profiling, stream):
    """Kernel 4 at the config-5 slab stream: N = 8 * 2^20 rows onto
    n_cells = 8 * 64^3 cells, unit mass (the loop's mxu deposit)."""
    keys, rel, n_cells, vblock = stream
    N = keys.shape[0]
    # dyadic rel (multiples of 1/4): every weight is a multiple of 1/64 and
    # every per-cell sum exact, so any order gives the same bits
    rel_d = torch.floor(rel * 4) / 4
    a = segdep.segsum_sorted(keys, rel_d, None, n_cells, vblock)
    b = segdep.segsum_sorted_plain(keys, rel_d, None, n_cells, vblock)
    torch.cuda.synchronize()
    check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
          "segsum_sorted kernel != plain on dyadic data at the config-5 "
          "stream")
    k1 = segdep.segsum_sorted(keys, rel, None, n_cells, vblock)
    k2 = segdep.segsum_sorted(keys, rel, None, n_cells, vblock)
    p = segdep.segsum_sorted_plain(keys, rel, None, n_cells, vblock)
    torch.cuda.synchronize()
    check(torch.equal(k1.view(torch.int32), k2.view(torch.int32)),
          "segsum_sorted is not run-to-run identical")
    err = max_abs_err(k1, p)
    check(bool(torch.allclose(k1, p, rtol=2e-5, atol=2e-5)),
          f"segsum_sorted kernel vs plain beyond 2e-5 (max abs {err})")
    ms = profiling.cuda_time_ms(
        lambda: segdep.segsum_sorted(keys, rel, None, n_cells, vblock)
    )
    plain_ms = profiling.cuda_time_ms(
        lambda: segdep.segsum_sorted_plain(keys, rel, None, n_cells, vblock),
        iters=5,
    )
    # library yardstick: index_add_ of PRECOMPUTED channels -- only the
    # summing part of the function (weights and mask are not in it)
    wch = segdep._corner_weights([rel[d] for d in range(3)], None, vblock)
    seg = keys.clamp(0, n_cells).long()
    acc = torch.zeros((8, n_cells + 1), device="cuda")
    library_ms = profiling.cuda_time_ms(lambda: acc.index_add_(1, seg, wch))
    # read keys + 3 rel rows once, write the [8, n_cells] canvas once;
    # per row ~3 x 6 frac ops, 8 corners x 3 weight ops, 8 x 5 scan adds
    b_ms, b_by = bound(N * 16 + 8 * n_cells * 4, N * (18 + 24 + 40))
    return {
        "name": "segsum_sorted",
        "route": "cuda",
        "source": "mpi_grid_redistribute_tpu_torch/csrc/segdep.cu",
        "replaces": "mpi_grid_redistribute_tpu/ops/pallas_segdep.py:181",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library_ms,
    }


def config5_phase(torch, nbody, deposit, _build, profiling, config5_deposit,
                  method, inputs, profile_dir, base_busy):
    """Config 5 through ``make_migrate_loop`` with ``method``: the bench
    shape with the default engine, the CIC deposit onto 128^3 fused into
    every step."""
    cfg, vgrid, _ = config5_deposit.build(n_local=N_LOCAL, method=method)
    pos, vel, alive = inputs
    total = int(alive.sum().item())

    def make_run(S, plain=False, c=cfg):
        loop = nbody.make_migrate_loop(c, S, vgrid=vgrid, plain=plain,
                                       deposit_each_step=c.deposit_shape
                                       is not None)
        return lambda: loop(pos, vel, alive)

    detail, _ = profiling.cuda_time_per_step_samples(
        make_run, s1=4, s2=20, reps=7
    )
    per_step = detail["min"]
    log(f"config5 {method}: {per_step * 1e3:.4f} ms/step (min of "
        f"k={detail['k']}, median {detail['median'] * 1e3:.4f}, spread "
        f"{detail['spread'] * 100:.2f}%), {total / per_step:.6g} "
        f"particles/s")
    log(f"config5 {method} per-step samples (s): {detail['values']}")

    # ---- host syncs per step: runs of 2 and COUNTED_STEPS steps under
    # torch's sync debug mode, differenced (one-time set-up cancels)
    def synced(S):
        guard0 = deposit.HOST_SYNCS["residence_guard"]
        out, syncs = synced_run(torch, make_run(S))
        return out, syncs, deposit.HOST_SYNCS["residence_guard"] - guard0

    _, syncs2, guard2 = synced(2)
    # ---- counted run: every kernel of the path once per step
    _build.reset_counts()
    out, syncs, guard = synced(COUNTED_STEPS)
    launches = _build.counts()
    syncs = (syncs - syncs2) / (COUNTED_STEPS - 2)
    guard = (guard - guard2) / (COUNTED_STEPS - 2)
    log(f"config5 {method}: launches over {COUNTED_STEPS} steps: "
        f"{launches}; host syncs per step {syncs:g} (residence-guard "
        f"reads {guard:g}; the engine's sparse guard is the other)")
    check_launches(launches, MIGRATE_KERNELS + (DEPOSIT_KERNEL[method],),
                   f"config5 {method}")
    stats, rho = out[3], out[4]
    check(int(stats.dropped_recv.sum()) == 0, "config5: arrivals dropped")
    check(int(out[2].sum()) == total, "config5: alive count not conserved")
    mass = float(rho.double().sum())
    check(abs(mass - total) <= 1e-5 * total,
          f"config5 {method}: rho sums to {mass}, {total} live particles")
    check(bool(torch.isfinite(rho).all()) and tuple(rho.shape) ==
          cfg.deposit_shape, f"config5 {method}: rho not finite or shaped")

    bare = make_run(COUNTED_STEPS,
                    c=dataclasses.replace(cfg, deposit_shape=None))()
    ref = make_run(COUNTED_STEPS, plain=True)()
    torch.cuda.synchronize()
    for name, a, b, c in zip(("pos", "vel", "alive"), out[:3], bare[:3],
                             ref[:3]):
        check(torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
              f"config5 {method}: {name} differs from the loop without "
              f"deposit")
        check(torch.equal(a.view(torch.uint8), c.view(torch.uint8)),
              f"config5 {method}: {name} differs from the plain run")
    rho_err = max_abs_err(rho, ref[4])
    if method == "scan":
        check(torch.equal(rho.view(torch.int32), ref[4].view(torch.int32)),
              "config5 scan: rho not bit-equal to the plain-version run")
    else:
        check(bool(torch.allclose(rho, ref[4], rtol=2e-5, atol=2e-5)),
              f"config5 mxu: rho vs plain run beyond 2e-5 ({rho_err})")
    log(f"config5 {method}: rho vs plain run max abs err {rho_err}")

    busy = None
    if profile_dir:
        ops, busy = profile_steps(torch, make_run, profile_dir,
                                  f"config5_{method}")
        msg = (f"config5 {method} profile: {ops:.1f} device operations/step, "
               f"device busy {busy:.4f} ms/step of {per_step * 1e3:.4f} "
               f"(idle {1 - busy / (per_step * 1e3):.2%})")
        if base_busy is not None:
            msg += (f"; deposit {busy - base_busy:.4f} ms/step of device "
                    f"time ({(busy - base_busy) / busy:.2%} of the busy "
                    f"time)")
        log(msg)
    return {
        "method": method,
        "ms_per_step": per_step * 1e3,
        "median_ms_per_step": detail["median"] * 1e3,
        "spread": detail["spread"],
        "particles_per_s": total / per_step,
        "host_syncs_per_step": syncs,
        "guard_reads_per_step": guard,
        "launches": launches,
        "device_busy_ms_per_step": busy,
    }, rho


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default=None,
                    help="write torch.profiler tables of each loop to DIR")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import mpi_grid_redistribute_tpu_torch as pt
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 3
    if Path(pt.__file__).resolve().parent.parent != HERE:
        print("chip_smoke: imported a port from outside this checkout",
              file=sys.stderr)
        return 3
    from mpi_grid_redistribute_tpu_torch.bench import common, config5_deposit
    from mpi_grid_redistribute_tpu_torch.models import nbody
    from mpi_grid_redistribute_tpu_torch.ops import (
        _build, deposit, dfscan, driftbin, overlay, scatter, segdep,
    )
    from mpi_grid_redistribute_tpu_torch.parallel import migrate
    from mpi_grid_redistribute_tpu_torch.utils import profiling

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"built {sorted(_build.KERNELS)} in {time.perf_counter() - t0:.1f} s")

    v, cap, budget = common.drift_sizing(GRID, N_LOCAL, FILL, MIGRATION)
    log(f"bench sizing: capacity {cap}, local_budget {budget}, "
        f"vel scale {v.tolist()}")
    pos, vel, alive = common.uniform_state(
        GRID, N_LOCAL, FILL, np.random.default_rng(0), vel_scale=v
    )
    pos_p = nbody.rows_to_planar(pos, 1)
    vel_p = nbody.rows_to_planar(vel, 1)
    state_np = np.concatenate(
        [pos_p.reshape(3, -1).view(np.int32),
         vel_p.reshape(3, -1).view(np.int32),
         alive.astype(np.int32)[None]], axis=0,
    )

    k1 = driftbin_phase(torch, pt, driftbin, profiling, state_np)
    log(f"drift_wrap_bin: {k1['ms']:.5f} ms (bound {k1['bound_ms']:.5f}, "
        f"plain {k1['plain_ms']:.5f}) bit-equal at [7, {state_np.shape[1]}]")
    k2 = overlay_phase(torch, overlay, profiling, budget)
    log(f"overlay_scatter_planar: {k2['ms']:.5f} ms (bound "
        f"{k2['bound_ms']:.5f}, plain {k2['plain_ms']:.5f}, index_put_ "
        f"{k2['library_ms']:.5f}) bit-equal at V*P = {8 * budget}")

    k6 = scatter_phase(torch, scatter, profiling, state_np, budget)
    log(f"scatter_rows: {k6['ms']:.5f} ms (bound {k6['bound_ms']:.5f}, "
        f"plain {k6['plain_ms']:.5f}, index_put_ {k6['library_ms']:.5f}) "
        f"bit-equal at V*P = {8 * budget} into [{state_np.shape[1]}, 7]")

    inputs = tuple(torch.from_numpy(np.ascontiguousarray(x)).cuda()
                   for x in (pos_p, vel_p, alive))
    # the dense planar step (a comparison run), then the main path: the
    # default engine, the mover-sparse one on this layout
    planar, planar_out = loop_path_phase(
        torch, pt, nbody, migrate, _build, profiling, inputs, cap, budget,
        "planar", args.profile,
    )
    sparse, _ = loop_path_phase(
        torch, pt, nbody, migrate, _build, profiling, inputs, cap, budget,
        "auto", args.profile, planar_out,
    )
    rows = rows_route_phase(torch, pt, migrate, driftbin, _build, profiling,
                            inputs, cap, budget, planar_out, args.profile)
    del planar_out
    small_width_phase(torch, pt, nbody)

    # ---- config 5: the deposit kernels, then the fused loop
    cfg5, vgrid5, state5 = config5_deposit.build(n_local=N_LOCAL)
    check(all(np.array_equal(a, b) for a, b in zip(state5, (pos, vel, alive)))
          and (cfg5.capacity, cfg5.local_budget) == (cap, budget),
          "config 5 does not start from the bench state")
    k5 = dfscan_phase(torch, dfscan, profiling)
    log(f"tile_df_cumsum_rows: {k5['ms']:.5f} ms (bound "
        f"{k5['bound_ms']:.5f}, plain {k5['plain_ms']:.5f}) bit-equal at "
        f"[262144, 256]")
    k4 = segdep_phase(torch, segdep, profiling, config5_slab_stream(
        torch, deposit, cfg5, vgrid5, inputs
    ))
    log(f"segsum_sorted: {k4['ms']:.5f} ms (bound {k4['bound_ms']:.5f}, "
        f"plain {k4['plain_ms']:.5f}, index_add_ of precomputed channels "
        f"{k4['library_ms']:.5f}) at N = {8 * N_LOCAL}, max abs err "
        f"{k4['max_abs_err']}")
    c5, rhos = {}, {}
    for method in ("mxu", "scan"):
        c5[method], rhos[method] = config5_phase(
            torch, nbody, deposit, _build, profiling, config5_deposit,
            method, inputs, args.profile, sparse["device_busy_ms_per_step"],
        )
    err = max_abs_err(rhos["mxu"], rhos["scan"])
    check(bool(torch.allclose(rhos["mxu"], rhos["scan"], rtol=2e-4,
                              atol=2e-4)),
          f"config5: mxu rho vs scan rho beyond 2e-4 (max abs {err})")
    log(f"config5: mxu rho vs scan rho max abs err {err}")

    kernels = []
    # rows 2 and 3 of the TPU table (_overlay_sorted, _overlay_sorted_i8)
    # are one CUDA kernel; launches are counted on the main path (rows
    # 1-3), the config-5 loops (rows 4-5) and the rows route (row 6)
    row2 = dict(
        k2, replaces="mpi_grid_redistribute_tpu/ops/pallas_overlay.py:218"
    )
    main_launches = sparse["launches"]
    for k, path in ((k1, main_launches), (row2, main_launches),
                    (k2, main_launches), (k4, c5["mxu"]["launches"]),
                    (k5, c5["scan"]["launches"]), (k6, rows["launches"])):
        k = dict(k)
        k["launches"] = path[k["name"]]
        kernels.append(k)
    log(json.dumps({"sparse_path": sparse}))
    log(json.dumps({"planar_path": planar}))
    log(json.dumps({"rows_path": rows}))
    log(json.dumps({"config5": c5}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
