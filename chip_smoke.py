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
     could take (``bound_ms``); kernels 2, 4 and 6 with their library
     yardsticks as replayed CUDA graphs (the device's time; eager launches
     beside them; ``bench/kernel_times``, given this script's sizing):
     kernel 2 on random targets, kernel 6 at the rows route's shape, the
     bench state as row-major ``[8388608, 7]``;
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
     identical, there and on streams that put runs across its tile
     edges), and drives config 5 (the loop with its default engine
     and the CIC deposit onto a 128^3 mesh fused into every step) through
     ``make_migrate_loop`` with ``deposit_method="mxu"`` and ``"scan"``:
     timed per step, host syncs per step, a counted run whose deposit
     kernel launches equal its steps, mass conservation, the state
     bit-equal to the loop without deposit, and the density held against
     the plain-version run and across the two methods. Kernel 5 is also
     held at the tiles of its block route (2048 and 8192) and kernel 4 at
     D = 4, both timed; the scan deposit's payload sort
     (``ops/rowsort.sort_rows``) and kernel 5's fused route on the sorted
     rows at the CIC cell's deposit shape (67.1M rows, 22-bit keys, 4
     groups of 2 channels), each bit for bit against its plain version
     and timed; then ``analysis.kernelcheck`` over the seven
     registered cases (K000 launches, K001 guard bands, K002 write sets,
     K003 footprints against the committed baseline, K005 bit equality)
     and the scan deposit's span table (``bench/knockout_deposit.py``)
     at a small width: the five ``dep:*`` spans named, the rows adding
     up to the call's device time within 2%, the profiled density
     bit-equal to the deposit;
  6. drives the canonical ``GridRedistribute.redistribute`` (the 2x2x2
     grid as 8 vranks, engine ``"auto"``, which is the planar engine on
     one device): config 1 (1,048,576 uniform rows, seed 42, pos/vel/ids,
     ``capacity_factor=4.0``) byte-equal to the port's NumPy oracle,
     positions, fields, count and stats; then at the headline width, 2^20
     rows per vrank, ms per call (min and median of k), host syncs per
     steady-state call (0: the overflow check is deferred), conservation,
     zero drops and ownership; and the planar canonical step in a drift
     loop (2^20 rows per vrank, 1.25x slots, ~2% migration), ms/step and
     host syncs per step, with ``--profile`` the device's busy and idle
     share of both; then the telemetry of the headline instance
     (``report()`` at the measured call time, ``flow()``, ``health()``,
     ``metrics(render=True)``, ``to_perfetto()``: rows conserved, flow
     row sums the send totals, status OK, one journaled ``redistribute``
     a call, one read off the device for ``report()`` and one for
     ``flow()``); then one short run of the headline bench
     (``bench/headline.py``, ``bench.py``'s twin: S1 = 2, S2 = 6, one
     long run, the CPU comparators at 2^18 rows), its keys
     ``bench.py``'s and kernels 1 and 2 once a step (its ``rebalance``,
     ``service`` and ``soak`` captures skipped here: the driver phase
     runs the rebalance leg, config 8 runs from its own script); then the
     hierarchical two-level engine on the same
     headline input (``dcn_shape=(2, 1, 1)``, ``engine="hierarchical"``,
     two pods of 4 vranks): byte-equal to the oracle and to the planar
     call, ms per call (median), device busy and host syncs a call; and
     one cross-block growth from ``cross_cap=1`` at config 1's width;
     between the headline and the hierarchical engine config 7's full
     reshuffle (``bench/config7_stress.py`` at 2^20 rows: ms/step, GB/s,
     utilization of the HBM3 roof, nothing dropped or lost; the
     headline's ``stress``, ``hier`` and two-level byte split filled);
     after it the chunked service step (``bench/service_chunk.py``: 8
     vranks of 2^20 rows, chunks of 16): the sequential and the
     pipelined macro with no host sync inside (sync debug "error"),
     kernel 2 launched once a step by the pipelined one and held against
     its plain version at that chunk's landings (K = 9 and 8), the two
     macros' particle sets equal, both bit-equal to the CPU run at a
     small width, and ms/step of each beside the eager loop; then the
     service driver (``service.ServiceDriver`` on the card, 8 vranks of
     2^20 rows at fill 0.8): the same 16 steps eager, as one chunk of 16
     (no host sync inside: sync debug "error") and pipelined (kernel 2
     launched once a step), one particle set, ms/step of each; one
     synchronous snapshot at step 8 (235 MB) and its restore into a
     fresh driver byte-equal, both timed; a supervised run at 2^17 rows a
     vrank (a snapshot every 4 steps, a crash at step 10, one restart)
     with the uninterrupted run's particle set, and an elastic restore
     of its last snapshot onto (2, 2, 1) with the same set; config
     4's rebalance leg on the torch backend (every clause of the
     reference's gate); and the history plane: a supervised run at 2^17
     rows a vrank pipelined in chunks of 16 with a journal store, an
     incident directory, the counters probes and a NaN burst at step 24
     (one restart, one ``nan_detected`` bundle naming the step, a
     restore from before it, the store verified with the recorder's
     counts and no row twice, ``tools.storecheck``'s file-level checks
     clean on it, kernel 2 launched in the leg), with the drains' seconds
     and their share of the leg; then the counted rooflines and this
     slice's tools: every one-device registered program
     (``analysis.progcheck``) counted on the card and on the CPU with the
     same bytes, flops and kernel counts (``telemetry.roofline.
     count_cost``; the stage table's planar loop too), timed, and its
     ``roofline_report`` row journaled and read back as the
     ``roofline_achieved_fraction`` gauge; two of them counted and timed
     again at 2^20 rows a vrank, where a share is real; every
     ``achieved_fraction`` in (0, 1.05]; ``tools.trace_export
     --demo`` and ``examples.drift_demo --steps 3`` (both verdict lines)
     on the card; the program registry
     recorded once on the card (its sharded programs in item 9's world)
     and judged in this process and by ``tools.check_all --lint`` with
     the card (started on that recording after config 5's kernel holds,
     at niceness 10, beside the phases up to this one), every one of its
     eight rows clean: progcheck's J001 (every
     rank of the 8-rank world issues one collective sequence, the dense
     one on every rank when one rank alone overflows), J002 (no host
     read, nothing synchronizing under sync debug mode "error"), J003 and
     J004, shardcheck's S004 and the DCN ratio against the committed
     baseline, gridlint, racecheck, kernelcheck, ``incident_demo
     --check`` and the rest;
  7. drives the halo exchange (config 6: the 2x2x2 grid as 8 vranks on
     the periodic unit box, every slot filled, width 0.05, derived
     capacities): at 2^18 rows per vrank both vrank engines on the card
     bit-equal to each other and to the port's CPU run; at 2^20 rows per
     vrank ms per exchange (min and median of k) and ns per ghost of
     each engine, the ghost fraction beside the uniform expectation,
     zero overflow, host syncs per exchange (0) and a shell check of
     every ghost; then the public ``GridRedistribute.halo()`` on the
     output of the headline ``redistribute()`` call, ms per call, and its
     ghost set equal to the vectorised ``oracle.brute_force_ghosts`` at
     2^16 rows per vrank; with ``--profile`` the device's busy and idle
     share and operations per exchange;
  8. drives config 2's load-balanced decomposition (the 4x4x4 cells
     LPT-assigned onto 8 vranks, ``cells``/``assignment`` in the
     ``DriftConfig``): the steady state at the BASELINE's 67,108,864
     rows, clustered and uniform, with the default engine: ms per step
     (min and median of k), pps and their ratio, the cell and balanced-bin
     imbalance, the slot waste, the fast-path share and host syncs per
     step, a counted run (kernel 2 once a step, kernel 1 never),
     conservation, zero drops, every live row on its assigned vrank, and
     bit equality with the plain-version run and with ``engine="planar"``;
     then the placement (64 vranks of 2^17 rows, ``dt = 0``, the backlog
     draining it: rows placed, rounds, pps, nothing dropped, ownership,
     a counted loop bit-equal to its plain-version run), and the mxu and
     scan deposits under the assignment at 2^20 rows against the density
     of the same particles on the canonical layout (2e-5); the
     ``"segment"`` deposit on config 5's shape (its mass, its difference
     from the scan density); and config 3 ((8, 8, 1) as 64 vranks, 2^17
     slots a vrank): ms per step, kernels 1 and 2 a step, the fast-path
     share, the plain-version run's bits; with ``--profile`` the device's
     busy and idle share of config 2's steady state and of config 3.

  9. after item 4, the multi-rank paths (``bench.multirank``): NCCL at
     world size 1 in this process (each collective of
     ``parallel.collectives`` once, and ``GridRedistribute(mesh=)`` on
     config 1's rows byte-equal to the call without a mesh); then one
     gloo world of 8 processes sharing the card (started at niceness 10
     while the kernels build, waiting for its turn): the bench grid as 2
     ranks x 4 vranks and as 8 ranks (the flat engine, with the mxu and
     scan deposits each step) through ``make_migrate_loop(..., mesh=)``,
     kernel 2 once a step on every rank and kernel 1 never, every slab's
     multiset of live rows equal to the 8-vrank run of item 2;
     ``GridRedistribute(mesh=)`` ``"auto"`` (sparse) and ``"planar"`` on
     config 1's rows byte-equal to the oracle rank for rank; the mxu and
     scan deposits across ranks within 2e-5 of one device's density; the
     canonical drift loop (``make_drift_loop``, 2^20 rows a rank, config
     5's 128^3 deposit each step, ``"scan"`` then ``"mxu"``) against the
     same loop on the plain versions and one process's plain density,
     kernels 5 and 4 once a step on every rank; ``GridRedistribute(mesh=)
     .halo()`` at config 6's width and size, both engines, each rank's
     ghosts the one-card vrank engines' (whose sets are
     ``oracle.brute_force_ghosts``'); ``GridRedistribute(mesh=,
     dcn_shape=(2, 1, 1))`` (``"auto"``: the hierarchical engine) on
     config 1's rows byte-equal to the oracle and to ``"planar"``; and a
     small width on the card bit-equal to the CPU (the migrate loop; one
     drift step with its scan deposit, a halo with each engine and a
     hierarchical call on two ranks); the same world records the program
     registry's sharded programs (``analysis.progcheck.world_records``)
     for item 6; NCCL at world size 1 also runs one drift-loop step with
     its deposit. Times there are host-clock ms of
     processes sharing one card over gloo: not multi-GPU figures.

Any failed check raises; nothing is caught and carried on. The last
lines are the ``nvidia-smi`` name and power limit, one JSON object with
every kernel's numbers, and ``{"ok": true, "device": {...}}``. Exits
non-zero without printing a result when no CUDA device is present or the
package is not beside this script. ``--profile DIR`` also writes a
``torch.profiler`` kernel table of a few steps of each loop to DIR, and
prints each hand-written kernel's device microseconds per step in each
loop and the deposit's share of the config-5 step.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import importlib
import json
import os
import statistics
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

T_START = time.perf_counter()
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
# config 5: the deposit kernels each method launches once per step (the
# scan deposit's payload sort and kernel 5)
DEPOSIT_KERNELS = {"mxu": ("segsum_sorted",),
                   "scan": ("sort_rows", "tile_df_cumsum_rows")}
# a substring of each kernel's device function names (csrc/*.cu), for its
# device time in the profiles (kernel 4's memset is not counted)
KERNEL_SYMBOLS = {
    "drift_wrap_bin": "driftbin_kernel",
    "overlay_scatter_planar": "overlay_",
    "segsum_sorted": "segdep_",
    "tile_df_cumsum_rows": "dfscan_kernel",
    "scatter_rows": "scatter_rows_kernel",
}

# steady-state canonical calls under the sync check: two deferred
# overflow-check windows (check_every = 16)
CANON_CALLS = 32

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


def niced(fn, *args):
    """``fn(*args)`` in this thread at niceness 10 (a Linux thread's own
    priority), for host work beside the timed phases."""
    import threading

    os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 10)
    return fn(*args)


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
    # the kernel's own count (ops/driftbin.kernel_cost), the one
    # telemetry.roofline.count_cost adds for a call
    b_ms, b_by = bound(*driftbin.kernel_cost(work, DT, domain, grid, V, V))
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


def overlay_phase(torch, overlay, profiling, kernel_times, budget):
    """Kernel 2 at the main-path shape: V * P unique targets in random
    order into the [7, V * n] state, plus drops, bit-equal to the plain
    version and timed with ``index_put_`` as replayed CUDA graphs and
    eagerly."""
    flat0, cols, targets = kernel_times.overlay_inputs(
        int(np.prod(GRID)), N_LOCAL, budget
    )
    K, m = flat0.shape
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
    del a, b, af, bf

    times = kernel_times.time_overlay(overlay, profiling, flat0, cols,
                                      targets)
    for case, t in times.items():
        log(f"overlay_scatter_planar {case}: {t['graph']:.5f} ms as a CUDA "
            f"graph, {t['eager']:.5f} ms eager")
    log(json.dumps({"overlay_times": times}))
    work = flat0.clone()
    plain_ms = profiling.cuda_time_ms(
        lambda: overlay.overlay_scatter_planar_plain(work, targets, cols)
    )
    n_ok = int(((targets >= 0) & (targets < m)).sum())
    P = targets.shape[0]
    # the kernel's own count (ops/overlay.kernel_cost): every target read,
    # the in-range columns read and written
    b_ms, b_by = bound(*overlay.kernel_cost(flat0, targets, cols))
    # every in-range word alone in its 32-byte sector, written (and, for a
    # partial sector, first read) once: the floor at sector granularity
    log(f"overlay_scatter_planar: {n_ok} in-range of {P}; bound "
        f"{b_ms:.5f} ms, sector floor {bound(32 * K * n_ok, 0)[0]:.5f} ms "
        f"written, {bound(64 * K * n_ok, 0)[0]:.5f} ms with the fills")
    return {
        "name": "overlay_scatter_planar",
        "route": "cuda",
        "source": "mpi_grid_redistribute_tpu_torch/csrc/overlay.cu",
        "replaces": "mpi_grid_redistribute_tpu/ops/pallas_overlay.py:317",
        "max_abs_err": err,
        "ms": times["kernel"]["graph"],
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": times["index_put_"]["graph"],
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
    # the kernel's own count (ops/scatter.kernel_cost): the targets, and
    # the in-range rows read once and written once
    b_ms, b_by = bound(*scatter.kernel_cost(work, targets, rows))
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


def counted_run(torch, migrate, _build, make_run):
    """The counted run of a loop: ``(out, launches, syncs, guard)``, each
    kernel's launches over ``COUNTED_STEPS`` steps (the counts set to 0
    just before the run and read just after), and the host syncs and
    sparse-guard reads per step (runs of 2 and ``COUNTED_STEPS`` steps
    under torch's sync debug mode, differenced)."""
    guard0 = migrate.HOST_SYNCS["sparse_guard"]
    _, syncs2 = synced_run(torch, make_run(2))
    guard2 = migrate.HOST_SYNCS["sparse_guard"]
    _build.reset_counts()
    out, syncs = synced_run(torch, make_run(COUNTED_STEPS))
    launches = _build.counts()
    syncs = (syncs - syncs2) / (COUNTED_STEPS - 2)
    guard = (migrate.HOST_SYNCS["sparse_guard"] - guard2 - (guard2 - guard0)) \
        / (COUNTED_STEPS - 2)
    return out, launches, syncs, guard


def check_launches(launches, kernels, label):
    for name, n in launches.items():
        want = COUNTED_STEPS if name in kernels else 0
        check(n == want,
              f"{label}: {name} launched {n} times in {COUNTED_STEPS} steps")


def check_state(torch, label, pos_f, alive_f, stats, total, grid=GRID,
                n_local=N_LOCAL, assignment=None):
    """Conservation, zero drops, the stats' own accounting, finite
    positions and ownership (computed independently of the port's
    binning: the cell of each live row on the unit box's ``grid`` in
    float64, then its vrank, or with ``assignment`` the vrank the cell is
    assigned to) of a ``COUNTED_STEPS`` run's output (``n_local`` slots a
    vrank)."""
    check(int(alive_f.sum()) == total, f"{label}: alive count not conserved")
    check(int(stats.dropped_recv.sum()) == 0, f"{label}: arrivals dropped")
    check(torch.equal(stats.population.sum(dim=1),
                      torch.full((stats.sent.shape[0],), total,
                                 dtype=torch.int32, device="cuda")),
          f"{label}: population stat disagrees with the alive count")
    check(torch.equal(stats.sent.sum(dim=1), stats.received.sum(dim=1)),
          f"{label}: sent != received")
    check(bool(torch.isfinite(pos_f).all()), f"{label}: non-finite positions")
    check_owned(torch, label, pos_f, alive_f, grid, n_local, assignment)


def check_owned(torch, label, pos_f, alive_f, grid=GRID, n_local=N_LOCAL,
                assignment=None):
    """Every live row of the planar flat ``pos_f`` sits on the vrank that
    owns its position (see :func:`check_state`)."""
    p = pos_f.reshape(3, -1)
    g = torch.tensor(grid, device="cuda")[:, None]
    cell = torch.floor(p.double() * g).long().clamp_min(0)
    cell = torch.minimum(cell, g - 1)
    owner = cell[0] * grid[1] * grid[2] + cell[1] * grid[2] + cell[2]
    if assignment is not None:
        owner = torch.tensor(assignment, device="cuda")[owner]
    slot = torch.arange(p.shape[1], device="cuda") // n_local
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
        make_run, s1=4, s2=28, reps=5 if engine == "auto" else 4
    )
    per_step = detail["min"]
    log(f"{label}: {per_step * 1e3:.4f} ms/step (min of k={detail['k']}, "
        f"median {detail['median'] * 1e3:.4f}, "
        f"spread {detail['spread'] * 100:.2f}%), "
        f"{total / per_step:.6g} particles/s, {total} particles")
    log(f"{label} per-step samples (s): {detail['values']}")

    plain_detail, _ = profiling.cuda_time_per_step_samples(
        lambda S: make_run(S, plain=True), s1=4, s2=12, reps=2
    )
    log(f"{label} on plain versions: {plain_detail['min'] * 1e3:.4f} "
        f"ms/step")

    # every kernel of the path launches once a step
    out, launches, syncs, guard = counted_run(torch, migrate, _build,
                                              make_run)
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
    operations, device-busy milliseconds and each hand-written kernel's
    device microseconds (``KERNEL_SYMBOLS``) of one step (set-up
    cancels). Writes each run's kernel table to DIR (none when DIR is
    ``None``)."""
    from torch.profiler import ProfilerActivity, profile

    from mpi_grid_redistribute_tpu_torch.telemetry.phases import (
        SPAN_PREFIXES,
    )

    out = None
    if profile_dir:
        out = Path(profile_dir)
        out.mkdir(parents=True, exist_ok=True)
    seen = {}
    for S in (2, 6):
        run = make_run(S)
        run()
        torch.cuda.synchronize()
        # device activity only: the host-side trace of every op would
        # cost seconds a run and no device number reads it
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        # device activities (kernels, copies, memsets), without the
        # record_function ranges the profiler mirrors onto the device
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(SPAN_PREFIXES)]
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        per_kernel = {
            k: sum(e.time_range.elapsed_us() for e in dev if sym in e.name)
            for k, sym in KERNEL_SYMBOLS.items()
        }
        seen[S] = (len(dev), busy, per_kernel)
        if out is not None:
            table = prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=80
            )
            (out / f"{label}_profile_{S}steps.txt").write_text(table)
    kernel_us = {k: (seen[6][2][k] - seen[2][2][k]) / 4
                 for k in KERNEL_SYMBOLS if seen[6][2][k] > 0}
    log(f"{label} profile: in-loop kernel us/step {kernel_us}")
    return ((seen[6][0] - seen[2][0]) / 4, (seen[6][1] - seen[2][1]) / 4,
            kernel_us)


def write_profile(torch, make_run, profile_dir, per_step, label):
    """A loop's device operations and device-busy time per step, and with
    the timed ms/step the device's idle share."""
    ops, busy, _ = profile_steps(torch, make_run, profile_dir, label)
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


MULTIRANK_LABEL = ("{w} processes sharing one card over gloo; not a "
                   "multi-GPU figure")


def nccl_phase(torch, pt, config1_oracle, workdir):
    """(a) NCCL at world size 1 on ``cuda:0``, in this process: each
    collective of ``parallel.collectives`` once through the backend, and
    ``GridRedistribute(mesh=)`` on config 1's rows (a one-rank grid)
    byte-equal to the same call without a mesh."""
    import torch.distributed as dist

    from mpi_grid_redistribute_tpu_torch.parallel import collectives as col
    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib.initialize_distributed(
        "nccl", init_method=f"file://{workdir}/nccl_rendezvous",
        world_size=1, rank=0, timeout=120)
    try:
        mesh = mesh_lib.make_mesh(pt.ProcessGrid((1, 1, 1)))
        check(mesh.backend == "nccl", f"backend {mesh.backend}")
        x = torch.arange(12, dtype=torch.int32, device="cuda") - 5
        f = torch.linspace(-1.0, 3.0, 12, device="cuda")
        for name, got, want in (
            ("all_to_all", col.all_to_all(x, mesh), x),
            ("all_gather", col.all_gather(x, mesh)[0], x),
            ("psum", col.psum(x, mesh), x),
            ("psum_ordered", col.psum_ordered(f, mesh), f),
            ("pmin", col.pmin(x, mesh), x),
            ("ppermute", col.ppermute(x, mesh, [(0, 0)]), x),
            ("broadcast", col.broadcast(x, mesh), x),
        ):
            check(torch.equal(got, want), f"nccl {name}: wrong result")
        pos, vel, ids = config1_oracle.inputs(1 << 20)
        kw = dict(lo=0.0, hi=1.0, periodic=True, grid=(1, 1, 1),
                  capacity_factor=config1_oracle.CAPACITY_FACTOR)
        rd_m = pt.GridRedistribute(mesh=mesh, **kw)
        rd_v = pt.GridRedistribute(**kw)
        a = rd_m.redistribute(pos, vel, ids)
        b = rd_v.redistribute(pos, vel, ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = rd_m.redistribute(pos, vel, ids)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rd_m.flush_overflow_checks()
        rd_v.flush_overflow_checks()
        for name, u, w in (("positions", a.positions, b.positions),
                           ("count", a.count, b.count),
                           *((f"field {i}", u, w) for i, (u, w) in
                             enumerate(zip(a.fields, b.fields))),
                           *((f"stat {k}", getattr(a.stats, k),
                              getattr(b.stats, k))
                             for k in config1_oracle.STATS)):
            check(torch.equal(u.view(torch.uint8), w.view(torch.uint8)),
                  f"nccl GridRedistribute(mesh=): {name} differs from the "
                  f"call without a mesh")
        check(rd_m._last_wire["engine"] == "planar",
              "nccl: engine not planar")
        drift_ms = nccl_drift_check(torch, pt, mesh, pos, vel)
    finally:
        dist.destroy_process_group()
    log(f"(a) NCCL at world size 1: 7 collectives through the backend, "
        f"GridRedistribute(mesh=) at {1 << 20} rows byte-equal to the call "
        f"without a mesh ({ms:.3f} ms a call, host clock, uploads "
        f"included); one drift-loop step with its scan deposit byte-equal "
        f"to the loop without a process group, kernel 5 once "
        f"({drift_ms:.3f} ms, host clock)")
    return {"backend": "nccl", "world_size": 1, "collectives": 7,
            "redistribute_rows": 1 << 20, "redistribute_ms": ms,
            "byte_equal_to_one_device": True, "drift_step_ms": drift_ms}


def nccl_drift_check(torch, pt, mesh, pos, vel):
    """One step of ``make_drift_loop`` with its scan deposit (config 5's
    mesh) on a one-rank grid over ``mesh`` (NCCL), against the same loop
    on a mesh without a process group: every output byte-equal, kernel 5
    launched once. Returns the NCCL step's host-clock ms."""
    from mpi_grid_redistribute_tpu_torch.models import nbody
    from mpi_grid_redistribute_tpu_torch.ops import _build
    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib

    n = pos.shape[0]
    grid = pt.ProcessGrid((1, 1, 1))
    cfg = nbody.DriftConfig(domain=pt.Domain(0.0, 1.0, periodic=True),
                            grid=grid, dt=0.0625, capacity=n, n_local=n,
                            deposit_shape=(128, 128, 128))
    local = mesh_lib.RankMesh(None, grid.shape, grid.axis_names, 1, 0,
                              (0, 0, 0), None)
    args = (torch.from_numpy(pos).cuda(), torch.from_numpy(vel).cuda(), n)
    want = nbody.make_drift_loop(cfg, 1, mesh=local,
                                 deposit_each_step=True)(*args)
    loop = nbody.make_drift_loop(cfg, 1, mesh=mesh, deposit_each_step=True)
    torch.cuda.synchronize()
    _build.reset_counts()
    t0 = time.perf_counter()
    got = loop(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _build.counts()
    check(launches.get("tile_df_cumsum_rows") == 1,
          f"nccl drift step: kernel 5 launched {launches}")
    for name, a, b in (("pos", got[0], want[0]), ("vel", got[1], want[1]),
                       ("count", got[2], want[2]), ("rho", got[4], want[4]),
                       *((f"stat {k}", getattr(got[3], k),
                          getattr(want[3], k))
                         for k in ("send_counts", "recv_counts",
                                   "dropped_send", "dropped_recv",
                                   "needed_capacity"))):
        check(torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
              f"nccl drift step: {name} differs from the loop without a "
              f"process group")
    check(abs(float(got[4].double().sum()) - n) <= 1e-5 * n,
          "nccl drift step: density mass")
    return ms


def launch_world(state, profile_dir):
    """Start (b)-(d)'s gloo world of 8 processes sharing ``cuda:0``
    (``bench.multirank``) ahead of its turn, at niceness 10, while the
    kernels build: the ranks import, join the group, make the card's
    context and then wait for :func:`multirank_phase`'s go (and load the
    kernels after it), so their start-up runs on the cores the phases
    before it leave idle. The world runs in a thread of this
    process; the returned handle is :func:`multirank_phase`'s. If this
    script exits before the go, the ranks are told to stop."""
    import atexit
    import threading

    from mpi_grid_redistribute_tpu_torch.analysis import progcheck
    from mpi_grid_redistribute_tpu_torch.bench import multirank
    from mpi_grid_redistribute_tpu_torch.parallel import launch

    sharded = sorted(n for n, p in progcheck.default_programs().items()
                     if p.topology == "sharded")
    wd = tempfile.TemporaryDirectory()
    spec = multirank.prepare(
        wd.name, N_LOCAL, FILL, MIGRATION, state=state,
        parts=("vranks", "flat", "drift", "halo", "hier", "card_vs_cpu",
               "registry"), registry=sharded)
    spec["profile"] = bool(profile_dir)
    spec["profile_dir"] = profile_dir
    spec["go_file"] = os.path.join(wd.name, "go")
    world = {"wd": wd, "spec": spec, "sharded": sharded,
             "launched": time.time()}

    def run():
        try:
            world["results"] = launch.run_world(
                "mpi_grid_redistribute_tpu_torch.bench.multirank:"
                "world_main", 8, args=(spec,), backend="gloo",
                device="cuda", timeout=600, pg_timeout=300, nice=10)
        except BaseException as exc:  # re-raised by multirank_phase
            world["error"] = exc
        world["returned"] = time.time()

    world["thread"] = threading.Thread(target=run, name="multirank-world",
                                       daemon=True)
    world["thread"].start()

    def stop():
        if world["thread"].is_alive():
            Path(spec["go_file"] + ".abort").touch()
            world["thread"].join(60)

    atexit.register(stop)
    return world


def multirank_phase(torch, pt, config1_oracle, world, planar_out,
                    ghosts_future, smi, profile_dir):
    """The multi-rank paths: (a) NCCL at world size 1 here, then (b)-(d)
    in the gloo world :func:`launch_world` started: the vranks loop
    across 2 ranks and the flat loop across 8 at the bench width,
    GridRedistribute(mesh=) and the deposits across 8 ranks, and card
    against CPU at a small width; the same world records the registry's
    sharded programs (returned beside the summary as
    :func:`progcheck.world_entries`, for the tools phase).
    ``ghosts_future`` gives ``multirank.halo_oracle(multirank.HALO_N)``,
    computed in a thread."""
    from mpi_grid_redistribute_tpu_torch.analysis import progcheck
    from mpi_grid_redistribute_tpu_torch.bench import multirank

    spec, sharded = world["spec"], world["sharded"]
    with world["wd"]:
        t0 = time.perf_counter()
        nccl = nccl_phase(torch, pt, config1_oracle, world["wd"].name)
        nccl_s = time.perf_counter() - t0
        t0, go = time.perf_counter(), time.time()
        Path(spec["go_file"]).touch()
        world["thread"].join()
        world_s = time.perf_counter() - t0
        if "error" in world:
            raise world["error"]
        results = world["results"]
        # the one-process references (the drift part's final rows are the
        # world's)
        t0 = time.perf_counter()
        ref = multirank.reference(spec, "cuda", single=planar_out,
                                  halo_ghosts=ghosts_future.result())
        ref_s = time.perf_counter() - t0
        try:
            summary = multirank.verify(results, spec, ref, "cuda")
        except AssertionError as e:
            fail(f"multi-rank: {e}")
    label = MULTIRANK_LABEL
    vr, fl = summary["vranks"], summary["flat"]
    log(f"(b) vranks across 2 ranks ({label.format(w=2)}; {smi}): "
        f"{vr['slots']} slots, {vr['steps']} steps, ms/step per rank "
        f"{[round(x, 3) for x in vr['ms_per_step']]} (raw "
        f"{[round(x, 3) for x in vr['raw_ms_per_step']]}), kernel 2 a step per "
        f"rank {vr['kernel2_launches_a_step']}, kernel 1 "
        f"{vr['kernel1_launches']}, slab multisets equal to the "
        f"8-vrank run ({vr['compared']})")
    rd, cv = summary["redistribute"], summary["card_vs_cpu"]
    log(f"(c) flat across 8 ranks ({label.format(w=8)}; {smi}): ms/step "
        f"per rank with the mxu deposit "
        f"{[round(x, 3) for x in fl['ms_per_step_mxu']]} (raw "
        f"{[round(x, 3) for x in fl['raw_ms_per_step_mxu']]}), kernels 2/4/5 a "
        f"step {fl['kernel2_launches_a_step'][0]}/"
        f"{fl['kernel4_launches_a_step'][0]}/"
        f"{fl['kernel5_launches_a_step'][0]}, multisets "
        f"{fl['compared']}; GridRedistribute(mesh=) auto (sparse) and "
        f"planar byte-equal to the oracle at {rd['rows']} rows; deposits' "
        f"largest differences (kernel loop vs plain loop, kernel vs plain, "
        f"vs one device's plain density; tolerance "
        f"{multirank.DEPOSIT_TOL}): {fl['deposit_max_abs_err']}")
    dr, hl, hi = summary["drift"], summary["halo"], summary["hier"]
    log(f"(e) canonical drift loop across 8 ranks ({label.format(w=8)}; "
        f"{smi}): {dr['rows']} rows, config 5's deposit each step; ms/step "
        f"per rank, mxu {[round(x, 3) for x in dr['ms_per_step']['mxu']]} "
        f"(raw {[round(x, 3) for x in dr['raw_ms_per_step']['mxu']]}), "
        f"scan {[round(x, 3) for x in dr['ms_per_step']['scan']]} (raw "
        f"{[round(x, 3) for x in dr['raw_ms_per_step']['scan']]}); kernel "
        f"4/5 launches a step per rank {dr['kernel4_launches_a_step']}/"
        f"{dr['kernel5_launches_a_step']}; state byte-equal to the plain "
        f"loop, densities' largest differences (vs plain, vs one process's "
        f"plain density; tolerance {multirank.DEPOSIT_TOL}): "
        f"{dr['deposit_max_abs_err']}")
    log(f"(f) halo() across 8 ranks ({label.format(w=8)}; {smi}): "
        f"{hl['rows_a_rank']} rows a rank, width {hl['width']}, "
        f"{hl['ghosts']} ghosts equal to the one-card vrank engines' and "
        f"the oracle's sets; ms/exchange per rank planar "
        f"{[round(x, 3) for x in hl['ms']['auto']]}, row-major "
        f"{[round(x, 3) for x in hl['ms']['rowmajor']]}")
    log(f"(g) hierarchical across 8 ranks ({label.format(w=8)}; {smi}): "
        f"dcn_shape {hi['dcn_shape']} ({hi['n_pods']} pods), 'auto' -> "
        f"hierarchical, byte-equal to the oracle and to 'planar' at "
        f"{rd['rows']} rows; ms/call per rank "
        f"{[round(x, 3) for x in hi['ms']]} (planar "
        f"{[round(x, 3) for x in rd['ms']['planar']]}); cross_cap "
        f"{hi['cross_cap']}, mover_cap {hi['mover_cap']}")
    log(f"(d) card vs CPU at n_local={multirank.SMALL_N}, 2 ranks: "
        f"bit-equal {cv['bit_equal']}; density max abs difference "
        f"{cv['rho_max_abs_err']}")
    if profile_dir:
        for part, prof in (("(b) vranks", vr["profile"]),
                           ("(c) flat + mxu", fl["profile_mxu"])):
            log(f"{part} profile a step per rank (device busy ms, device "
                f"operations, host ms in collectives, NCCL device ms): "
                f"{[tuple(round(v, 3) for v in p) for p in prof]}")
    clocks = [res["clock"] for res in results]
    last = {k: max(c[k] for c in clocks)
            for k in ("entered", "set_up", "ready", "parts_from",
                      "parts_to")}
    split = {
        "to_target": last["entered"] - world["launched"],
        "set_up": last["set_up"] - last["entered"],
        "waited_for_the_go": go - last["set_up"],
        "after_the_go": last["parts_from"] - max(go, last["set_up"]),
        "parts": last["parts_to"] - last["parts_from"],
        "exit": world["returned"] - last["parts_to"],
    }
    log(f"multi-rank world of 8: {world_s:.1f} s from the go (started "
        f"{go - world['launched']:.1f} s ahead; seconds from the launch to "
        f"the last rank's target, its set-up, its wait for the go "
        f"(negative: the go waited for it), its kernel loads and groups "
        f"after the go, the parts, the exit: "
        f"{ {k: round(v, 1) for k, v in split.items()} }; rank 0's seconds "
        f"a part: "
        f"{ {k: round(v, 1) for k, v in results[0]['seconds'].items()} }); "
        f"NCCL at world size 1 {nccl_s:.1f} s; the one-process references "
        f"{ref_s:.1f} s")
    registry = progcheck.world_entries(
        [r["registry"] for r in results], sharded)
    return dict(summary, nccl=nccl, world_seconds=world_s,
                world_split=split,
                label=label.format(w="W"), card=smi), registry


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

    # the block route (a block per row, the row in shared memory): the
    # same elements as tiles of 2048, and rows of 8192
    block = {}
    for bt in (2048, 8192):
        check(dfscan.geometry(bt).route == "block",
              f"tile {bt} is not on kernel 5's block route")
        xb = x.reshape(-1, bt)
        hb = _signed_zero_rows_t(torch, xb)
        kb = dfscan.tile_df_cumsum_rows(hb)
        pb = dfscan.tile_df_cumsum_rows_plain(hb)
        torch.cuda.synchronize()
        check(all(torch.equal(u.view(torch.int32), v.view(torch.int32))
                  for u, v in zip(kb, pb)),
              f"tile_df_cumsum_rows block route != plain at "
              f"[{xb.shape[0]}, {bt}]")
        block[bt] = {
            "shape": list(xb.shape),
            "ms": profiling.cuda_time_ms(
                lambda: dfscan.tile_df_cumsum_rows(xb)),
            "plain_ms": profiling.cuda_time_ms(
                lambda: dfscan.tile_df_cumsum_rows_plain(xb), iters=3),
            "bound_ms": bound(*dfscan.kernel_cost(xb))[0],
        }
        del kb, pb, hb
    log(json.dumps({"dfscan_block_route": block}))

    ms = profiling.cuda_time_ms(lambda: dfscan.tile_df_cumsum_rows(x))
    plain_ms = profiling.cuda_time_ms(
        lambda: dfscan.tile_df_cumsum_rows_plain(x), iters=5
    )
    # the kernel's own count (ops/dfscan.kernel_cost): x read once, hi and
    # lo written once; 11 adds/subtracts per df_add, each an FMA's slot
    b_ms, b_by = bound(*dfscan.kernel_cost(x))
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


# the CIC cell's deposit (benchmark cell uniform_2x2x2_cic128.m2_s1): 8
# vranks of 2^23 slots, each a 64^3 block of the 128^3 mesh
CIC_CELL_VRANKS = 8
CIC_CELL_ROWS = CIC_CELL_VRANKS * (1 << 23)
CIC_CELL_VBLOCK = (64, 64, 64)
CIC_CELL_GROUP = 2  # the deposit's channel group above 2^24 rows
# cub's kernels of the payload sort, which rowsort.KERNEL.resource_usage()
# lists beside the pack (csrc/rowsort.cu's table, written for cub 2.8)
ROWSORT_CUB_KERNELS = (
    "cub::DeviceRadixSortHistogramKernel",
    "cub::DeviceRadixSortExclusiveSumKernel",
    "cub::DeviceRadixSortOnesweepKernel",
    "cub::DeviceRadixSortSingleTileKernel",
)


def cic_rows_phase(torch, dfscan, rowsort, profiling):
    """The scan deposit's payload sort and kernel 5's fused route at the
    CIC cell's deposit shape: 67.1M rows over 8 vranks of 64^3 cells
    (22-bit keys, ~10% of the rows on the sentinel, masses that are not
    1). ``rowsort.sort_rows`` against ``sort_rows_plain`` and, on the
    sorted rows, ``dfscan.cic_tile_prefix_rows`` against
    ``cic_tile_prefix_plain`` in the cell's 4 groups of 2 channels (one
    "packed" launch each), bit for bit; both timed beside their plain
    versions and their bounds. Returns the kernels line's entries of the
    two kernels (``launches`` filled in by the caller)."""
    m, vblock = CIC_CELL_ROWS, CIC_CELL_VBLOCK
    n_cells = 1
    for b in vblock:
        n_cells *= b
    n_seg = CIC_CELL_VRANKS * n_cells
    bits = n_seg.bit_length()
    gen = torch.Generator(device="cuda").manual_seed(23)
    valid = torch.rand(m, device="cuda", generator=gen) < 0.9
    rel = torch.where(valid, torch.rand((3, m), device="cuda",
                                        generator=gen) * 64.0, 0.0)
    mass = torch.where(valid, torch.rand(m, device="cuda", generator=gen)
                       * 1.5 + 0.5, 0.0)
    cell = rel.floor().to(torch.int32).clamp(0, 63)
    vrank = torch.arange(m, device="cuda", dtype=torch.int32) // (
        m // CIC_CELL_VRANKS)
    key = torch.where(valid, vrank * n_cells
                      + (cell[0] * vblock[1] + cell[1]) * vblock[2]
                      + cell[2], n_seg).to(torch.int32)
    del valid, cell, vrank

    launches0 = rowsort.KERNEL.launches
    keys_s, rows_s = rowsort.sort_rows(key, rel, mass, bits)
    keys_p, rows_p = rowsort.sort_rows_plain(key, rel, mass, bits)
    torch.cuda.synchronize()
    check(rowsort.KERNEL.launches == launches0 + 1,
          "sort_rows: not one launch a call")
    check(torch.equal(keys_s, keys_p)
          and torch.equal(rows_s.view(torch.int32), rows_p.view(torch.int32)),
          f"sort_rows != plain at {m} rows over {bits} bits")
    del keys_p, rows_p
    usage = rowsort.KERNEL.resource_usage()
    check(all(k in usage for k in ROWSORT_CUB_KERNELS),
          f"sort_rows: resource_usage() lists {sorted(usage)}, not cub's "
          f"kernels {ROWSORT_CUB_KERNELS} (another cub than 2.8?)")
    b_ms, b_by = bound(*rowsort.kernel_cost(key, rel, mass, bits))
    sort = {
        "name": "sort_rows",
        "route": "cuda",
        "source": "mpi_grid_redistribute_tpu_torch/csrc/rowsort.cu",
        "replaces": None,  # the reference's lax.sort, no TPU kernel
        "shape": [m],
        "bits": bits,
        "max_abs_err": 0.0,
        "ms": profiling.cuda_time_ms(
            lambda: rowsort.sort_rows(key, rel, mass, bits), iters=5),
        "plain_ms": profiling.cuda_time_ms(
            lambda: rowsort.sort_rows_plain(key, rel, mass, bits), iters=3),
        # the call's own count (ops/rowsort.kernel_cost): the key and the
        # payload read once, the sorted key and row written once
        "bound_ms": b_ms,
        "bound_by": b_by,
        # the plain version is PyTorch's own stable sort and gather
        "library_ms": None,
        "regs": {k: usage[k]["regs"] for k in
                 ("rowsort_pack_kernel<3>",) + ROWSORT_CUB_KERNELS},
    }
    del key, rel, mass, keys_s

    payload = rowsort.rows_as_payload(rows_s, 3).contiguous()
    g = CIC_CELL_GROUP
    for c0 in range(0, 1 << 3, g):
        routes0 = dict(dfscan.ROUTES)
        got = dfscan.cic_tile_prefix_rows(rows_s, vblock, c0, g, 256)
        want = dfscan.cic_tile_prefix_plain(payload, vblock, c0, g, 256)
        torch.cuda.synchronize()
        check(dfscan.ROUTES == dict(routes0, packed=routes0["packed"] + 1),
              f"cic_tile_prefix_rows: launched {dfscan.ROUTES} by route, "
              f"from {routes0}")
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"cic_tile_prefix_rows != plain at {m} rows, channels "
              f"{c0}..{c0 + g - 1}")
        del got, want
    b_ms, b_by = bound(*dfscan.cic_rows_kernel_cost(rows_s, vblock, 0, g,
                                                    256))
    fused = {
        "name": "tile_df_cumsum_rows",
        "route": "cuda, fused on the sorted rows (\"packed\")",
        "source": "mpi_grid_redistribute_tpu_torch/csrc/dfscan.cu",
        "replaces": "mpi_grid_redistribute_tpu/ops/pallas_dfscan.py:70",
        "shape": [m],
        "tile": 256,
        "group": g,
        "max_abs_err": 0.0,
        "ms": profiling.cuda_time_ms(
            lambda: dfscan.cic_tile_prefix_rows(rows_s, vblock, 0, g, 256),
            iters=5),
        "plain_ms": profiling.cuda_time_ms(
            lambda: dfscan.cic_tile_prefix_plain(payload, vblock, 0, g, 256),
            iters=2),
        # the launch's own count (ops/dfscan.cic_rows_kernel_cost): a row
        # read once a particle, hi and lo written once an element
        "bound_ms": b_ms,
        "bound_by": b_by,
        # no single PyTorch call computes a double-float prefix
        "library_ms": None,
    }
    del rows_s, payload
    torch.cuda.empty_cache()
    return sort, fused


def kernelcheck_phase(torch, _build):
    """``tools.kernelcheck --check``'s rules on the card over the seven
    registered cases (``analysis/kernelcheck.py``): K000 (each case
    launches its kernel), K001 (guard bands intact), K002 (write sets,
    three launches alike, duplicate refusal), K003 (Hopper limits, and
    equal to the committed footprint baseline for this nvcc) and K005
    (bit-equal to the plain twins)."""
    from mpi_grid_redistribute_tpu_torch.analysis import kernelcheck as kc
    from mpi_grid_redistribute_tpu_torch.analysis import rules_kernel
    from mpi_grid_redistribute_tpu_torch.analysis.baseline import (
        load_kernelcheck_baseline,
    )

    t0 = time.perf_counter()
    cases = kc.default_kernels()
    findings, footprints, _ = kc.run_kernelcheck(cases, device="cuda")
    findings += rules_kernel.compare_footprints(
        footprints, load_kernelcheck_baseline(), _build.nvcc_version(),
        check_stale=True)
    check(not findings, "kernelcheck: " + "; ".join(
        f.render() for f in findings))
    check(sorted(footprints) == sorted(cases),
          f"kernelcheck: K003 read {sorted(footprints)}")
    seconds = time.perf_counter() - t0
    log(f"kernelcheck: K000-K003, K005 clean over {len(cases)} cases in "
        f"{seconds:.2f} s")
    return {"cases": sorted(cases), "footprints": footprints,
            "seconds": round(seconds, 3)}


def deposit_span_phase(torch, _build, deposit, knockout_deposit):
    """The scan deposit's span table (``bench/knockout_deposit.py``) at a
    small width: one profiled call of whole deposits after a warm one,
    every ``dep:*`` span named with device time, the rows adding up to
    the call's device time within 2%, the profiled density bit-equal to
    config 5's scan deposit built on its own, and kernel 5 launched. No
    timing is kept."""
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.telemetry import phases

    state = knockout_deposit.make_state((2, 2, 2), 1 << 14, "cuda")
    _build.reset_counts()
    out, trace = phases.profile_call(knockout_deposit.make_loop(1), state,
                                     "cuda")
    launches = _build.counts()["tile_df_cumsum_rows"]
    rows = phases.phase_rows(trace, knockout_deposit.PHASES, steps=1)
    names = [r.phase for r in rows]
    check(names == list(knockout_deposit.PHASES) + [phases.REST],
          f"deposit spans: rows {names}")
    check(all(r.delta_s > 0 for r in rows[:-1]),
          f"deposit spans: a span read no device time: {rows}")
    whole = trace.seconds_in()
    total = sum(r.delta_s for r in rows)
    check(whole > 0 and abs(total - whole) <= 0.02 * whole,
          f"deposit spans: rows sum to {total:.6g} s, the call's device "
          f"time is {whole:.6g} s")
    ref = deposit.shard_deposit_device_planar_fn(
        Domain(0.0, 1.0, periodic=True), ProcessGrid((1, 1, 1)),
        (knockout_deposit.MESH_CELLS,) * 3)(*state)
    check(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
          "deposit spans: the profiled deposit is not bit-equal to the "
          "scan deposit")
    check(launches >= 2, f"deposit spans: kernel 5 launched {launches} "
          "time(s) over the warm and the profiled call")
    mass = float(state[2].sum())
    check(abs(float(out.double().sum()) - mass) <= 1e-3 * mass,
          "deposit spans: the mesh does not hold the deposited mass")
    log(f"deposit spans: {', '.join(names)} at {state[0].shape[1]} rows "
        f"sum to {total * 1e3:.4f} of {whole * 1e3:.4f} ms, bit-equal to "
        f"the scan deposit, kernel 5 launched {launches} times")
    return {"rows": int(state[0].shape[1]), "launches": launches,
            "spans": names, "sum_ms": round(total * 1e3, 4),
            "whole_ms": round(whole * 1e3, 4)}


def _signed_zero_rows_t(torch, x):
    """A copy of ``x`` with a row of -0.0 and one mixing +-0.0 with
    values (the adds of shifted-in zeros must turn -0.0 into +0.0)."""
    x = x.clone()
    x[1] = -0.0
    x[2, ::3] = -0.0
    x[2, 1::5] = 0.0
    return x


def segdep_phase(torch, segdep, common, profiling, kernel_times, stream):
    """Kernel 4 at the config-5 slab stream: N = 8 * 2^20 rows onto
    n_cells = 8 * 64^3 cells, unit mass (the loop's mxu deposit); and on
    the streams that put runs across its tile edges."""
    keys, rel, n_cells, vblock = stream
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
    del a, b, k1, k2, p

    r = np.random.default_rng(44)
    edges = common.segdep_edge_streams(segdep.TILE, r)
    for name, (keys_np, cells) in edges.items():
        ek = torch.from_numpy(keys_np).cuda()
        n = keys_np.shape[0]
        for d in (1, 2, 3, 4):
            vb = (8,) * d
            rd = torch.from_numpy(
                (r.integers(0, 32, (d, n)) * 0.25).astype(np.float32)).cuda()
            rg = torch.from_numpy(
                (r.random((d, n)) * 8).astype(np.float32)).cuda()
            md = torch.from_numpy(
                r.choice(np.float32([0.5, 1.0, 2.0]), n)).cuda()
            for mass in (None, md):
                x = segdep.segsum_sorted(ek, rd, mass, cells, vb)
                y = segdep.segsum_sorted_plain(ek, rd, mass, cells, vb)
                g1 = segdep.segsum_sorted(ek, rg, mass, cells, vb)
                g2 = segdep.segsum_sorted(ek, rg, mass, cells, vb)
                gp = segdep.segsum_sorted_plain(ek, rg, mass, cells, vb)
                torch.cuda.synchronize()
                what = (f"segsum_sorted on the {name} stream, D={d}, "
                        f"{'unit' if mass is None else 'dyadic'} mass")
                check(torch.equal(x.view(torch.int32), y.view(torch.int32)),
                      f"{what}: kernel != plain on dyadic data")
                check(torch.equal(g1.view(torch.int32), g2.view(torch.int32))
                      and bool(torch.allclose(g1, gp, rtol=2e-5, atol=2e-5)),
                      f"{what}: generic floats beyond 2e-5 or not "
                      f"run-to-run identical")
    log(f"segsum_sorted: bit-equal on the tile-edge streams {sorted(edges)} "
        f"for D = 1..4, with and without mass")

    # D = 4 (16 channels) on the config-5 stream's keys with a fourth rel
    # row: dyadic bit-equal, timed as a CUDA graph
    rel4 = torch.cat([rel_d, rel_d[:1]], dim=0).contiguous()
    vb4 = tuple(vblock) + (vblock[0],)
    a4 = segdep.segsum_sorted(keys, rel4, None, n_cells, vb4)
    p4 = segdep.segsum_sorted_plain(keys, rel4, None, n_cells, vb4)
    torch.cuda.synchronize()
    check(torch.equal(a4.view(torch.int32), p4.view(torch.int32)),
          "segsum_sorted kernel != plain at D = 4 on dyadic data")
    del a4, p4
    d4 = {
        "ms": profiling.cuda_graph_time_ms(
            lambda: segdep.segsum_sorted(keys, rel4, None, n_cells, vb4)),
        "bound_ms": bound(*segdep.kernel_cost(keys, rel4, None, n_cells,
                                              vb4))[0],
    }
    log(json.dumps({"segdep_d4": d4}))
    del rel4

    times = kernel_times.time_segdep(segdep, profiling, stream)
    for case, t in times.items():
        log(f"segsum_sorted {case}: {t['graph']:.5f} ms as a CUDA graph, "
            f"{t['eager']:.5f} ms eager")
    log(json.dumps({"segdep_times": times}))
    plain_ms = profiling.cuda_time_ms(
        lambda: segdep.segsum_sorted_plain(keys, rel, None, n_cells, vblock),
        iters=5,
    )
    # the kernel's own count (ops/segdep.kernel_cost): keys + 3 rel rows
    # read once, the [8, n_cells] canvas written once
    b_ms, b_by = bound(*segdep.kernel_cost(keys, rel, None, n_cells,
                                           vblock))
    return {
        "name": "segsum_sorted",
        "route": "cuda",
        "source": "mpi_grid_redistribute_tpu_torch/csrc/segdep.cu",
        "replaces": "mpi_grid_redistribute_tpu/ops/pallas_segdep.py:181",
        "max_abs_err": err,
        "ms": times["kernel"]["graph"],
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": times["index_add_"]["graph"],
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
        make_run, s1=4, s2=12, reps=2
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
    routes = dict(deposit.dfscan.ROUTES)
    syncs = (syncs - syncs2) / (COUNTED_STEPS - 2)
    guard = (guard - guard2) / (COUNTED_STEPS - 2)
    log(f"config5 {method}: launches over {COUNTED_STEPS} steps: "
        f"{launches}, kernel 5 by route {routes}; host syncs per step "
        f"{syncs:g} (residence-guard reads {guard:g}; the engine's sparse "
        f"guard is the other)")
    check_launches(launches, MIGRATE_KERNELS + DEPOSIT_KERNELS[method],
                   f"config5 {method}")
    # the scan deposit sorts its payload as rows (one sort_rows launch)
    # and, below 2^24 rows, takes all 8 channels in one fused launch of
    # kernel 5 on those rows
    want_packed = COUNTED_STEPS if method == "scan" else 0
    check(routes == {"rows": 0, "packed": want_packed},
          f"config5 {method}: kernel 5 launched {routes} by route")
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
        ops, busy, _ = profile_steps(torch, make_run, profile_dir,
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
        "dfscan_routes": routes,
        "device_busy_ms_per_step": busy,
    }, rho


def _owned(oracle, pt, pos_rows, counts, out_cap, label):
    """Every live row of each vrank's slice lies in that vrank's
    subdomain (the port's NumPy oracle binning, on the host)."""
    pos_rows = pos_rows.cpu().numpy()
    counts = counts.cpu().numpy()
    shards = [pos_rows[v * out_cap: v * out_cap + counts[v]]
              for v in range(len(counts))]
    try:
        oracle.assert_ownership(pt.Domain(0.0, 1.0, periodic=True),
                                pt.ProcessGrid(GRID), shards)
    except AssertionError as e:
        fail(f"{label}: {e}")


def canonical_phase(torch, pt, config1_oracle, oracle, profiling,
                    profile_dir):
    """The canonical ``GridRedistribute.redistribute`` on the card: config
    1 against the NumPy oracle, then the headline width per call, then the
    planar canonical step in a drift loop. Returns ``(summary, (rd,
    out))``: the headline call's redistributor and output, which the
    halo phase exchanges."""
    V = int(np.prod(GRID))

    # ---- config 1, byte-equal to the oracle (positions, fields, count,
    # every stats leaf; oracle_check raises on any difference)
    n1 = 1 << 20
    t0 = time.perf_counter()
    res, _, rd1 = config1_oracle.oracle_check(n1)
    check(res.positions.is_cuda, "config 1 did not run on the card")
    check(int(res.count.sum()) == n1
          and int(res.stats.dropped_send.sum()) == 0
          and int(res.stats.dropped_recv.sum()) == 0,
          "config 1: rows lost")
    oc1 = res.positions.shape[0] // V
    _owned(oracle, pt, res.positions, res.count, oc1, "config 1")
    log(f"config 1: GridRedistribute on the card byte-equal to the NumPy "
        f"oracle (positions, 2 fields, count, 5 stats leaves) at N = {n1}, "
        f"grid {GRID} as {V} vranks, capacity {rd1._capacities(n1 // V)[0]},"
        f" out_capacity {oc1}; {time.perf_counter() - t0:.1f} s with the "
        f"oracle")
    del res, rd1

    # ---- the headline width: 2^20 rows per vrank through the public call
    N = V * N_LOCAL
    args = tuple(torch.from_numpy(a).cuda()
                 for a in config1_oracle.inputs(N))
    rd = pt.GridRedistribute(lo=0.0, hi=1.0, periodic=True, grid=GRID,
                             capacity_factor=config1_oracle.CAPACITY_FACTOR)
    for _ in range(3):  # calibration: the synchronous checks (and growth)
        out = rd.redistribute(*args)
    check(rd._clean_checks >= 2, "canonical: not calibrated after 3 calls")
    fetches = rd._blocking_fetches
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = rd.redistribute(*args)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    call_ms = sorted(a.elapsed_time(b) for a, b in times)
    _, syncs = synced_run(
        torch, lambda: [rd.redistribute(*args) for _ in range(CANON_CALLS)])
    check(syncs == 0 and rd._blocking_fetches == fetches,
          f"canonical: {syncs} host syncs and "
          f"{rd._blocking_fetches - fetches} blocking reads in "
          f"{CANON_CALLS} steady-state calls")
    out = rd.redistribute(*args)
    rd.flush_overflow_checks()  # raises on any drop since calibration
    check(int(out.count.sum()) == N
          and int(out.stats.dropped_send.sum()) == 0
          and int(out.stats.dropped_recv.sum()) == 0,
          "canonical: rows lost at the headline width")
    cap, out_cap = rd._capacities(N_LOCAL)
    _owned(oracle, pt, out.positions, out.count, out_cap,
           "canonical headline call")
    check(bool(torch.isfinite(out.positions).all()),
          "canonical: non-finite positions")
    log(f"canonical call: {call_ms[0]:.4f} ms/call (min of k=10, median "
        f"{statistics.median(call_ms):.4f}) at {N} rows (2^20 per vrank), "
        f"capacity {cap}, out_capacity {out_cap}; host syncs per "
        f"steady-state call {syncs / CANON_CALLS:g} over {CANON_CALLS} "
        f"calls; conservation, zero drops and ownership hold")
    call_busy = None
    if profile_dir:
        def make_calls(S):
            return lambda: [rd.redistribute(*args) for _ in range(S)]

        ops, call_busy, _ = profile_steps(torch, make_calls, profile_dir,
                                          "canonical_call")
        log(f"canonical call profile: {ops:.1f} device operations/call, "
            f"device busy {call_busy:.4f} ms/call of {call_ms[0]:.4f} (idle "
            f"{1 - call_busy / call_ms[0]:.2%})")
    rd.flush_overflow_checks()
    del args

    # ---- the planar canonical step in a drift loop
    fused, count = config1_oracle.drift_state(N_LOCAL)
    f0 = torch.from_numpy(fused).cuda()
    c0 = torch.from_numpy(count).cuda()
    loop = config1_oracle.make_loop_planar(N_LOCAL)

    def make_run(S):
        return lambda: loop(f0, c0, S)

    detail, _ = profiling.cuda_time_per_step_samples(make_run, s1=4, s2=12,
                                                     reps=4)
    per_step = detail["min"]
    _, syncs2 = synced_run(torch, make_run(2))
    (f, c, drops), syncs6 = synced_run(torch, make_run(COUNTED_STEPS))
    step_syncs = (syncs6 - syncs2) / (COUNTED_STEPS - 2)
    check(int(drops) == 0 and int(c.sum()) == V * N_LOCAL,
          "canonical step: rows lost in the drift loop")
    slots = f.shape[2]
    _owned(oracle, pt, f[:, :3].transpose(1, 2).reshape(-1, 3), c, slots,
           "canonical drift loop")
    log(f"canonical step: {per_step * 1e3:.4f} ms/step (min of "
        f"k={detail['k']}, median {detail['median'] * 1e3:.4f}, spread "
        f"{detail['spread'] * 100:.2f}%) at {V * N_LOCAL} rows, {slots} "
        f"slots a vrank, capacity {config1_oracle.loop_sizing(N_LOCAL)[1]};"
        f" host syncs per step {step_syncs:g}; conservation, zero drops "
        f"and ownership over {COUNTED_STEPS} steps")
    check(step_syncs == 0, f"canonical step: {step_syncs} host syncs/step")
    step_busy = None
    if profile_dir:
        step_busy = write_profile(torch, make_run, profile_dir, per_step,
                                  "canonical_step")
    return {
        "config1_bit_equal": True,
        "ms_per_call": call_ms[0],
        "median_ms_per_call": statistics.median(call_ms),
        "host_syncs_per_call": syncs / CANON_CALLS,
        "device_busy_ms_per_call": call_busy,
        "ms_per_step": per_step * 1e3,
        "median_ms_per_step": detail["median"] * 1e3,
        "spread": detail["spread"],
        "host_syncs_per_step": step_syncs,
        "device_busy_ms_per_step": step_busy,
    }, (rd, out)


# the public calls canonical_phase makes on its headline instance:
# calibration, the timed calls, the sync-counted ones and the last one
CANON_HEADLINE_CALLS = 3 + 10 + CANON_CALLS + 1


def telemetry_phase(torch, pt, headline, ms_per_call):
    """The telemetry surface of the canonical phase's headline instance,
    on the card: ``report()`` at the measured call time, ``flow()``,
    ``health()``, ``metrics(render=True)`` and ``to_perfetto()``. Rows
    conserved in the report, the flow's row sums the send totals, status
    OK, the journal's ``redistribute`` count the calls made; one read off
    the device each for ``report()`` and ``flow()``, none for the
    others."""
    rd, out = headline
    V = int(np.prod(GRID))
    t0 = time.perf_counter()
    rep, rep_syncs = synced_run(
        torch, lambda: rd.report(step_seconds=ms_per_call / 1e3))
    fl, flow_syncs = synced_run(torch, lambda: rd.flow(k=3))
    (health, text, trace), other_syncs = synced_run(torch, lambda: (
        rd.health(), rd.metrics(render=True), rd.to_perfetto()))
    seconds = time.perf_counter() - t0
    counts = rd.telemetry.counts()
    check(rep["stats"]["total_rows"] == V * N_LOCAL
          and rep["stats"]["dropped_send"] == 0
          and rep["stats"]["dropped_recv"] == 0,
          f"telemetry: report rows {rep['stats']}")
    check(rep["exchange_domain"] == "hbm" and rep["engine"] == "planar"
          and rep["bw_util"] is not None and rep["bw_util"] > 0,
          f"telemetry: report {rep['exchange_domain']} {rep['engine']} "
          f"{rep['bw_util']}")
    send = out.stats.send_counts.sum(dim=1).tolist()
    check(fl["matrix"].sum(axis=1).tolist() == send,
          f"telemetry: flow row sums {fl['matrix'].sum(axis=1).tolist()} "
          f"are not the send totals {send}")
    check(health["status"] == "OK", f"telemetry: health {health}")
    # one journaled attempt a call, and one more a call that grew
    calls = [e.data["call"] for e in rd.telemetry.events("redistribute")]
    grown = {e.data["call"] for e in rd.telemetry.events("capacity_grow")}
    check(rd._call_index == CANON_HEADLINE_CALLS
          and sorted(set(calls)) == list(range(1, CANON_HEADLINE_CALLS + 1))
          and len(calls) == CANON_HEADLINE_CALLS + len(grown),
          f"telemetry: {len(calls)} redistribute events for "
          f"{rd._call_index} calls ({CANON_HEADLINE_CALLS} made, "
          f"{len(grown)} grew)")
    check(text.endswith("# EOF\n") and
          f'grid_journal_events_total{{kind="redistribute"}} '
          f'{len(calls)}' in text,
          "telemetry: the rendered metrics miss the redistribute count")
    check(len(trace["traceEvents"]) > CANON_HEADLINE_CALLS,
          "telemetry: the Perfetto trace misses journal events")
    check((rep_syncs, flow_syncs, other_syncs) == (1, 1, 0),
          f"telemetry: host syncs report/flow/others {rep_syncs}/"
          f"{flow_syncs}/{other_syncs}, expected 1/1/0")
    log(f"telemetry: report {rep['exchange_bytes_per_step'] / 1e6:.3f} "
        f"MB/call, {rep['exchange_gb_per_sec']:.2f} GB/s, bw_util "
        f"{rep['bw_util']:.4f} of HBM3 at {ms_per_call:.4f} ms/call; flow "
        f"hot links {fl['hot_links']}; health {health['status']}; journal "
        f"{counts}; {len(text.splitlines())} metric lines, "
        f"{len(trace['traceEvents'])} trace events; {seconds:.3f} s for "
        f"the five calls")
    return {
        "report_bw_util": rep["bw_util"],
        "exchange_bytes_per_call": rep["exchange_bytes_per_step"],
        "health": health["status"],
        "journal": counts,
        "host_syncs": [rep_syncs, flow_syncs, other_syncs],
        "seconds": seconds,
    }


HEADLINE_BASELINE_N = 1 << 18  # the CPU comparators' rows in the smoke


def bench_py_keys():
    """The keys of the JSON line ``bench.py``'s ``main`` prints, read from
    its source (it is never run here)."""
    import ast

    tree = ast.parse((HERE / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "dumps" and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    fail("no json.dumps({...}) in bench.py's main")


def headline_phase(torch, _build, headline_bench):
    """One short run of the headline bench (``bench/headline.py``) on the
    card: S1 = 2, S2 = 6, one long run, a small CPU comparator; its keys
    are ``bench.py``'s, and kernels 1 and 2 launch once a step (the bench
    checks it too, as it checks drops and conservation)."""
    s1, s2, reps = 2, 6, 1
    t0 = time.perf_counter()
    # the rebalance leg and config 10 run through the service driver in
    # the driver phase, config 8 from its own script (and they fill
    # these keys in the bench's own run)
    skip = {"BENCH_REBALANCE": "0", "BENCH_SERVICE": "0", "BENCH_SOAK": "0"}
    saved = {k: os.environ.get(k) for k in skip}
    os.environ.update(skip)
    _build.reset_counts()
    try:
        line = headline_bench.measure(n_local=N_LOCAL, device="cuda", s1=s1,
                                      s2=s2, reps=reps,
                                      baseline_n=HEADLINE_BASELINE_N)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = _build.counts()
    seconds = time.perf_counter() - t0
    steps = (reps + 1) * (s1 + s2)
    for name in MIGRATE_KERNELS:
        check(launches[name] == steps,
              f"headline: {name} launched {launches[name]} times in "
              f"{steps} steps")
    keys = bench_py_keys()
    check(list(line) == keys,
          f"headline: keys {sorted(set(line) ^ set(keys))} differ from "
          f"bench.py's")
    check(line["value"] > 0 and line["vs_baseline"] > 0
          and line["exchange_domain"] == "hbm",
          f"headline: {line}")
    for k in ("stress", "hier", "exchange_dcn_bytes_per_step",
              "exchange_ici_bytes_per_step"):
        check(line[k] is not None, f"headline: {k} is null")
    check(line["rebalance"] is None and line["service"] is None
          and line["soak"] is None,
          "headline: BENCH_REBALANCE/BENCH_SERVICE/BENCH_SOAK=0 did not "
          "skip")
    check(line["stress"]["migration_fraction"] > 0.8,
          f"headline: stress migration {line['stress']['migration_fraction']}"
          f" is not a full reshuffle")
    check(line["hier"]["engine"] == "hierarchical"
          and line["exchange_dcn_bytes_per_step"]
          == line["hier"]["dcn_bytes_per_step"] > 0,
          f"headline: hier {line['hier']}")
    log(f"headline (short run, S1={s1}, S2={s2}, reps={reps}, CPU "
        f"comparators at {HEADLINE_BASELINE_N} rows): {json.dumps(line)}; "
        f"{seconds:.1f} s")
    return line


STRESS_ROWS = 1 << 20  # config 7's largest sweep size


def config7_phase(torch, config7_stress):
    """Config 7's full reshuffle at 2^20 total rows, one timed long run:
    ms/step, GB/s and utilization of the HBM3 roof; the run itself
    raises on a dropped or lost row."""
    t0 = time.perf_counter()
    out = config7_stress.run(n_total=STRESS_ROWS, reps=1, device="cuda")
    check(out["migration_fraction"] > 0.8 and out["exchange_domain"] == "hbm",
          f"config7: {out}")
    log(f"config7 (full reshuffle, {out['rows']} rows, {out['row_bytes']} B "
        f"a row): {out['ms_per_step']} ms/step, "
        f"{out['exchange_gb_per_sec']} GB/s, bw_util {out['bw_util']} of "
        f"the HBM3 roof, {out['migration_fraction']:.2%} of rows moved a "
        f"step; nothing dropped, rows conserved; "
        f"{time.perf_counter() - t0:.1f} s")
    return out


SERVICE_CHUNK = 16
SERVICE_SMALL = 4096  # the card-against-CPU width


def _same_tree(torch, a, b) -> bool:
    """Bit equality of two chunk outputs (tensors, tuples, dicts), the
    second on the CPU."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(
            _same_tree(torch, a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(
            _same_tree(torch, x, y) for x, y in zip(a, b))
    if a is None:
        return b is None
    return tuple(a.shape) == tuple(b.shape) and torch.equal(
        a.cpu().contiguous().view(torch.uint8),
        b.contiguous().view(torch.uint8))


def _sync_free(torch, _build, macro, state):
    """``(out, launches)``: one macro under sync debug mode "error" (a
    host sync raises), every kernel count set to 0 just before it and
    read just after."""
    torch.cuda.synchronize()
    _build.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = macro(*state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, _build.counts()


def service_phase(torch, _build, migrate, overlay, profiling, kernel_times,
                  service_chunk, profile_dir):
    """The chunked service step at the bench shape (``bench.
    service_chunk``: 8 vranks of 2^20 rows, fill 0.9, ~2% migration at
    dt 1.0, pos/vel/ids, ``out_capacity = n_local``, chunks of 16): the
    sequential and the pipelined macro on the same inputs with zero host
    syncs inside each (sync debug "error"), the pipelined one launching
    kernel 2 once a step, no kernel in the sequential one; their particle
    sets, counts, per-step counts and send tables equal, nothing dropped,
    every pipelined step armed; kernel 2 held against its plain version
    at the pipelined landing's own operands (K = 9 with the key row, K =
    8 at the end) and timed there; both macros at a small width bit-equal
    to the CPU run; ms/step of each and of the eager loop."""
    t0 = time.perf_counter()
    rd, state = service_chunk.prepare(N_LOCAL, "cuda")
    seq, pipe = service_chunk.build(rd, state, SERVICE_CHUNK)
    seq_out, seq_n = _sync_free(torch, _build, seq, state)
    check(not any(seq_n.values()),
          f"service: the sequential chunk launched {seq_n}")
    pipe_out, pipe_n = _sync_free(torch, _build, pipe, state)
    check(pipe_n["overlay_scatter_planar"] == SERVICE_CHUNK
          and sum(pipe_n.values()) == SERVICE_CHUNK,
          f"service: the pipelined chunk launched {pipe_n} in "
          f"{SERVICE_CHUNK} steps")
    try:
        checked = service_chunk.check_pair(seq_out, pipe_out)
    except RuntimeError as e:
        fail(f"service: {e}")
    del seq_out, pipe_out
    # kernel 2 at the pipelined landing's operands
    seen = []
    orig = migrate._land_scatter

    def rec(flat, targets, cols, impl="overlay", plain=False):
        seen.append((flat.clone(), targets.clone(), cols.clone()))
        del seen[1:-1]
        return orig(flat, targets, cols, impl, plain)

    migrate._land_scatter = rec
    try:
        pipe(*state)
    finally:
        migrate._land_scatter = orig
    check([f.shape[0] for f, _, _ in seen] == [9, 8],
          f"service: landings of K {[f.shape[0] for f, _, _ in seen]}")
    landing = {}
    for flat, t, cols in seen:
        K = flat.shape[0]
        a = overlay.overlay_scatter_planar(flat.clone(), t, cols)
        b = overlay.overlay_scatter_planar_plain(flat.clone(), t, cols)
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"service: kernel 2 != plain at K = {K}")
        n_ok = int(((t >= 0) & (t < flat.shape[1])).sum())
        times = kernel_times.time_overlay(overlay, profiling, flat, cols, t)
        work = flat.clone()
        plain_ms = profiling.cuda_time_ms(
            lambda: overlay.overlay_scatter_planar_plain(work, t, cols))
        P = t.shape[0]
        # the kernel's own count (ops/overlay.kernel_cost): every target
        # read, the in-range columns read and written
        b_ms, b_by = bound(*overlay.kernel_cost(flat, t, cols))
        landing[f"K{K}"] = {
            "shape": list(flat.shape), "targets": P, "in_range": n_ok,
            "max_abs_err": max_abs_err(a, b), "ms": times["kernel"]["graph"],
            "eager_ms": times["kernel"]["eager"], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": times["index_put_"]["graph"]}
        del a, b, work
    del seen
    # card against the CPU at a small width
    small = {}
    for dev in ("cuda", "cpu"):
        rd_s, st_s = service_chunk.prepare(SERVICE_SMALL, dev)
        small[dev] = [m(*st_s) for m in service_chunk.build(
            rd_s, st_s, SERVICE_CHUNK)]
    for name, a, b in zip(("sequential", "pipelined"), small["cuda"],
                          small["cpu"]):
        check(_same_tree(torch, a, b),
              f"service: the {name} chunk on the card differs from the CPU "
              f"run at {SERVICE_SMALL} rows a vrank")
    del small
    times = service_chunk.time_paths(rd, state, SERVICE_CHUNK, reps=1,
                                     busy=bool(profile_dir))
    log(f"service chunk ({checked['rows']} rows, chunk {SERVICE_CHUNK}, "
        f"{checked['migration_fraction']:.3%} migration a step): "
        + "; ".join(f"{k} {v['ms_per_step']:.4f} ms/step (median "
                    f"{v['median_ms_per_step']:.4f})"
                    + (f", device busy {v['device_busy_ms_per_step']:.4f}, "
                       f"idle {v['idle']:.2%}" if "idle" in v else "")
                    for k, v in times.items())
        + f"; 0 host syncs in each macro, kernel 2 {SERVICE_CHUNK} launches "
        f"in the pipelined one; particle sets equal, nothing dropped, every "
        f"step armed; card == CPU at {SERVICE_SMALL} rows a vrank; kernel 2 "
        f"at the landing: "
        + ", ".join(f"{k} {v['ms']:.5f} ms (plain {v['plain_ms']:.5f}, "
                    f"index_put_ {v['library_ms']:.5f}, bound "
                    f"{v['bound_ms']:.5f})" for k, v in landing.items())
        + f"; {time.perf_counter() - t0:.1f} s")
    return dict(checked, launches=pipe_n, times=times, landing=landing)


DRIVER_STEPS = 16
DRIVER_SUP_N_LOCAL = 1 << 17  # the supervised, elastic and history legs
HISTORY_STEPS = 48  # the history leg: 3 chunks of 16, snapshots every 16
HISTORY_CORRUPT = 24  # the NaN burst, before step 25


def _device_set(torch, state):
    """The particle set of a driver state on the card: the live rows'
    ``(ids, pos, vel)`` sorted by id, as one uint8 tensor (the bytes
    ``service.particle_set`` compares, without the trip to the host)."""
    pos, vel, ids, count = state
    n = ids.shape[0] // count.shape[0]
    live = (torch.arange(n, device=ids.device)[None, :]
            < count[:, None]).reshape(-1)
    i = ids[live]
    order = torch.argsort(i, stable=True)
    return torch.cat([t[live][order].contiguous().view(torch.uint8)
                      .reshape(-1) for t in (ids, pos, vel)])


def _driver_run(torch, _build, tservice, cfg, steps, sync_free=False,
                state=None):
    """``(driver, ms/step, kernel counts)``: a fresh driver of ``cfg`` run
    ``steps`` steps from ``state`` (copies of its tensors; default: the
    seeded one), every kernel count set to 0 just before the run and
    read just after; with ``sync_free`` every chunk is issued under sync
    debug "error" (a host read inside a chunk raises)."""
    drv = tservice.ServiceDriver(cfg)
    if state is None:
        drv.init_state()
    else:
        drv.state = tuple(t.clone() for t in state)
    if sync_free:
        real = drv._macro_fn

        def guarded(n):
            macro, cap, out_cap = real(n)

            def run(*state):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return macro(*state)
                finally:
                    torch.cuda.set_sync_debug_mode("default")

            return run, cap, out_cap

        drv._macro_fn = guarded
    torch.cuda.synchronize()
    _build.reset_counts()
    t0 = time.perf_counter()
    drv.run(max_steps=steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    counts = _build.counts()
    return drv, ms, counts


def driver_phase(torch, _build, work):
    """The service driver on the card (``service.ServiceDriver``,
    ``device=None``): (a) 16 steps eager, as one chunk of 16 under sync
    debug "error" and pipelined, one particle set, kernel 2 once a step
    in the pipelined leg and no kernel elsewhere; (b) a synchronous
    snapshot at step 8 and its restore into a fresh driver, byte-equal,
    timed; (c) a supervised run at 2^17 rows a vrank with a crash at step
    10 and one restart, the uninterrupted run's particle set, and an
    elastic restore onto (2, 2, 1); (d) config 4's rebalance leg on the
    torch backend, every clause of its gate; (e) the history plane: a
    supervised pipelined run in chunks of 16 at 2^17 rows a vrank with a
    journal store, an incident directory, ``probes="counters"`` and a NaN
    burst: one restart, one bundle naming the step, the store verified
    with the recorder's counts, kernel 2 launched in the leg, and the
    drains' seconds beside the leg's."""
    from mpi_grid_redistribute_tpu_torch import service as tservice
    from mpi_grid_redistribute_tpu_torch.bench import config4_drift
    from mpi_grid_redistribute_tpu_torch.telemetry import StepRecorder

    t_phase = time.perf_counter()
    out, laps = {}, {}
    base = tservice.DriverConfig(grid_shape=GRID, n_local=N_LOCAL, fill=0.8,
                                 steps=DRIVER_STEPS, seed=0)
    # (a) the same 16 steps three ways; (b) the eager leg snapshots at 8
    t0 = time.perf_counter()
    snap_dir = work / "driver_snaps"
    eager_cfg = dataclasses.replace(base, snapshot_dir=str(snap_dir),
                                    snapshot_async=False)
    seed = tservice.ServiceDriver(base)
    seed.init_state()
    start = seed.state  # the drivers replace a state, never write into it
    del seed
    drv, ms8, n_eager = _driver_run(torch, _build, tservice, eager_cfg, 8,
                                    state=start)
    t1 = time.perf_counter()
    path = drv.snapshot()
    snap_s = time.perf_counter() - t1
    want = drv.host_state()
    _build.reset_counts()
    t2 = time.perf_counter()
    drv.run()
    torch.cuda.synchronize()
    ms_eager = (ms8 * 8 + (time.perf_counter() - t2) * 1e3) / DRIVER_STEPS
    for k, v in _build.counts().items():
        n_eager[k] = n_eager.get(k, 0) + v
    drv.close()
    check(not any(n_eager.values()),
          f"driver: the eager leg launched {n_eager}")
    sets = {"eager": _device_set(torch, drv.state)}
    fresh = tservice.ServiceDriver(eager_cfg)
    t3 = time.perf_counter()
    check(fresh.restore_latest() and fresh.step == 8,
          "driver: restore_latest did not find the step-8 snapshot")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t3
    got = fresh.host_state()
    check(all(a.tobytes() == b.tobytes() for a, b in zip(got, want)),
          "driver: the restored state is not the snapshot's bytes")
    snap_mb = sum(a.nbytes for a in want) / 1e6
    del drv, fresh, got, want
    laps["eager+snapshot"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    legs = {"eager": {"ms_per_step": ms_eager, "launches": n_eager}}
    for name, kw in (("chunked", dict(chunk=DRIVER_STEPS)),
                     ("pipelined", dict(chunk=DRIVER_STEPS, pipeline=True))):
        drv, ms, n = _driver_run(
            torch, _build, tservice, dataclasses.replace(base, **kw),
            DRIVER_STEPS, sync_free=True, state=start)
        sets[name] = _device_set(torch, drv.state)
        dropped = sum(e.data["dropped"]
                      for e in drv.recorder.events("step_latency"))
        check(dropped == 0, f"driver: the {name} leg dropped {dropped}")
        legs[name] = {"ms_per_step": ms, "launches": n}
        drv.close()
        del drv
    check(legs["chunked"]["launches"].get("overlay_scatter_planar", 0) == 0
          and not any(legs["chunked"]["launches"].values()),
          f"driver: the chunked leg launched {legs['chunked']['launches']}")
    n_pipe = legs["pipelined"]["launches"]
    check(n_pipe.get("overlay_scatter_planar") == DRIVER_STEPS
          and sum(n_pipe.values()) == DRIVER_STEPS,
          f"driver: the pipelined leg launched {n_pipe} in {DRIVER_STEPS} "
          f"steps")
    check(torch.equal(sets["chunked"], sets["eager"])
          and torch.equal(sets["pipelined"], sets["eager"]),
          "driver: the three legs' particle sets differ")
    del sets, start
    laps["chunked+pipelined"] = time.perf_counter() - t0
    # (c) supervised: a crash at step 10, one restart from step 8
    t0 = time.perf_counter()
    sup_dir = work / "driver_sup"
    sup_cfg = dataclasses.replace(base, n_local=DRIVER_SUP_N_LOCAL, chunk=4,
                                  snapshot_every=4, snapshot_dir=str(sup_dir))
    rec = StepRecorder()
    plan = tservice.FaultPlan([tservice.CrashFault(10)])
    sup = tservice.Supervisor(
        lambda: tservice.ServiceDriver(sup_cfg, recorder=rec, faults=plan),
        policy=tservice.RestartPolicy(backoff_base_s=0.01,
                                      backoff_cap_s=0.02),
        recorder=rec)
    verdict = sup.run()
    check(verdict.ok and verdict.restarts == 1
          and verdict.step == DRIVER_STEPS,
          f"driver: supervised run {verdict}")
    check(rec.last("restore").data["step"] == 8,
          "driver: the restart did not restore the step-8 snapshot")
    sup_set = tservice.particle_set(*sup.driver.state)
    ref, _, _ = _driver_run(torch, _build, tservice,
                            dataclasses.replace(sup_cfg, snapshot_every=0,
                                                snapshot_dir=None),
                            DRIVER_STEPS)
    ref.close()
    check(sup_set == tservice.particle_set(*ref.state),
          "driver: the restarted run's particle set is not the "
          "uninterrupted run's")
    el = tservice.ServiceDriver(sup_cfg)
    check(el.restore_latest(grid_shape=(2, 2, 1)) and el.step == DRIVER_STEPS,
          "driver: no elastic restore of the step-16 snapshot")
    reshard = el.recorder.last("reshard").data
    check(tuple(el.cfg.grid_shape) == (2, 2, 1)
          and tservice.particle_set(*el.state) == sup_set,
          "driver: the elastic restore onto (2, 2, 1) changed the "
          "particle set")
    del sup, ref, el
    laps["supervised+elastic"] = time.perf_counter() - t0
    # (d) config 4's rebalance leg on the card
    t0 = time.perf_counter()
    reb = config4_drift.run_rebalance(backend="torch")
    clauses = config4_drift.rebalance_checks(reb)
    check(all(clauses.values()),
          f"driver: rebalance clauses failed: "
          f"{[k for k, v in clauses.items() if not v]}")
    laps["rebalance"] = time.perf_counter() - t0
    # (e) the history plane under a corruption restart
    t0 = time.perf_counter()
    history = history_leg(torch, _build, tservice, base, work)
    laps["store+incident"] = time.perf_counter() - t0
    out = {
        "legs": legs, "snapshot_s": snap_s, "restore_s": restore_s,
        "snapshot_mb": snap_mb, "snapshot": path,
        "supervised": {"restarts": verdict.restarts, "step": verdict.step,
                       "n_local": DRIVER_SUP_N_LOCAL},
        "elastic": {"new_grid": reshard["new_grid"],
                    "moved": reshard["moved"], "rows": reshard["rows"]},
        "rebalance": {k: reb[k] for k in (
            "steady_ms_per_step", "baseline_steady_ms_per_step", "speedup",
            "rebalances_applied", "post_rebalance_imbalance",
            "rows_moved", "bit_identical")},
        "history": history,
        "seconds": laps,
    }
    log(f"service driver ({GRID} as 8 vranks of {N_LOCAL} rows, fill 0.8, "
        f"{DRIVER_STEPS} steps): eager {ms_eager:.4f}, chunked "
        f"{legs['chunked']['ms_per_step']:.4f}, pipelined "
        f"{legs['pipelined']['ms_per_step']:.4f} ms/step (host clock, "
        f"first builds included); one particle set; kernel 2 "
        f"{n_pipe['overlay_scatter_planar']} launches in the pipelined leg; "
        f"snapshot {snap_mb:.1f} MB in {snap_s:.3f} s, restore "
        f"{restore_s:.3f} s, byte-equal; supervised crash/restart and the "
        f"elastic restore onto (2, 2, 1) keep the particle set; rebalance "
        f"{reb['steady_ms_per_step']} vs {reb['baseline_steady_ms_per_step']}"
        f" ms/step, post-imbalance {reb['post_rebalance_imbalance']}; "
        f"history leg: {history['restarts']} restart, bundle at step "
        f"{history['nan_step']}, store verified ({history['drains']} drains, "
        f"{history['drain_s']:.4f} s = {100 * history['drain_share']:.3f}% "
        f"of the leg's {history['run_s']:.3f} s), kernel 2 "
        f"{history['launches'].get('overlay_scatter_planar', 0)} launches; "
        f"seconds " + ", ".join(f"{k} {v:.1f}" for k, v in laps.items())
        + f"; {time.perf_counter() - t_phase:.1f} s")
    return out


def history_leg(torch, _build, tservice, base, work):
    """The driver's history plane on the card: a supervised run of
    ``HISTORY_STEPS`` steps pipelined in chunks of 16 at 2^17 rows a vrank
    with ``store_dir``, ``incident_dir``, ``probes="counters"`` and a NaN
    burst at step ``HISTORY_CORRUPT``. Holds exactly one restart, one
    ``nan_detected`` bundle naming the NaN step, a restore from before
    it, ``StoreReader(verify=True)`` with the recorder's counts and no
    duplicate row, and kernel 2's launches in the leg (counts set to 0
    just before the run). Times every drain on the loop's thread."""
    from mpi_grid_redistribute_tpu_torch.bench import service_driver
    from mpi_grid_redistribute_tpu_torch.telemetry import (
        StepRecorder,
        incident,
    )
    from mpi_grid_redistribute_tpu_torch.telemetry.store import StoreReader
    from mpi_grid_redistribute_tpu_torch.tools import storecheck

    store_dir, inc_dir = work / "history_store", work / "history_incidents"
    cfg = dataclasses.replace(
        base, n_local=DRIVER_SUP_N_LOCAL, steps=HISTORY_STEPS, chunk=16,
        pipeline=True, probes="counters", snapshot_every=16,
        snapshot_dir=str(work / "history_snaps"), store_dir=str(store_dir),
        incident_dir=str(inc_dir))
    rec = StepRecorder()
    plan = tservice.FaultPlan(
        [tservice.StateCorruptionFault(HISTORY_CORRUPT, rows=8)])
    timed = []  # one list of drain seconds per driver incarnation

    def factory():
        drv = tservice.ServiceDriver(cfg, recorder=rec, faults=plan)
        timed.append(service_driver.time_drains(drv))
        return drv

    sup = tservice.Supervisor(
        factory, policy=tservice.RestartPolicy(backoff_base_s=0.01,
                                               backoff_cap_s=0.02),
        recorder=rec)
    torch.cuda.synchronize()
    _build.reset_counts()
    t0 = time.perf_counter()
    verdict = sup.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _build.counts()
    drains = [d for incarnation in timed for d in incarnation]
    check(verdict.ok and verdict.restarts == 1
          and verdict.step == HISTORY_STEPS,
          f"history: supervised run {verdict}")
    nan_steps = sorted(e.data["step"] for e in rec.events("state_health")
                       if e.data.get("nan_pos") or e.data.get("nan_vel"))
    check(bool(nan_steps), "history: no state_health event saw the NaNs")
    named = [b for b in incident.list_bundles(inc_dir)
             if b.get("rule") == "nan_detected"
             and f"step {nan_steps[0]}" in str(b.get("reason", ""))]
    check(len(named) == 1,
          f"history: {len(named)} nan_detected bundles name step "
          f"{nan_steps[0]}")
    restores = [e for e in rec.events("restore")
                if e.data.get("what") == "state"]
    check(bool(restores) and restores[-1].data["step"] < nan_steps[0],
          "history: the restart did not restore a pre-corruption snapshot")
    reader = StoreReader(str(store_dir), verify=True)
    check(reader.counts() == rec.counts(),
          "history: the store's counts are not the recorder's")
    keys = [(r["host"], r["pid"], r["seq"]) for r in reader.events()]
    check(len(keys) == len(set(keys)), "history: the store holds a row twice")
    check(launches.get("overlay_scatter_planar", 0) > 0,
          f"history: kernel 2 was not launched in the leg ({launches})")
    findings, _ = storecheck.check_store(str(store_dir))
    check(not findings, "history: storecheck: "
          + "; ".join(f"{f.rule} {f.message}" for f in findings))
    return {
        "restarts": verdict.restarts, "nan_step": nan_steps[0],
        "bundles": len(incident.list_bundles(inc_dir)),
        "drains": len(drains), "drain_s": sum(drains),
        "drain_max_s": max(drains), "run_s": run_s,
        "drain_share": sum(drains) / run_s,
        "store_rows": len(keys), "launches": launches,
        "n_local": DRIVER_SUP_N_LOCAL, "steps": HISTORY_STEPS,
    }


# the count-equality check's width (its CPU half runs the same loop)
COUNT_N = 4096
# timed at the card's width too (tools.attribution.WIDE_N_LOCAL): the two
# highest shares of the attribution snapshot, where a count too high
# reads above the roof (at the registry's width every share is ~1e-4)
WIDE_ROOF_PROGRAMS = ("canonical_planar_vranks", "pipelined_macro_step")


def record_registry(torch, work, sharded_records):
    """Record the one-device registry programs here on the card and
    write the whole registry's records (the sharded ones from the
    multi-rank world) to ``work``, where :func:`start_gate`'s progcheck
    and shardcheck read them. Returns ``(records, path)``."""
    from mpi_grid_redistribute_tpu_torch.analysis import progcheck

    t0 = time.perf_counter()
    recorded = dict(sharded_records)
    recorded.update(progcheck.vrank_entries(progcheck.default_programs(),
                                            torch.device("cuda")))
    cache = work / "registry.pkl"
    progcheck.write_records_cache(str(cache), torch.device("cuda"),
                                  recorded)
    log(f"registry: {len(recorded)} programs' records on the card "
        f"({time.perf_counter() - t0:.1f} s for the one-device ones)")
    return recorded, cache


def start_gate(cache):
    """Start ``tools.check_all --lint`` with the card in the background,
    at niceness 10, over the records in ``cache``: its rows are processes
    of their own, time nothing, and run on the cores this process leaves
    idle while its later phases keep the card busy. The gate is killed
    if this script exits before :func:`finish_gate`."""
    import atexit

    from mpi_grid_redistribute_tpu_torch.analysis import progcheck

    env = dict(os.environ, **{progcheck.RECORDS_CACHE_ENV: str(cache)})
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpi_grid_redistribute_tpu_torch.tools."
         "check_all", "--lint"], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    # its rows are its children, started later: they inherit this
    os.setpriority(os.PRIO_PROCESS, proc.pid, 10)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return {"proc": proc, "t0": time.perf_counter()}


def finish_gate(gate):
    """Wait for the gate: every row of ``tools.check_all --lint`` clean.
    Returns ``{"rows": {tool: seconds}, "dcn": (hier, flat), "seconds",
    "waited"}``: its wall seconds and those this process waited for it."""
    from mpi_grid_redistribute_tpu_torch.tools import check_all

    t0 = time.perf_counter()
    out, err = gate["proc"].communicate(timeout=600)
    rc = gate["proc"].returncode
    check(rc == 0, f"check_all --lint: exit {rc}: {out[-3000:]} "
                   f"{err[-2000:]}")
    rows = dict(re.findall(r"check: (\S+) clean \(exit 0, ([0-9.]+)s\)",
                           out))
    check(sorted(rows) == sorted(a.name for a in check_all.ANALYZERS),
          f"check_all --lint: clean rows {sorted(rows)}")
    dcn = re.search(r"DCN ratio (\d+) / (\d+) B", out)
    check(dcn is not None, "check_all --lint: shardcheck printed no DCN "
          "ratio")
    dcn = (int(dcn.group(1)), int(dcn.group(2)))
    res = {"rows": {k: float(v) for k, v in rows.items()}, "dcn": dcn,
           "seconds": time.perf_counter() - gate["t0"],
           "waited": time.perf_counter() - t0}
    log("check_all --lint on the card (beside config 5 to the tools "
        f"phase): every row clean in {res['seconds']:.1f} s, "
        f"{res['waited']:.1f} s of it waited for at the end (seconds a "
        "row: " + ", ".join(f"{k} {v}" for k, v in rows.items())
        + f"); DCN ratio {dcn[0]} / {dcn[1]} B = "
        f"{dcn[0] / dcn[1] * 100.0:.2f}%")
    return res


def tools_phase(torch, work, recorded, gate):
    """The counted rooflines and this slice's tools on the card: (a)
    every one-device registered program counted on the card and on the
    CPU, the same bytes, flops and kernel counts both ways, and the
    stage table's planar loop (``bench/knockout_stages``, the whole
    ``make_migrate_loop(engine="planar")``) too; (b) the programs timed,
    one ``roofline`` event a row, the gauge read back through
    ``metrics.from_journal``, and :data:`WIDE_ROOF_PROGRAMS` counted and
    timed at 2^20 rows a vrank; every ``achieved_fraction`` in (0,
    1.05]; (c) ``tools.trace_export
    --demo`` and ``examples.drift_demo --steps 3`` on the card; (a')
    progcheck's J001-J004 and shardcheck's S004 in this process over
    ``recorded``, the registry's records on the card (the sharded
    programs recorded in the multi-rank world), which ``gate`` (
    :func:`finish_gate`: ``tools.check_all --lint`` with the card, every
    row clean) judged too, the same DCN ratio both ways."""
    import contextlib
    import io

    from mpi_grid_redistribute_tpu_torch.analysis import (
        baseline, progcheck, shardcheck,
    )
    from mpi_grid_redistribute_tpu_torch.bench import knockout_stages
    from mpi_grid_redistribute_tpu_torch.examples import drift_demo
    from mpi_grid_redistribute_tpu_torch.telemetry import metrics, roofline
    from mpi_grid_redistribute_tpu_torch.telemetry.recorder import (
        StepRecorder,
    )
    from mpi_grid_redistribute_tpu_torch.tools import (
        attribution,
        trace_export,
    )

    t_phase = time.perf_counter()
    laps = {}

    def lap(name, t0):
        laps[name] = time.perf_counter() - t0

    registry = progcheck.default_programs()

    # (a) one count whatever implements the kernels; the card's count is
    # progcheck's recorded run of each program
    t0 = time.perf_counter()
    programs = {k: v for k, v in registry.items() if v.topology == "vranks"}
    card = {k: recorded[k]["records"]["registry"]["cost"] for k in programs}
    cpu = progcheck.program_costs(programs, device="cpu")
    ko_cost = {}
    for dev in ("cuda", "cpu"):
        ko_cost[dev] = roofline.count_cost(
            knockout_stages.make_loop(GRID, COUNT_N, 2, "planar", dev),
            knockout_stages.make_state(GRID, COUNT_N, dev))
    card["knockout_planar_step"] = ko_cost["cuda"]
    cpu["knockout_planar_step"] = ko_cost["cpu"]
    keys = ("bytes_accessed", "flops", "kernels", "collective_bytes")
    for name in card:
        check(all(card[name][k] == cpu[name][k] for k in keys),
              f"roofline: {name} counts differently on the card "
              f"({[card[name][k] for k in keys]}) and the CPU "
              f"({[cpu[name][k] for k in keys]})")
    for name in ("migrate_sparse_vranks", "pipelined_macro_step",
                 "knockout_planar_step"):
        check(card[name]["kernels"], f"roofline: {name} counted no kernel")
    lap("count", t0)

    # (a') J001 (every rank of the 8-rank world), J002 (host reads
    # counted, sync debug mode "error"), J003, J004 and S004 against the
    # committed baseline, over the card's records of the registry
    t0 = time.perf_counter()
    doc = baseline.load_progprofile_doc()
    findings, profiles = progcheck.run_progcheck(registry,
                                                 recorded=recorded)
    findings += progcheck.gate_profiles(profiles, doc, check_stale=True)
    wires = shardcheck.wire_profiles(recorded, registry)
    findings += shardcheck.gate_wires(wires, doc, check_stale=True)
    check(not findings, "progcheck/shardcheck on the card: " + "; ".join(
        f.render() for f in findings))
    resident = sorted(n for n, p in programs.items() if p.resident)
    check(len(resident) == 3 and all(
        recorded[n]["host_reads"] == {} and recorded[n]["sync_error"] is None
        for n in resident), "J002: a resident program synchronized")
    lap("progcheck", t0)

    # (b) the rooflines, measured: every program at the registry's width
    # (one event a row, the gauge), the widest shares at the card's width
    t0 = time.perf_counter()
    measured = roofline.measure_programs(programs, device="cuda", s2=2,
                                         reps=2)
    rec = StepRecorder()
    report = roofline.roofline_report(programs, measured, rec,
                                      costs={k: card[k] for k in programs})
    check(rec.counts().get("roofline") == len(programs),
          f"roofline: {rec.counts().get('roofline')} events for "
          f"{len(programs)} rows")
    text = metrics.from_journal(rec).render_openmetrics()
    for name in programs:
        check(f'roofline_achieved_fraction{{program="{name}"' in text,
              f"roofline: no gauge for {name}")
    lap("roofline", t0)
    t0 = time.perf_counter()
    wide_programs = {k: programs[k] for k in WIDE_ROOF_PROGRAMS}
    wide_costs = {}
    wide_measured = roofline.measure_programs(
        wide_programs, device="cuda", n_local=attribution.WIDE_N_LOCAL,
        s2=2, reps=2, costs=wide_costs)
    wide = roofline.roofline_report(wide_programs, wide_measured, None,
                                    costs=wide_costs)
    limit = roofline.ACHIEVED_FRACTION_MAX
    for name, row in [*report.items(), *wide.items()]:
        frac = row["achieved_fraction"]
        check(frac is not None and 0 < frac <= limit,
              f"roofline: {name} achieved_fraction {frac} outside (0, "
              f"{limit}]")
    lap("roofline_wide", t0)

    # (c) the tools on the card
    t0 = time.perf_counter()
    out = io.StringIO()
    trace = work / "demo.trace.json"
    with contextlib.redirect_stdout(out):
        check(trace_export.main(["--demo", "--steps", "4", "--out",
                                 str(trace)]) == 0, "trace_export --demo")
        drift_demo.main(["--steps", "3"])
    said = out.getvalue()
    check(bool(json.loads(trace.read_text())["traceEvents"]),
          "trace_export --demo wrote no events")
    for line in ("every particle is inside its owner's subdomain",
                 "no particles lost"):
        check(line in said, f"drift_demo did not print {line!r}")
    lap("tools", t0)

    t0 = time.perf_counter()
    gate = finish_gate(gate)
    dcn = gate["dcn"]
    check(shardcheck.dcn_ratio(wires) == dcn,
          f"S004: DCN ratio {shardcheck.dcn_ratio(wires)} in-process, "
          f"{dcn} in check_all")
    lap("check_all", t0)

    log("tools: " + ", ".join(f"{k} {v:.1f}" for k, v in laps.items())
        + f"; {time.perf_counter() - t_phase:.1f} s")
    keep = ("flops", "bytes_accessed", "t_predicted_s", "bound_by",
            "measured_s", "achieved_fraction")
    return {
        "roofline": {name: {k: report[name][k] for k in keep}
                     for name in report},
        "roofline_wide": {name: {k: wide[name][k] for k in keep}
                          for name in wide},
        "counted_equal_on_cpu": sorted(card),
        "kernels_counted": {name: card[name]["kernels"] for name in card},
        "peak_live_bytes": {n: profiles[n]["peak_live_bytes"]
                            for n in sorted(profiles)},
        "check_all": {"seconds": gate["seconds"],
                      "waited_at_the_end": gate["waited"],
                      "seconds_a_row": gate["rows"]},
        "dcn_ratio": list(dcn),
        "seconds": laps,
    }


HIER_DCN = (2, 1, 1)  # two pods of 4 vranks
HIER_CALLS = 6


def hierarchical_phase(torch, pt, config1_oracle, profiling, headline):
    """The hierarchical two-level engine on one card: the canonical
    phase's headline input (2^20 rows a vrank, 8 vranks) with
    ``dcn_shape=HIER_DCN`` and ``engine="hierarchical"``, byte-equal to
    the port's NumPy oracle and to the planar call's output
    (``headline``); ms per call (median of :data:`HIER_CALLS`, CUDA
    events), device busy a call (a device-only profile of 2 and 6 calls,
    differenced) and host syncs a call; then one growth of the cross
    block from ``cross_cap=1`` at config 1's width, byte-equal to the
    oracle after the re-run."""
    V = int(np.prod(GRID))
    N = V * N_LOCAL
    kw = dict(lo=0.0, hi=1.0, periodic=True, grid=GRID,
              capacity_factor=config1_oracle.CAPACITY_FACTOR)
    host = config1_oracle.inputs(N)
    args = tuple(torch.from_numpy(a).cuda() for a in host)
    rd = pt.GridRedistribute(engine="hierarchical", dcn_shape=HIER_DCN,
                             **kw)
    for _ in range(3):  # calibration: the synchronous checks and growth
        out = rd.redistribute(*args)
    engine = rd._last_wire["engine"]
    check(engine == "hierarchical" and rd.n_pods == 2,
          f"hierarchical: ran {engine!r} over {rd.n_pods} pods")
    times = []
    for _ in range(HIER_CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = rd.redistribute(*args)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    call_ms = sorted(a.elapsed_time(b) for a, b in times)
    calls = 4
    _, syncs = synced_run(
        torch, lambda: [rd.redistribute(*args) for _ in range(calls)])
    _, busy, _ = profile_steps(
        torch, lambda S: (lambda: [rd.redistribute(*args)
                                   for _ in range(S)]), None, "hier")
    out = rd.redistribute(*args)
    rd.flush_overflow_checks()
    planar_rd, planar_out = headline
    for name, a, b in (("positions", out.positions, planar_out.positions),
                       ("count", out.count, planar_out.count),
                       *((f"field {i}", a, b) for i, (a, b) in enumerate(
                           zip(out.fields, planar_out.fields)))):
        check(torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
              f"hierarchical: {name} differs from the planar call")
    np_rd = pt.GridRedistribute(backend="numpy", **kw)
    np_rd.capacity, np_rd.out_capacity = rd.capacity, rd.out_capacity
    bad = config1_oracle.mismatches(out, np_rd.redistribute(*host))
    check(not bad, f"hierarchical: {bad} differ from the oracle at {N} rows")
    check(int(out.stats.dropped_send.sum()) == 0
          and int(out.stats.dropped_recv.sum()) == 0,
          "hierarchical: rows dropped")
    med = statistics.median(call_ms)
    log(f"hierarchical vranks: {med:.4f} ms/call (median of {HIER_CALLS}, "
        f"min {call_ms[0]:.4f}) at {N} rows (2^20 per vrank), dcn_shape "
        f"{HIER_DCN} (2 pods of 4 vranks), capacity "
        f"{rd._capacities(N_LOCAL)[0]}, mover_cap {rd._mover_cap}, "
        f"cross_cap {rd._cross_cap}, intra fallback "
        f"{int(out.stats.fallback[0])}; device busy {busy:.4f} ms/call, "
        f"host syncs {syncs / calls:g}/call (the intra guard); byte-equal "
        f"to the planar call and the oracle (the planar canonical call's "
        f"min is in the canonical line above)")
    del args, out, host
    # one growth of the cross block from cross_cap=1, at config 1's width
    n1 = 1 << 20
    small = config1_oracle.inputs(n1)
    rd1 = pt.GridRedistribute(engine="hierarchical", dcn_shape=HIER_DCN,
                              cross_cap=1, **kw)
    res = rd1.redistribute(*small)
    rd1.flush_overflow_checks()
    check(rd1._cross_cap > 1 and rd1._blocking_fetches >= 2,
          f"hierarchical: cross_cap {rd1._cross_cap} after "
          f"{rd1._blocking_fetches} attempts")
    bad = config1_oracle.mismatches(
        res, pt.GridRedistribute(backend="numpy", **kw).redistribute(*small))
    check(not bad, f"hierarchical (cross_cap grown): {bad} differ from the "
                   f"oracle")
    log(f"hierarchical cross_cap growth: 1 -> {rd1._cross_cap} in "
        f"{rd1._blocking_fetches} attempts at {n1} rows, byte-equal to the "
        f"oracle")
    return {"ms_per_call_median": med, "ms_per_call_min": call_ms[0],
            "device_busy_ms_per_call": busy,
            "host_syncs_per_call": syncs / calls, "rows": N,
            "dcn_shape": HIER_DCN, "cross_cap": rd._cross_cap,
            "mover_cap": rd._mover_cap,
            "cross_cap_grown_from_1": rd1._cross_cap}


HALO_SMALL = 1 << 18  # config 6's own size, card against CPU
HALO_ORACLE = 1 << 16  # the public call against the ghost oracle
HALO_CALLS = 6


def _halo_bits(torch, x):
    return x.cpu().contiguous().view(torch.uint8)


def _shell_check(torch, pt, ghost, gcount, w, label):
    """Every ghost of receiver r lies in its subdomain widened by ``w``
    and not in the subdomain (all in float32, the bounds built as the
    engine builds its thresholds, ``lo + coord * cell_w`` then ``+
    cell_w``), and every column past the count is zero. A ghost selected
    at the sender's rounded threshold can lie below the receiver's
    rounded ``lo - w`` after a wrap's shift; the widened test allows one
    ulp of the extent for that and counts the ghosts that needed it."""
    grid = pt.ProcessGrid(GRID)
    V, G = ghost.shape[0], ghost.shape[2]
    coord = torch.tensor([grid.cell_of_rank(r) for r in range(V)],
                         dtype=torch.float32, device=ghost.device)[:, :, None]
    cw = torch.tensor(grid.cell_widths(pt.Domain(0.0, 1.0)),
                      dtype=torch.float32, device=ghost.device)[None, :, None]
    lo = coord * cw
    hi = lo + cw
    wf = torch.tensor(w, dtype=torch.float32, device=ghost.device)
    ulp = 2.0 ** -23
    valid = (torch.arange(G, device=ghost.device)[None, :]
             < gcount[:, None])
    strict = ((ghost >= lo - wf) & (ghost < hi + wf)).all(dim=1)
    wide = ((ghost >= lo - wf - ulp) & (ghost < hi + wf + ulp)).all(dim=1)
    own = ((ghost >= lo) & (ghost < hi)).all(dim=1)
    bad = valid & ~(wide & ~own)
    check(not bool(bad.any()),
          f"{label}: {int(bad.sum())} ghosts outside their receiver's shell")
    check(not bool(((ghost.view(torch.int32) != 0).any(dim=1)
                    & ~valid).any()),
          f"{label}: a ghost column past the count is not zero")
    return int((valid & wide & ~strict).sum())


def halo_phase(torch, pt, config6_halo, config1_oracle, oracle, profiling,
               profile_dir, headline):
    """Config 6 on the card: both vrank engines against each other and
    the CPU run, then timed at the headline width, then the public
    ``halo()`` on ``headline``, the canonical phase's ``(rd, out)`` of
    the headline ``redistribute()``, and against the ghost oracle."""
    V = int(np.prod(GRID))

    # ---- config 6 at its own size: card == CPU, planar == row-major
    t0 = time.perf_counter()
    pos_v, count, w, pc, gc = config6_halo.setup(HALO_SMALL)
    fns = config6_halo.engines(w, pc, gc)
    out = {}
    for dev in ("cuda", "cpu"):
        states, c = config6_halo.device_states(pos_v, count, dev)
        for engine in ("planar", "rowmajor"):
            out[dev, engine] = fns[engine](states[engine], c)
    check(out["cuda", "planar"][0].is_cuda, "halo: did not run on the card")
    for engine in ("planar", "rowmajor"):
        for x, y in zip(out["cuda", engine], out["cpu", engine]):
            check(torch.equal(_halo_bits(torch, x), _halo_bits(torch, y)),
                  f"halo ({engine}): card differs from the CPU run at "
                  f"{HALO_SMALL} rows a vrank")
    (pg, pcnt, pov), (rg, rcnt, rov) = out["cuda", "planar"], out[
        "cuda", "rowmajor"]
    check(torch.equal(_halo_bits(torch, pg.transpose(1, 2)),
                      _halo_bits(torch, rg))
          and torch.equal(pcnt, rcnt) and torch.equal(pov, rov),
          "halo: planar engine differs from row-major on the card")
    check(int(pov.sum()) == 0, "halo: overflow at config 6's own size")
    small_ghosts = int(pcnt.sum())
    log(f"halo, config 6 at {HALO_SMALL} rows a vrank (w {w}, capacities "
        f"{pc}/{gc}): planar == row-major on the card and card == CPU for "
        f"both engines (ghost bits, {small_ghosts} ghosts, counts, "
        f"overflow 0); {time.perf_counter() - t0:.1f} s")
    del out, pg, rg

    # ---- the headline width: 2^20 rows a vrank, both engines timed
    case = config6_halo.prepare(N_LOCAL, "cuda")
    res = config6_halo.time_case(case)
    check(res["overflow"] == 0, f"halo: overflow {res['overflow']} at the "
          f"headline width")
    fns, states, count_t, w = case.fns, case.states, case.count, case.w
    syncs, shell_slack = {}, None
    for engine in ("planar", "rowmajor"):
        fn, st = fns[engine], states[engine]
        o, syncs[engine] = synced_run(torch, lambda: fn(st, count_t))
        check(syncs[engine] == 0,
              f"halo ({engine}): {syncs[engine]} host syncs an exchange")
        if engine == "planar":
            check(int(o[1].sum()) == res["ghosts_per_exchange"],
                  "halo: ghost count differs from the timed run")
            shell_slack = _shell_check(torch, pt, o[0], o[1], w,
                                       "halo (planar)")
        del o
    frac = res["ghost_frac_measured"]
    check(abs(frac - res["ghost_frac_expected_uniform"]) < 0.01,
          f"halo: ghost fraction {frac} far from the uniform expectation")
    log(f"halo, config 6 at {N_LOCAL} rows a vrank (capacities "
        f"{res['pass_capacity']}/{res['ghost_capacity']}): planar "
        f"{res['value']:.4f} ms/exchange (min of k={res['samples']}, median "
        f"{res['median_ms_per_exchange']:.4f}), {res['ns_per_ghost']:.4f} "
        f"ns/ghost; row-major {res['rowmajor_ms_per_exchange']:.4f} "
        f"(median {res['rowmajor_median_ms_per_exchange']:.4f}), "
        f"{res['rowmajor_ns_per_ghost']:.4f} ns/ghost; "
        f"{res['ghosts_per_exchange']} ghosts, fraction {frac:.6f} against "
        f"{res['ghost_frac_expected_uniform']:.6f} uniform; overflow 0; "
        f"host syncs an exchange {syncs}; shell check holds "
        f"({shell_slack} ghosts within one ulp of a widened face)")
    busy = {}
    if profile_dir:
        for engine in ("planar", "rowmajor"):
            make_run = config6_halo.make_loop(engine, fns[engine],
                                              states[engine], count_t)
            per = res["value" if engine == "planar"
                      else "rowmajor_ms_per_exchange"] / 1e3
            busy[engine] = write_profile(torch, make_run, profile_dir, per,
                                         f"halo_{engine}")
    del states, case

    # ---- the public call after the headline redistribute
    rd, red = headline
    h = rd.halo(red.positions, *red.fields, width=w, count=red.count)
    times = []
    for _ in range(HALO_CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        h = rd.halo(red.positions, *red.fields, width=w, count=red.count)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    call_ms = sorted(a.elapsed_time(b) for a, b in times)
    _, call_syncs = synced_run(torch, lambda: rd.halo(
        red.positions, *red.fields, width=w, count=red.count))
    check(int(h.overflow.sum()) == 0, "halo(): overflow after growth")
    n_pad = red.positions.shape[0] // V
    log(f"halo(): {call_ms[0]:.4f} ms/call (min of k={HALO_CALLS}, median "
        f"{statistics.median(call_ms):.4f}) on the headline redistribute's "
        f"output ({n_pad} padded rows a vrank, {int(red.count.sum())} live, "
        f"pos + 2 fields), width {w}, capacities "
        f"{rd._halo_caps or 'derived'}; {int(h.ghost_count.sum())} ghosts; "
        f"host syncs a call {call_syncs} (the 'grow' policy's one overflow "
        f"read)")
    if profile_dir:
        def make_calls(S):
            return lambda: [rd.halo(red.positions, *red.fields, width=w,
                                    count=red.count) for _ in range(S)]

        ops, call_busy, _ = profile_steps(torch, make_calls, profile_dir,
                                          "halo_call")
        busy["call"] = call_busy
        log(f"halo() profile: {ops:.1f} device operations/call, device busy "
            f"{call_busy:.4f} ms/call of {call_ms[0]:.4f} (idle "
            f"{1 - call_busy / call_ms[0]:.2%})")
    del h, red, rd

    # ---- the public call's ghost set against the oracle
    t0 = time.perf_counter()
    args = tuple(torch.from_numpy(a).cuda()
                 for a in config1_oracle.inputs(V * HALO_ORACLE))
    rd = pt.GridRedistribute(lo=0.0, hi=1.0, periodic=True, grid=GRID,
                             capacity_factor=config1_oracle.CAPACITY_FACTOR)
    red = rd.redistribute(*args)
    h = rd.halo(red.positions, width=w, count=red.count)
    oc = red.positions.shape[0] // V
    pos_np, cnt = red.positions.cpu().numpy(), red.count.cpu().numpy()
    shards = [pos_np[r * oc: r * oc + cnt[r]] for r in range(V)]
    expected = oracle.brute_force_ghosts(pt.Domain(0.0, 1.0, periodic=True),
                                         pt.ProcessGrid(GRID), shards, w)
    G = h.ghost_positions.shape[0] // V
    gpos, gcnt = h.ghost_positions.cpu().numpy(), h.ghost_count.cpu().numpy()

    def rows(a):
        u = np.ascontiguousarray(a).view(np.uint32)
        return u[np.lexsort(u.T[::-1])]

    for r in range(V):
        check(gcnt[r] == len(expected[r]) and np.array_equal(
            rows(gpos[r * G: r * G + gcnt[r]]), rows(expected[r])),
            f"halo(): rank {r}'s ghost set differs from the oracle at "
            f"{HALO_ORACLE} rows a vrank")
    log(f"halo(): ghost sets equal the vectorised brute_force_ghosts at "
        f"{HALO_ORACLE} rows a vrank ({int(gcnt.sum())} ghosts, bits); "
        f"{time.perf_counter() - t0:.1f} s with the oracle")
    return dict(
        res, small_bit_equal=True, host_syncs_per_exchange=syncs,
        shell_ulp_ghosts=shell_slack, call_ms=call_ms[0],
        median_call_ms=statistics.median(call_ms),
        host_syncs_per_call=call_syncs,
        device_busy_ms=busy or None, oracle_set_equal=True,
    )


# ---- the load-balanced decomposition: config 2 and config 3 --------------

# config 2's steady state at the BASELINE size (BENCH_SCALE=32)
C2_TOTAL = 32 * (1 << 21)
C2_GRID = (4, 4, 4)
# config 2's placement: 64 vranks of 2^17 rows (the bench's scale 1; its
# cap is 2^20 at scale 8)
C2_PLACE_N_BASE = 1 << 17
# config 3: (8, 8, 1) as 64 vranks at the bench's default 2^17 slots
C3_N_LOCAL = 1 << 17
C3_GRID = (8, 8, 1)
# the deposits under an assignment: config 2's layout at 2^20 rows
C2_DEPOSIT_N_LOCAL = 1 << 16
C2_DEPOSIT_MESH = (64, 64, 64)


def fast_share(stats):
    fp = stats.fast_path
    return None if fp is None else float(fp[:, 0].float().mean())


def config2_steady_phase(torch, nbody, migrate, _build, profiling,
                         config2_clustered, profile_dir, rows):
    """Config 2's steady state at 67,108,864 rows, the clustered and the
    uniform workload, each LPT-assigned over the 4x4x4 cells onto 8
    vranks, through ``make_migrate_loop`` with the default engine: timed,
    a counted run (kernel 2 once a step, kernel 1 never: its key is the
    canonical vrank's), one guard read a step, conservation, zero drops,
    every live row on the vrank its cell is assigned to, and bit equality
    with the plain-version run and with ``engine="planar"``. ``rows`` is
    the host data (``steady_rows``), drawn while the kernels built."""
    t1 = time.perf_counter()
    setup = config2_clustered.steady_setup(C2_TOTAL, rows=rows)
    total = setup["total"]
    log(f"config2 steady state: {total} rows, binning "
        f"{time.perf_counter() - t1:.1f} s; cell "
        f"imbalance {setup['imbalance']:.4f}, balanced-bin "
        f"imbalance {setup['balanced_bin_imbalance']:.4f}, {setup['n_slab']} "
        f"slots a vrank, slot waste {setup['waste']:.4f}, capacity "
        f"{setup['capacity']}, local_budget {setup['budget']}")
    res = {}
    for name in config2_clustered.WORKLOADS:
        cfg, vgrid, args = config2_clustered.steady_workload(setup, name)
        label = f"config2 {name}"

        def make_run(S, plain=False, c=cfg, args=args, vgrid=vgrid):
            loop = nbody.make_migrate_loop(c, S, vgrid=vgrid, plain=plain)
            return lambda: loop(*args)

        detail, _ = profiling.cuda_time_per_step_samples(
            make_run, s1=4, s2=12, reps=2
        )
        per_step = detail["min"]
        log(f"{label}: {per_step * 1e3:.4f} ms/step (min of "
            f"k={detail['k']}, median {detail['median'] * 1e3:.4f}, spread "
            f"{detail['spread'] * 100:.2f}%), {total / per_step:.6g} "
            f"particles/s")
        out, launches, syncs, guard = counted_run(torch, migrate, _build,
                                                  make_run)
        log(f"{label}: launches over {COUNTED_STEPS} steps: {launches}; "
            f"host syncs per step {syncs:g} (sparse-guard reads {guard:g})")
        check_launches(launches, ("overlay_scatter_planar",), label)
        check(syncs == 1 and guard == 1,
              f"{label}: {syncs:g} host syncs, {guard:g} guard reads a step")
        pos_f, _, alive_f, stats = out
        check_state(torch, label, pos_f, alive_f, stats, total,
                    grid=C2_GRID, n_local=cfg.n_local,
                    assignment=cfg.assignment)
        share = fast_share(stats)
        sent = stats.sent.sum(dim=1).tolist()
        log(f"{label}: migrants per step {sent} ({np.mean(sent) / total:.4%}"
            f"), backlog {int(stats.backlog.sum())}, fast-path share "
            f"{share:.4f}; every live row on its assigned vrank")
        ref = make_run(COUNTED_STEPS, plain=True)()
        check_same_run(torch, label, out, ref, "the plain-version run")
        del ref
        planar = make_run(COUNTED_STEPS,
                          c=dataclasses.replace(cfg, engine="planar"))()
        check_same_run(torch, label, out, planar, "engine='planar'")
        del planar
        log(f"{label}: bit-equal to the plain-version run and to "
            f"engine='planar'")
        busy = None
        if profile_dir and name == "imbalanced":
            busy = write_profile(torch, make_run, profile_dir, per_step,
                                 "config2_imbalanced")
        res[name] = {
            "ms_per_step": per_step * 1e3,
            "median_ms_per_step": detail["median"] * 1e3,
            "spread": detail["spread"],
            "particles_per_s": total / per_step,
            "host_syncs_per_step": syncs,
            "fast_path_share": share,
            "launches": launches,
            "device_busy_ms_per_step": busy,
        }
        del out, stats, pos_f, alive_f, args, make_run
        torch.cuda.empty_cache()
    ratio = res["uniform"]["ms_per_step"] / res["imbalanced"]["ms_per_step"]
    log(f"config2 steady state: imbalanced "
        f"{res['imbalanced']['ms_per_step']:.4f} ms/step, uniform "
        f"{res['uniform']['ms_per_step']:.4f} ms/step at {total} rows: "
        f"imbalanced/uniform pps {ratio:.4f}")
    res.update(
        n_total=total, imbalanced_over_uniform=ratio,
        ownership_imbalance=setup["imbalance"],
        balanced_bin_imbalance=setup["balanced_bin_imbalance"],
        slot_waste_factor=setup["waste"], n_slab=setup["n_slab"],
    )
    return res


def config2_placement_phase(torch, nbody, migrate, _build,
                            config2_clustered, stats_lib):
    """Config 2's placement: 64 vranks, clustered rows not on their owners,
    ``dt = 0`` loops of 8 steps until a loop's last step sends nothing:
    rows placed, rounds, pps, nothing dropped, every live row on its
    owner; a counted 6-step loop (kernels 1 and 2 once a step) bit-equal
    to its plain-version run."""
    label = "config2 placement"
    cfg, vgrid, start = config2_clustered.placement_setup(C2_PLACE_N_BASE)
    live = int(start[2].sum())

    def make_run(S, plain=False):
        loop = nbody.make_migrate_loop(cfg, S, vgrid=vgrid, plain=plain)
        return lambda: loop(*start)

    out, launches, syncs, guard = counted_run(torch, migrate, _build,
                                              make_run)
    check_launches(launches, MIGRATE_KERNELS, label)
    ref = make_run(COUNTED_STEPS, plain=True)()
    check_same_run(torch, label, out, ref, "the plain-version run")
    check(int(out[3].dropped_recv.sum()) == 0, f"{label}: arrivals dropped")
    dense = int((out[3].fast_path[:, 0] == 0).sum())
    del out, ref
    log(f"{label}: launches over {COUNTED_STEPS} steps: {launches}; host "
        f"syncs per step {syncs:g}; {dense} of {COUNTED_STEPS} steps dense;"
        f" bit-equal to the plain-version run")
    last, placed, seconds, rounds, (p, _, a) = \
        config2_clustered.placement(C2_PLACE_N_BASE)
    summary = stats_lib.summarize_migrate(last)
    check(summary["dropped_recv"] == 0, f"{label}: arrivals dropped")
    check(int(a.sum()) == live, f"{label}: alive count not conserved")
    check(int(last.backlog[-1].sum()) == 0,
          f"{label}: backlog left after {rounds} rounds")
    check_owned(torch, label, p, a, grid=C2_GRID, n_local=C2_PLACE_N_BASE)
    log(f"{label}: {placed} rows placed in {rounds} rounds "
        f"({seconds:.3f} s, {placed / seconds:.6g} rows/s) at 64 x "
        f"{C2_PLACE_N_BASE} slots, {live} live rows, placement_dropped_recv "
        f"{summary['dropped_recv']}, population imbalance "
        f"{summary['population_imbalance']:.4f}; every live row on its "
        f"owner")
    return {"rows_placed": placed, "rounds": rounds, "seconds": seconds,
            "placement_pps": placed / seconds,
            "placement_dropped_recv": summary["dropped_recv"],
            "n_base": C2_PLACE_N_BASE, "launches": launches,
            "host_syncs_per_step": syncs}


def config3_phase(torch, nbody, migrate, binning, _build, profiling,
                  config3_slab, profile_dir):
    """Config 3: (8, 8, 1) as 64 vranks, 2^17 slots a vrank at 90% fill,
    through ``make_migrate_loop`` with the default engine: timed, a counted
    run (kernels 1 and 2 once a step), the fast-path share, conservation,
    zero drops, ownership, bit equality with the plain-version run."""
    label = "config3"
    cfg, vgrid, (pos, vel, alive) = config3_slab.build(n_local=C3_N_LOCAL)
    args = tuple(torch.from_numpy(a).cuda()
                 for a in (nbody.rows_to_planar(pos, 1),
                           nbody.rows_to_planar(vel, 1), alive))
    total = int(alive.sum())
    chunk, cap = binning.sparse_select_params(cfg.n_local, cfg.local_budget)
    selectable = binning.sparse_select_feasible(cfg.n_local, vgrid.nranks,
                                                chunk=chunk, cap=cap)

    def make_run(S, plain=False):
        loop = nbody.make_migrate_loop(cfg, S, vgrid=vgrid, plain=plain)
        return lambda: loop(*args)

    detail, _ = profiling.cuda_time_per_step_samples(make_run, s1=4, s2=24,
                                                     reps=2)
    per_step = detail["min"]
    out, launches, syncs, guard = counted_run(torch, migrate, _build,
                                              make_run)
    check_launches(launches, MIGRATE_KERNELS, label)
    want = 1 if selectable else 0
    check(syncs == want and guard == want,
          f"{label}: {syncs:g} host syncs, {guard:g} guard reads a step")
    pos_f, _, alive_f, stats = out
    check_state(torch, label, pos_f, alive_f, stats, total, grid=C3_GRID,
                n_local=cfg.n_local)
    ref = make_run(COUNTED_STEPS, plain=True)()
    check_same_run(torch, label, out, ref, "the plain-version run")
    del ref
    share = fast_share(stats)
    log(f"{label}: {per_step * 1e3:.4f} ms/step (min of k={detail['k']}, "
        f"median {detail['median'] * 1e3:.4f}, spread "
        f"{detail['spread'] * 100:.2f}%), {total / per_step:.6g} "
        f"particles/s, {total} particles on (8, 8, 1) as 64 vranks of "
        f"{cfg.n_local} slots; launches a step "
        f"{ {k: n / COUNTED_STEPS for k, n in launches.items()} }; host "
        f"syncs per step {syncs:g}; sparse selection "
        f"{'feasible' if selectable else 'infeasible (every step dense)'}, "
        f"fast-path share {share:.4f}; bit-equal to the plain-version run")
    busy = None
    if profile_dir:
        busy = write_profile(torch, make_run, profile_dir, per_step,
                             "config3")
    return {"ms_per_step": per_step * 1e3,
            "median_ms_per_step": detail["median"] * 1e3,
            "spread": detail["spread"], "particles_per_s": total / per_step,
            "n_total": total, "host_syncs_per_step": syncs,
            "fast_path_share": share, "launches": launches,
            "device_busy_ms_per_step": busy}


def segment_phase(torch, nbody, migrate, _build, profiling, config5_deposit,
                  inputs, scan_rho, profile_dir, base_busy):
    """The ``"segment"`` deposit on config 5's shape (the loop with the
    scatter-add CIC deposit after every step): timed, kernels 1 and 2 once
    a step and no deposit kernel (the reference's route reaches none), the
    mass equal to the live count, and its largest difference from the
    ``"scan"`` density of the same state."""
    cfg, vgrid, _ = config5_deposit.build(n_local=N_LOCAL, method="segment")
    total = int(inputs[2].sum().item())

    def make_run(S):
        loop = nbody.make_migrate_loop(cfg, S, vgrid=vgrid,
                                       deposit_each_step=True)
        return lambda: loop(*inputs)

    detail, _ = profiling.cuda_time_per_step_samples(make_run, s1=4, s2=20,
                                                     reps=3)
    per_step = detail["min"]
    out, launches, syncs, _ = counted_run(torch, migrate, _build, make_run)
    check_launches(launches, MIGRATE_KERNELS, "config5 segment")
    rho = out[4]
    mass = float(rho.double().sum())
    check(abs(mass - total) <= 1e-5 * total,
          f"config5 segment: rho sums to {mass}, {total} live particles")
    check(bool(torch.isfinite(rho).all()) and tuple(rho.shape) ==
          cfg.deposit_shape, "config5 segment: rho not finite or shaped")
    err = max_abs_err(rho, scan_rho)
    check(bool(torch.allclose(rho, scan_rho, rtol=2e-4, atol=2e-4)),
          f"config5 segment: rho vs scan rho beyond 2e-4 ({err})")
    again = make_run(COUNTED_STEPS)()[4]
    repeat = torch.equal(again.view(torch.int32), rho.view(torch.int32))
    log(f"config5 segment: {per_step * 1e3:.4f} ms/step (min of "
        f"k={detail['k']}, median {detail['median'] * 1e3:.4f}), host syncs "
        f"per step {syncs:g}; mass {mass} for {total} live rows; rho vs the "
        f"scan rho of the same state max abs err {err}; a second run "
        f"{'bit-identical' if repeat else 'differs in the last bits'} "
        f"(index_add_ adds with atomics)")
    busy = None
    if profile_dir:
        ops, busy, _ = profile_steps(torch, make_run, profile_dir,
                                     "config5_segment")
        log(f"config5 segment profile: {ops:.1f} device operations/step, "
            f"device busy {busy:.4f} ms/step of {per_step * 1e3:.4f} (idle "
            f"{1 - busy / (per_step * 1e3):.2%}); deposit "
            f"{busy - base_busy:.4f} ms/step of device time")
    return {"ms_per_step": per_step * 1e3,
            "median_ms_per_step": detail["median"] * 1e3,
            "max_abs_err_vs_scan": err, "host_syncs_per_step": syncs,
            "repeat_bit_identical": repeat,
            "device_busy_ms_per_step": busy}


def assignment_deposit_phase(torch, pt, nbody, binning, _build,
                             config2_clustered):
    """The mxu and scan deposits under an assignment, on config 2's layout
    at 2^20 rows: the loop launches kernel 2 and the method's deposit
    kernel once a step and never kernel 1; the density's mass equals the
    live count and it is within 2e-5 of the density of the same particles
    laid out canonically (2x2x2 vranks by position, deposited by the same
    method: the slab engine for mxu)."""
    setup = config2_clustered.steady_setup(
        config2_clustered.steady_total(C2_DEPOSIT_N_LOCAL)
    )
    cfg, vgrid, args = config2_clustered.steady_workload(setup, "imbalanced")
    res = {}
    for method in ("mxu", "scan"):
        label = f"config2 {method} deposit"
        c = dataclasses.replace(cfg, deposit_shape=C2_DEPOSIT_MESH,
                                deposit_method=method)
        _build.reset_counts()
        out = nbody.make_migrate_loop(c, COUNTED_STEPS, vgrid=vgrid,
                                      deposit_each_step=True)(*args)
        torch.cuda.synchronize()
        launches = _build.counts()
        check_launches(launches, ("overlay_scatter_planar",)
                       + DEPOSIT_KERNELS[method], label)
        rho = out[4]
        live = int(out[2].sum())
        mass = float(rho.double().sum())
        check(abs(mass - live) <= 1e-5 * live,
              f"{label}: rho sums to {mass}, {live} live particles")
        # the same particles on the canonical 2x2x2 vrank slabs
        rows = out[0].reshape(3, -1).T[out[2]]
        vel = out[1].reshape(3, -1).T[out[2]]
        owner = binning.rank_of_position(rows, c.domain, pt.ProcessGrid(
            config2_clustered.SS_VGRID))
        n_slab = -(-int(torch.bincount(owner).max()) // 4096) * 4096
        state = config2_clustered.slab_state(rows, vel, owner, 8, n_slab)
        canon = dataclasses.replace(c, cells=None, assignment=None,
                                    n_local=n_slab)
        ref = nbody.make_migrate_loop(canon, 0, vgrid=vgrid)(*state)[4]
        err = max_abs_err(rho, ref)
        check(bool(torch.allclose(rho, ref, rtol=2e-5, atol=2e-5)),
              f"{label}: rho vs the canonical layout's beyond 2e-5 ({err})")
        log(f"{label}: launches over {COUNTED_STEPS} steps {launches}; mass "
            f"{mass} for {live} live rows; vs the canonical layout's "
            f"density of the same particles max abs err {err}")
        res[method] = {"launches": launches, "max_abs_err_vs_canonical": err}
    return res


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
    from mpi_grid_redistribute_tpu_torch import oracle
    from mpi_grid_redistribute_tpu_torch.bench import (
        common, config1_oracle, config2_clustered, config3_slab,
        config5_deposit, config6_halo, config7_stress, kernel_times,
        knockout_deposit, multirank, service_chunk,
    )
    from mpi_grid_redistribute_tpu_torch.bench import (
        headline as headline_bench,
    )
    from mpi_grid_redistribute_tpu_torch.models import nbody
    from mpi_grid_redistribute_tpu_torch.ops import (
        _build, binning, deposit, dfscan, driftbin, overlay, rowsort,
        scatter, segdep,
    )
    from mpi_grid_redistribute_tpu_torch.parallel import migrate
    from mpi_grid_redistribute_tpu_torch.utils import profiling
    from mpi_grid_redistribute_tpu_torch.utils import stats as stats_lib

    laps = [("start", T_START)]

    def lap(name):
        laps.append((name, time.perf_counter()))

    # the kernels build (one nvcc a source) while this thread reads the
    # card's name; config 2's host data (4 x 0.8 GB, the reference's
    # draws) and the multi-rank world's halo oracle (config 6's ghost
    # sets, float64 on the host) are computed in threads at niceness 10
    # from now on, on the cores the phases leave idle, and awaited where
    # they are used; the recording's first-use imports too
    pool = concurrent.futures.ThreadPoolExecutor(4)
    t0 = time.perf_counter()
    build_future = pool.submit(_build.build_all)
    c2_future = pool.submit(niced, config2_clustered.steady_rows, C2_TOTAL)
    ghosts_future = pool.submit(niced, multirank.halo_oracle,
                                multirank.HALO_N)
    pool.submit(importlib.import_module, "torch._dynamo")

    v, cap, budget = common.drift_sizing(GRID, N_LOCAL, FILL, MIGRATION)
    pos, vel, alive = common.uniform_state(
        GRID, N_LOCAL, FILL, np.random.default_rng(0), vel_scale=v
    )
    # the multi-rank world starts now (niced) and waits for its turn
    world = launch_world((pos, vel, alive), args.profile)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    build_future.result()
    log(f"built {sorted(_build.KERNELS)} in {time.perf_counter() - t0:.1f} s")
    lap("set-up and build")

    log(f"bench sizing: capacity {cap}, local_budget {budget}, "
        f"vel scale {v.tolist()}")
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
    k2 = overlay_phase(torch, overlay, profiling, kernel_times, budget)
    log(f"overlay_scatter_planar: {k2['ms']:.5f} ms (bound "
        f"{k2['bound_ms']:.5f}, plain {k2['plain_ms']:.5f}, index_put_ "
        f"{k2['library_ms']:.5f}) bit-equal at V*P = {8 * budget}")

    k6 = scatter_phase(torch, scatter, profiling, state_np, budget)
    log(f"scatter_rows: {k6['ms']:.5f} ms (bound {k6['bound_ms']:.5f}, "
        f"plain {k6['plain_ms']:.5f}, index_put_ {k6['library_ms']:.5f}) "
        f"bit-equal at V*P = {8 * budget} into [{state_np.shape[1]}, 7]")
    lap("kernels 1-3, 6")

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
    small_width_phase(torch, pt, nbody)
    lap("loops")

    # ---- the multi-rank paths: NCCL at world size 1, then one gloo world
    # of 8 processes on this card, held against the 8-vrank run above
    ranks, registry = multirank_phase(torch, pt, config1_oracle, world,
                                      planar_out, ghosts_future, smi,
                                      args.profile)
    del world
    (HERE / "build").mkdir(exist_ok=True)
    gate_dir = tempfile.TemporaryDirectory(dir=HERE / "build")
    recorded, records_file = record_registry(torch, Path(gate_dir.name),
                                             registry)
    del planar_out
    lap("multi-rank")

    # ---- config 5: the deposit kernels, then the fused loop
    cfg5, vgrid5, state5 = config5_deposit.build(n_local=N_LOCAL)
    check(all(np.array_equal(a, b) for a, b in zip(state5, (pos, vel, alive)))
          and (cfg5.capacity, cfg5.local_budget) == (cap, budget),
          "config 5 does not start from the bench state")
    k5_rows = dfscan_phase(torch, dfscan, profiling)
    log(f"tile_df_cumsum_rows: {k5_rows['ms']:.5f} ms (bound "
        f"{k5_rows['bound_ms']:.5f}, plain {k5_rows['plain_ms']:.5f}) "
        f"bit-equal at [262144, 256]")
    k_sort, k5 = cic_rows_phase(torch, dfscan, rowsort, profiling)
    # kernel 5's entry in the kernels line is its fused route, which the
    # scan deposit launches; its rows route's numbers go beside it
    k5["rows_route"] = {key: k5_rows[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
    for k in (k_sort, k5):
        log(f"{k['name']} at the CIC cell's {CIC_CELL_ROWS} rows: "
            f"{k['ms']:.5f} ms (bound {k['bound_ms']:.5f}, plain "
            f"{k['plain_ms']:.5f}) bit-equal to plain")
    k4 = segdep_phase(torch, segdep, common, profiling, kernel_times,
                      kernel_times.config5_slab_stream(
                          deposit, cfg5, vgrid5, inputs[0], inputs[2]))
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
    segment = segment_phase(torch, nbody, migrate, _build, profiling,
                            config5_deposit, inputs, rhos["scan"],
                            args.profile, sparse["device_busy_ms_per_step"])
    del rhos
    lap("config 5")
    # the umbrella gate over the registry's records, beside the phases
    # up to the tools phase (config 5's kernel holds are timed above)
    gate = start_gate(records_file)
    kcheck = kernelcheck_phase(torch, _build)
    lap("kernelcheck")
    dep_spans = deposit_span_phase(torch, _build, deposit, knockout_deposit)
    lap("deposit spans")

    # ---- the canonical GridRedistribute.redistribute
    canon, headline = canonical_phase(torch, pt, config1_oracle, oracle,
                                      profiling, args.profile)
    lap("canonical")
    tel = telemetry_phase(torch, pt, headline, canon["ms_per_call"])
    lap("telemetry")
    bench_line = headline_phase(torch, _build, headline_bench)
    lap("headline bench")
    stress = config7_phase(torch, config7_stress)
    lap("config 7")
    hier = hierarchical_phase(torch, pt, config1_oracle, profiling, headline)
    lap("hierarchical")
    service = service_phase(torch, _build, migrate, overlay, profiling,
                            kernel_times, service_chunk, args.profile)
    lap("service chunk")
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as work:
        driver = driver_phase(torch, _build, Path(work))
        lap("service driver")
        tools = tools_phase(torch, Path(work), recorded, gate)
    gate_dir.cleanup()
    lap("rooflines and tools")

    # ---- the halo exchange (config 6) and the public halo()
    halo = halo_phase(torch, pt, config6_halo, config1_oracle, oracle,
                      profiling, args.profile, headline)
    del headline
    lap("halo")

    # ---- the load-balanced decomposition (config 2) and config 3
    del inputs
    torch.cuda.empty_cache()
    c2_rows = c2_future.result()
    pool.shutdown()
    c2 = config2_steady_phase(torch, nbody, migrate, _build, profiling,
                              config2_clustered, args.profile, c2_rows)
    del c2_rows
    lap("config 2 steady state")
    c2["placement"] = config2_placement_phase(torch, nbody, migrate, _build,
                                              config2_clustered, stats_lib)
    c2["deposits"] = assignment_deposit_phase(torch, pt, nbody, binning,
                                              _build, config2_clustered)
    lap("config 2 placement and deposits")
    c3 = config3_phase(torch, nbody, migrate, binning, _build, profiling,
                       config3_slab, args.profile)
    lap("config 3")

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
                    (k5, c5["scan"]["launches"]),
                    (k_sort, c5["scan"]["launches"]),
                    (k6, rows["launches"])):
        k = dict(k)
        k["launches"] = path[k["name"]]
        if k["name"] == "overlay_scatter_planar":
            # kernel 2's other path of this run: the pipelined service
            # chunk's landings (K = 9, then 8), counted there
            k["launches_pipelined_chunk"] = service["launches"][k["name"]]
            k["pipelined_landing"] = service["landing"]
            # and the service driver's pipelined leg, once a step
            k["launches_driver_pipelined"] = (
                driver["legs"]["pipelined"]["launches"][k["name"]])
        kernels.append(k)
    log(f"chip_smoke: every phase passed, {time.perf_counter() - T_START:.1f}"
        f" s since the script started (the kernels' build included); "
        f"seconds a phase: " + ", ".join(
            f"{name} {t - t_prev:.1f}"
            for (_, t_prev), (name, t) in zip(laps, laps[1:])))
    log(json.dumps({"sparse_path": sparse}))
    log(json.dumps({"planar_path": planar}))
    log(json.dumps({"rows_path": rows}))
    log(json.dumps({"config5": c5}))
    log(json.dumps({"config5_segment": segment}))
    log(json.dumps({"kernelcheck": kcheck}))
    log(json.dumps({"deposit_spans": dep_spans}))
    log(json.dumps({"config2": c2}))
    log(json.dumps({"config3": c3}))
    log(json.dumps({"canonical": canon}))
    log(json.dumps({"telemetry": tel}))
    log(json.dumps({"headline": bench_line}))
    log(json.dumps({"hierarchical": hier}))
    log(json.dumps({"config7": stress}))
    log(json.dumps({"service": service}))
    log(json.dumps({"service_driver": driver}))
    log(json.dumps({"rooflines_and_tools": tools}))
    log(json.dumps({"halo": halo}))
    log(json.dumps({"ranks": ranks}))
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
