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
     could take (``bound_ms``);
  2. drives the main path through the user entry point
     ``models.nbody.make_migrate_loop``: the bench configuration (a
     2x2x2 grid as 8 vranks on one device, 2^20 rows per vrank at 90%
     fill, ~2% migration per step, dt = 1.0, engine "planar"), timed per
     step, then a counted run whose kernel launches must equal its steps,
     with conservation, ownership, zero dropped arrivals, and bit
     equality with the same loop run on the plain versions;
  3. checks the card's loop against the port's CPU run (plain versions,
     which the CPU tests hold bit-equal to the JAX package) at a small
     width.

Any failed check raises; nothing is caught and carried on. The last
lines are the ``nvidia-smi`` name and power limit, one JSON object with
every kernel's numbers, and ``{"ok": true, "device": {...}}``. Exits
non-zero without printing a result when no CUDA device is present or the
package is not beside this script. ``--profile DIR`` also writes a
``torch.profiler`` kernel table of a few main-path steps to DIR.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
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


def main_path_phase(torch, pt, nbody, _build, profiling, inputs, cap, budget,
                    profile_dir):
    cfg = nbody.DriftConfig(
        domain=pt.Domain(0.0, 1.0, periodic=True),
        grid=pt.ProcessGrid((1, 1, 1)), dt=DT, capacity=cap,
        n_local=N_LOCAL, local_budget=budget, engine="planar",
    )
    vgrid = pt.ProcessGrid(GRID)
    pos, vel, alive = inputs
    total = int(alive.sum().item())

    def make_run(S, plain=False):
        loop = nbody.make_migrate_loop(cfg, S, vgrid=vgrid, plain=plain)
        return lambda: loop(pos, vel, alive)

    # the step is host-bound (hundreds of small launches), so host
    # jitter is the noise: long runs, many samples, min of k
    detail, _ = profiling.cuda_time_per_step_samples(
        make_run, s1=4, s2=36, reps=7
    )
    per_step = detail["min"]
    log(f"main path: {per_step * 1e3:.4f} ms/step (min of k={detail['k']}, "
        f"median {detail['median'] * 1e3:.4f}, "
        f"spread {detail['spread'] * 100:.2f}%), "
        f"{total / per_step:.6g} particles/s, {total} particles")
    log(f"main path per-step samples (s): {detail['values']}")

    plain_detail, _ = profiling.cuda_time_per_step_samples(
        lambda S: make_run(S, plain=True), s1=4, s2=20, reps=3
    )
    log(f"main path on plain versions: {plain_detail['min'] * 1e3:.4f} "
        f"ms/step")

    # ---- counted run: every kernel of the path launches once per step
    run = make_run(COUNTED_STEPS)
    _build.reset_counts()
    out = run()
    torch.cuda.synchronize()
    launches = _build.counts()
    log(f"launches over {COUNTED_STEPS} steps: {launches}")
    for name, n in launches.items():
        check(n == COUNTED_STEPS,
              f"{name} launched {n} times in {COUNTED_STEPS} steps")
    pos_f, _, alive_f, stats = out
    check(int(alive_f.sum()) == total, "alive count not conserved")
    check(int(stats.dropped_recv.sum()) == 0, "arrivals dropped")
    check(torch.equal(stats.population.sum(dim=1),
                      torch.full((COUNTED_STEPS,), total, dtype=torch.int32,
                                 device="cuda")),
          "population stat disagrees with the alive count")
    check(torch.equal(stats.sent.sum(dim=1), stats.received.sum(dim=1)),
          "sent != received")
    check(bool(torch.isfinite(pos_f).all()), "non-finite positions")
    # ownership, computed independently of the port's binning
    p = pos_f.reshape(3, -1)
    g = torch.tensor(GRID, device="cuda")[:, None]
    cell = torch.floor(p.double() * g).long().clamp_min(0)
    cell = torch.minimum(cell, g - 1)
    owner = cell[0] * GRID[1] * GRID[2] + cell[1] * GRID[2] + cell[2]
    slot = torch.arange(p.shape[1], device="cuda") // N_LOCAL
    check(bool((owner[alive_f] == slot[alive_f]).all()),
          "a live row sits on a vrank that does not own its position")
    sent = stats.sent.sum(dim=1).tolist()
    log(f"migrants per step: {sent} ({np.mean(sent) / total:.4%} of live "
        f"rows), backlog {int(stats.backlog.sum())}")

    ref = make_run(COUNTED_STEPS, plain=True)()
    torch.cuda.synchronize()
    for name, a, b in zip(("pos", "vel", "alive"), out[:3], ref[:3]):
        check(torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
              f"main path {name} differs from the plain-version run")
    for f in stats._fields:
        a, b = getattr(stats, f), getattr(ref[3], f)
        check((a is None and b is None) or torch.equal(a, b),
              f"main path stat {f} differs from the plain-version run")

    if profile_dir:
        write_profile(torch, make_run, profile_dir, per_step)
    return launches, detail, total


def write_profile(torch, make_run, profile_dir, per_step) -> None:
    """Profile runs of 2 and 6 steps; their difference gives the device
    operations and device-busy time of one step (set-up cancels), and
    with the timed ms/step the device's idle share."""
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
               and not e.name.startswith("mig:")]
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        seen[S] = (len(dev), busy)
        table = prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=80
        )
        (out / f"main_path_profile_{S}steps.txt").write_text(table)
    ops = (seen[6][0] - seen[2][0]) / 4
    busy = (seen[6][1] - seen[2][1]) / 4
    log(f"profile: {ops:.1f} device operations/step, device busy "
        f"{busy:.4f} ms/step of {per_step * 1e3:.4f} ms/step "
        f"(idle {1 - busy / (per_step * 1e3):.2%}); tables in {out}")


def small_width_phase(torch, pt, nbody):
    """The loop on the card (kernels) against the port's CPU run (plain
    versions) at a small width: the same bits."""
    from mpi_grid_redistribute_tpu_torch.bench import common

    n_local = 4096
    v, cap, budget = common.drift_sizing(GRID, n_local, FILL, MIGRATION)
    pos, vel, alive = common.uniform_state(
        GRID, n_local, FILL, np.random.default_rng(1), vel_scale=4 * v
    )
    cfg = nbody.DriftConfig(
        domain=pt.Domain(0.0, 1.0, periodic=True),
        grid=pt.ProcessGrid((1, 1, 1)), dt=DT, capacity=cap,
        n_local=n_local, local_budget=budget, engine="planar",
    )
    vgrid = pt.ProcessGrid(GRID)
    a = nbody.make_migrate_loop(cfg, 5, vgrid=vgrid)(pos, vel, alive)
    b = nbody.make_migrate_loop(cfg, 5, vgrid=vgrid, device="cpu")(
        pos, vel, alive
    )
    for x, y in zip(a[:3], b[:3]):
        check(torch.equal(x.cpu().view(torch.uint8), y.view(torch.uint8)),
              "card loop differs from the CPU run at n_local=4096")
    for f in ("sent", "received", "population", "backlog", "flow"):
        check(torch.equal(getattr(a[3], f).cpu(), getattr(b[3], f)),
              f"card stat {f} differs from the CPU run")
    log("small width: card loop == CPU run (bits, stats)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler table of the main path")
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
    from mpi_grid_redistribute_tpu_torch.bench import common
    from mpi_grid_redistribute_tpu_torch.models import nbody
    from mpi_grid_redistribute_tpu_torch.ops import (
        _build, driftbin, overlay,
    )
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

    inputs = tuple(torch.from_numpy(np.ascontiguousarray(x)).cuda()
                   for x in (pos_p, vel_p, alive))
    launches, detail, total = main_path_phase(
        torch, pt, nbody, _build, profiling, inputs, cap, budget,
        args.profile,
    )
    per_step = detail["min"]
    small_width_phase(torch, pt, nbody)

    kernels = []
    for k in (k1, k2):
        k = dict(k)
        k["launches"] = launches[k["name"]]
        kernels.append(k)
    log(json.dumps({"main_path": {"ms_per_step": per_step * 1e3,
                                  "median_ms_per_step": detail["median"] * 1e3,
                                  "particles_per_s": total / per_step,
                                  "particles": total}}))
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
