"""The port's multi-rank paths as a world of processes: the world that
``chip_smoke.py``'s multi-rank phase starts on one card, the 4-card run
of :func:`main`, and the CPU tests at a small width.

A world (``parallel.launch.run_world`` of :func:`world_main`) runs the
parts its ``spec`` names (:func:`prepare`); smaller grids use a subgroup
of the first ranks:

  * ``vranks``: the bench grid (2x2x2) as ``dev_grid`` ranks x ``vgrid``
    vranks, ``make_migrate_loop(..., mesh=)`` from the bench state (the
    global rows ``[r * V * n, (r + 1) * V * n)`` on rank ``r``): a
    counted run (kernel launches a step), ms per step, and a digest of
    every slab's multiset of live ``(pos, vel)`` bit rows;
  * ``flat``: the same grid as 8 ranks, one slab each (the flat engine,
    ``vgrid=None``), with the mxu and then the scan deposit fused into
    each step (counted runs, each held against the same loop with
    ``plain=True``), the same digests; then the mxu and scan deposits of
    the bench state across ranks, kernel and plain, each rank's block
    for the caller to hold against one device's plain density;
  * ``GridRedistribute(mesh=)`` over the world's grid with ``"auto"``
    (the sparse engine) and ``"planar"`` on config 1's rows, always;
  * ``drift``: the canonical drift loop (``make_drift_loop``) on the
    2x2x2 grid from the bench state (each rank's live rows are a prefix
    of its rows), config 5's deposit each step with ``"mxu"`` and then
    ``"scan"`` (counted runs, each held against the same loop with
    ``plain=True``); the scan run's final rows are written for the
    caller's one-process density;
  * ``halo``: ``GridRedistribute(mesh=).halo()`` at config 6's width on
    its state, both engines, a digest of each rank's ghosts;
  * ``hier``: ``GridRedistribute(mesh=, dcn_shape=DCN_SHAPE)`` on
    config 1's rows (``"auto"``: the hierarchical engine);
  * ``card_vs_cpu``: a small width on ranks 0-1 (dev grid (2, 1, 1) x
    vgrid (1, 2, 2), the scan and then the mxu deposit each step; then
    on the (2, 1, 1) grid one drift step with its scan deposit, a halo
    with each engine and a hierarchical call over two pods) on the
    ranks' device and on the CPU: the state and stats bit for bit, the
    density bit for bit (scan) or within :data:`DEPOSIT_TOL` (mxu).

:func:`verify` holds the results against :func:`reference`. Times are
host-clock ms per step; ranks sharing one card over gloo give no
multi-GPU figure.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np

from mpi_grid_redistribute_tpu_torch.convert import split_grid, split_rows

GRID = (2, 2, 2)
DEV_GRID = (2, 1, 1)
VGRID = (1, 2, 2)
SMALL_N = 4096
DEPOSIT_SHAPE = (128, 128, 128)
SMALL_DEPOSIT_SHAPE = (16, 16, 16)
CONFIG1_N = 1 << 20
HALO_N = 1 << 18  # config 6's rows a rank
DCN_SHAPE = (2, 1, 1)  # the hierarchical part's pods
DRIFT_STEPS = 4  # a method's counted drift run
HALO_CALLS = 5  # timed halo() calls an engine


# odd 64-bit multipliers of the additive multiset fingerprint
_MIX = (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
        0xD6E8FEB86659FD93, 0xFF51AFD7ED558CCD, 0xC4CEB9FE1A85EC53)


def _signed(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


def slab_digests(pos, vel, alive, n_slab: int):
    """``[(live rows, sha256, fingerprint)]`` a slab of ``n_slab``
    columns. The sha256 hashes the slab's live ``(pos, vel)`` rows as
    int32 bit patterns sorted lexicographically (a multiset, whatever
    the slot order); the fingerprint is a sum of 64-bit row hashes
    (wrapping), so the fingerprints of any set of slabs add up to their
    union's. ``pos``/``vel`` are planar flat ``[3 * m]`` tensors, ``alive
    [m]``."""
    import torch

    rows = torch.cat([pos.reshape(3, -1), vel.reshape(3, -1)]).view(
        torch.int32).T  # [m, 6]
    out = []
    for s in range(rows.shape[0] // n_slab):
        sl = slice(s * n_slab, (s + 1) * n_slab)
        r = rows[sl][alive[sl]]
        perm = torch.arange(r.shape[0], device=r.device)
        for c in reversed(range(6)):
            perm = perm[torch.sort(r[perm, c], stable=True).indices]
        data = r[perm].cpu().numpy().tobytes()
        h = torch.zeros((r.shape[0],), dtype=torch.int64, device=r.device)
        for c in range(6):
            w = r[:, c].to(torch.int64) & 0xFFFFFFFF
            h = (h ^ w) * _signed(_MIX[c])
            h = h ^ (h >> 29)
        fp = int(h.sum()) & ((1 << 64) - 1)
        out.append((int(r.shape[0]), hashlib.sha256(data).hexdigest(), fp))
    return out


def _owned(pos, alive, n_slab: int, first_slab: int) -> bool:
    """Every live row sits on the slab (a full-grid rank of the 2x2x2
    grid, device-major) owning its position, computed in float64."""
    import torch

    p = pos.reshape(3, -1).double()
    g = torch.tensor(GRID, device=p.device)[:, None]
    cell = torch.minimum(torch.floor(p * g).long().clamp_min(0), g - 1)
    owner = cell[0] * GRID[1] * GRID[2] + cell[1] * GRID[2] + cell[2]
    slot = first_slab + torch.arange(p.shape[1], device=p.device) // n_slab
    return bool((owner[alive] == slot[alive]).all())


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counted(torch, _build, device, run):
    """``(out, launches, seconds)`` of ``run()``: kernel counts set to 0
    just before it and read just after, host clock around it."""
    _sync(torch, device)
    _build.reset_counts()
    t0 = time.perf_counter()
    out = run()
    _sync(torch, device)
    return out, _build.counts(), time.perf_counter() - t0


def _stepped(torch, _build, device, loop, steps: int, barrier):
    """The loop's counted run of ``steps`` steps and a 2-step run, each
    started together on every rank (``barrier``): ``(out, launches, raw
    ms a step, ms a step)``. Raw is the host clock over the counted run
    (building the loop, fusing the state and gathering the stats
    included) over its steps; the per-step figure is the two runs'
    difference over their step difference, which cancels that set-up,
    as the one-process loop rows are read."""
    barrier()
    _, _, t2 = _counted(torch, _build, device, lambda: loop(2))
    barrier()
    out, launches, t = _counted(torch, _build, device, lambda: loop(steps))
    return out, launches, t * 1e3 / steps, (t - t2) * 1e3 / (steps - 2)


def _profile(torch, device, make_run, barrier, table: str = None):
    """Runs of 2 and 6 steps under ``torch.profiler`` (host and device),
    each started together on every rank (``barrier``), differenced to one
    step: ``(device busy ms, device operations, host ms inside the
    collectives, device ms in NCCL kernels)``. Busy and operations leave
    NCCL's kernels out: they spin on the device until their peers arrive,
    so their time is waiting as much as work. The host trace costs time
    of its own, so these runs are not the timed ones. ``table``: a path
    for the 6-step run's op table (host and device time by op)."""
    from torch.profiler import ProfilerActivity, profile

    seen = {}
    for steps in (2, 6):
        run = make_run(steps)
        run()
        _sync(torch, device)
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            barrier()  # inside: the profiler's own start-up is not waited
            run()
            _sync(torch, device)
        ev = prof.events()
        dev = [e for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("mig:", "dep:", "coll:"))]
        nccl = [e for e in dev if "nccl" in e.name.lower()]
        work = [e for e in dev if "nccl" not in e.name.lower()]
        coll = [e for e in ev if e.name.startswith("coll:")
                and e.device_type == torch.autograd.DeviceType.CPU]

        def ms(es):
            return sum(e.time_range.elapsed_us() for e in es) / 1e3

        seen[steps] = (ms(work), len(work), ms(coll), ms(nccl))
        if table and steps == 6:
            with open(table, "w") as f:
                f.write(prof.key_averages().table(
                    sort_by="self_cpu_time_total", row_limit=60))
    return tuple((seen[6][i] - seen[2][i]) / 4 for i in range(4))


def _table(spec, name: str):
    """Where a profiled run writes its op table: ``spec["profile_dir"]``
    (rank 0's only), or nowhere."""
    d = spec.get("profile_dir")
    if not d or not name.endswith("rank0"):
        return None
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{name}_profile_6steps.txt")


def _stats_np(stats):
    return {k: v.cpu().numpy() for k, v in stats._asdict().items()
            if v is not None}


def _planar_shard(spec, ranks: int, i: int, dev):
    """Rank ``i`` of ``ranks``: its rows of the bench state as the loop
    takes them (planar flat pos/vel, the alive mask) on ``dev``."""
    import torch

    wd = spec["workdir"]
    p, v, a = (torch.from_numpy(np.ascontiguousarray(split_rows(np.load(
        os.path.join(wd, f"{k}.npy"), mmap_mode="r"), ranks)[i])).to(dev)
        for k in ("pos", "vel", "alive"))
    return [p.T.contiguous().reshape(-1), v.T.contiguous().reshape(-1), a]


def _vranks_part(spec, mesh, dev, barrier, name: str) -> dict:
    """The bench grid as ``spec["dev_grid"]`` ranks x ``spec["vgrid"]``
    vranks over ``mesh`` (rank ``r`` holds the global rows ``[r * V * n,
    (r + 1) * V * n)``; its vrank ``v`` is the 2x2x2 grid's rank ``r * V
    + v``): a counted run, ms per step, profiled with ``spec["profile"]``,
    and a digest of every slab."""
    import torch

    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.models import nbody
    from mpi_grid_redistribute_tpu_torch.ops import _build

    r, n = mesh.rank, spec["n_local"]
    V = int(np.prod(spec["vgrid"]))
    cfg = nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True),
        grid=ProcessGrid(spec["dev_grid"]), dt=1.0, capacity=spec["capacity"],
        n_local=n, local_budget=spec["local_budget"])
    args = _planar_shard(spec, mesh.size, r, dev)

    def loop(steps):
        return nbody.make_migrate_loop(
            cfg, steps, vgrid=ProcessGrid(spec["vgrid"]), mesh=mesh,
            device=dev)(*args)

    loop(1)  # warm-up
    res, launches, raw, per_step = _stepped(torch, _build, dev, loop,
                                            spec["steps"], barrier)
    out = dict(launches=launches, ms_per_step=per_step, raw_ms_per_step=raw,
               digests=slab_digests(res[0], res[1], res[2], n),
               owned=_owned(res[0], res[2], n, r * V),
               stats=_stats_np(res[3]))
    del res
    if spec.get("profile"):
        out["profile"] = _profile(torch, dev, lambda k: (lambda: loop(k)),
                                  barrier, _table(spec, f"{name}_rank{r}"))
    return out


def _max_err(a, b) -> float:
    return float((a.double() - b.to(a.device).double()).abs().max())


def _same_bits(a, b) -> bool:
    import torch

    return bool(torch.equal(a.cpu().view(torch.uint8),
                            b.cpu().view(torch.uint8)))


def _flat_part(spec, mesh, dev, barrier) -> dict:
    """The bench grid as 8 ranks, one slab each (the flat engine): the
    loop with the mxu and then the scan deposit each step (counted runs),
    each held against the same loop run with ``plain=True`` on the same
    inputs; then the mxu and scan deposits of the bench state across
    ranks, kernel and plain."""
    import torch

    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.models import nbody
    from mpi_grid_redistribute_tpu_torch.ops import _build, deposit

    r, n, S = mesh.rank, spec["n_local"], spec["steps"]
    dom = Domain(0.0, 1.0, periodic=True)
    shape = tuple(spec["deposit_shape"])
    args = _planar_shard(spec, mesh.size, r, dev)
    flat = {}
    for method, steps in (("mxu", S), ("scan", 4)):
        cfg = nbody.DriftConfig(
            domain=dom, grid=ProcessGrid(GRID), dt=1.0,
            capacity=spec["capacity"], n_local=n, deposit_shape=shape,
            deposit_method=method)

        def loop(k, plain=False):
            return nbody.make_migrate_loop(
                cfg, k, mesh=mesh, device=dev, plain=plain,
                deposit_each_step=True)(*args)

        loop(1)
        res, launches, raw, per_step = _stepped(torch, _build, dev, loop,
                                                steps, barrier)
        want = loop(steps, plain=True)
        flat[method] = dict(
            launches=launches, steps=steps, ms_per_step=per_step,
            raw_ms_per_step=raw, rho_sum=float(res[4].double().sum()),
            state_equals_plain=all(_same_bits(a, b)
                                   for a, b in zip(res[:3], want[:3])),
            rho_err_vs_plain=_max_err(res[4], want[4]))
        del want
        if method == "mxu" and spec.get("profile"):
            flat["profile"] = _profile(torch, dev,
                                       lambda k: (lambda: loop(k)), barrier,
                                       _table(spec, f"flat_mxu_rank{r}"))
        if method == "mxu":
            flat["digests"] = slab_digests(res[0], res[1], res[2], n)
            flat["owned"] = _owned(res[0], res[2], n, r)
            flat["stats"] = _stats_np(res[3])
        del res
    # the deposits of the bench state across ranks: this rank's block
    pos_rows = args[0].reshape(3, -1)
    valid = args[2]
    for method in ("mxu", "scan"):
        def fn(plain):
            if method == "mxu":
                return deposit.shard_deposit_device_mxu_fn(
                    dom, ProcessGrid(GRID), shape, plain=plain, mesh=mesh)
            return deposit.shard_deposit_device_planar_fn(
                dom, ProcessGrid(GRID), shape, plain=plain, mesh=mesh)

        mass = None if method == "mxu" else torch.ones(
            valid.shape, dtype=torch.float32, device=dev)
        dep = fn(False)
        rho, launches, sec = _counted(torch, _build, dev,
                                      lambda: dep(pos_rows, mass, valid))
        want = fn(True)(pos_rows, mass, valid)
        flat[f"deposit_{method}"] = dict(
            rho=rho.cpu().numpy(), launches=launches, ms=sec * 1e3,
            err_vs_plain=_max_err(rho, want))
    return flat


def _redistribute_part(spec, mesh, dev) -> dict:
    """``GridRedistribute(mesh=)`` over ``spec["world_grid"]`` on config
    1's rows, ``"auto"`` (the sparse engine) and ``"planar"``, each timed
    once after its calibrating calls."""
    import torch

    from mpi_grid_redistribute_tpu_torch import api
    from mpi_grid_redistribute_tpu_torch.ops import _build

    c1 = [torch.from_numpy(np.ascontiguousarray(split_rows(np.load(
        os.path.join(spec["workdir"], f"c1_{k}.npy"), mmap_mode="r"),
        mesh.size)[mesh.rank])).to(dev) for k in ("pos", "vel", "ids")]
    out = {}
    for engine in ("auto", "planar"):
        rd = api.GridRedistribute(lo=0.0, hi=1.0, periodic=True,
                                  grid=tuple(spec["world_grid"]),
                                  capacity_factor=4.0, mesh=mesh,
                                  device=dev, engine=engine)
        for _ in range(3):  # calibration: the synchronous checks
            rd.redistribute(*c1)
        res, _, sec = _counted(torch, _build, dev,
                               lambda: rd.redistribute(*c1))
        rd.flush_overflow_checks()
        out[engine] = dict(
            engine=rd._last_wire["engine"], ms=sec * 1e3,
            positions=res.positions.cpu().numpy(),
            fields=[f.cpu().numpy() for f in res.fields],
            count=res.count.cpu().numpy(), stats=_stats_np(res.stats))
    return out


def _rank_rows(spec, prefix: str, ranks: int, i: int):
    """Rank ``i`` of ``ranks``: its row-major rows of a state written by
    :func:`prepare` (``pos``, ``vel``, ``alive``), live rows first in
    their order, and the live count (the canonical layout)."""
    return _live_first(*(np.ascontiguousarray(split_rows(np.load(
        os.path.join(spec["workdir"], f"{prefix}{k}.npy"), mmap_mode="r"),
        ranks)[i]) for k in ("pos", "vel", "alive")))


def _live_first(pos, vel, alive):
    """``(pos, vel, count)``: the live rows first, in their order."""
    order = np.argsort(~alive, kind="stable")
    return pos[order], vel[order], int(alive.sum())


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a.cpu().numpy() if hasattr(a, "cpu")
                                      else a).tobytes())
    return h.hexdigest()


def _owned_rows(pos, count: int, grid, rank: int) -> bool:
    """Every live row of a rank's row-major ``pos [n, 3]`` lies in the
    rank's cell of ``grid`` on the unit box (float64)."""
    import torch

    p = pos[:count].double()
    g = torch.tensor(grid, device=p.device)
    cell = torch.minimum(torch.floor(p * g).long().clamp_min(0), g - 1)
    owner = (cell[:, 0] * grid[1] + cell[:, 1]) * grid[2] + cell[:, 2]
    return bool((owner == rank).all())


def _drift_part(spec, mesh, dev, barrier) -> dict:
    """The canonical drift loop across the 8 ranks from the bench state,
    config 5's deposit each step: ``"mxu"`` then ``"scan"``, each a
    counted run of :data:`DRIFT_STEPS` steps (ms a step raw and
    differenced) held against the same loop with ``plain=True`` (state
    byte-equal, density byte-equal for scan, within :data:`DEPOSIT_TOL`
    for mxu). The scan run's final rows go to the workdir."""
    import torch

    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.models import nbody
    from mpi_grid_redistribute_tpu_torch.ops import _build

    r, n = mesh.rank, spec["n_local"]
    pos, vel, count = _rank_rows(spec, "", mesh.size, r)
    args = (torch.from_numpy(pos).to(dev), torch.from_numpy(vel).to(dev),
            count)
    out = {"count_in": count}
    for method in ("mxu", "scan"):
        cfg = nbody.DriftConfig(
            domain=Domain(0.0, 1.0, periodic=True), grid=ProcessGrid(GRID),
            dt=1.0, capacity=spec["capacity"], n_local=n,
            deposit_shape=tuple(spec["deposit_shape"]),
            deposit_method=method)

        def loop(k, plain=False):
            return nbody.make_drift_loop(cfg, k, mesh=mesh,
                                         deposit_each_step=True, device=dev,
                                         plain=plain)(*args)

        loop(1)  # warm-up
        res, launches, raw, per_step = _stepped(torch, _build, dev, loop,
                                                DRIFT_STEPS, barrier)
        want = loop(DRIFT_STEPS, plain=True)
        c = int(res[2][0])
        out[method] = dict(
            launches=launches, ms_per_step=per_step, raw_ms_per_step=raw,
            state_equals_plain=all(_same_bits(a, b)
                                   for a, b in zip(res[:3], want[:3])),
            rho_equals_plain=_same_bits(res[4], want[4]),
            rho_err_vs_plain=_max_err(res[4], want[4]),
            rho=res[4].cpu().numpy(), count=c,
            owned=_owned_rows(res[0], c, GRID, r),
            finite=bool(torch.isfinite(res[0][:c]).all()),
            stats=_stats_np(res[3]))
        if method == "scan":
            np.save(os.path.join(spec["workdir"], f"drift_pos_{r}.npy"),
                    res[0][:c].cpu().numpy())
        del res, want
    return out


def _halo_part(spec, mesh, dev, barrier) -> dict:
    """``GridRedistribute(mesh=).halo()`` at config 6's width on its
    state (this rank's vrank slab), the planar (``"auto"``) and the
    row-major engine: ms a call (the host clock over
    :data:`HALO_CALLS` calls started together), each rank's ghost
    digest and the gathered counters."""
    import torch

    from mpi_grid_redistribute_tpu_torch import api
    from mpi_grid_redistribute_tpu_torch.bench import config6_halo

    pos_v, count, w, pc, gc = config6_halo.setup(spec["halo_n"])
    pos = torch.from_numpy(np.ascontiguousarray(pos_v[mesh.rank])).to(dev)
    out = dict(width=w, pass_capacity=pc, ghost_capacity=gc)
    for engine in ("auto", "rowmajor"):
        rd = api.GridRedistribute(lo=0.0, hi=1.0, periodic=True, grid=GRID,
                                  mesh=mesh, device=dev, engine=engine)
        res = rd.halo(pos, width=w, count=int(count[mesh.rank]))
        barrier()
        _sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(HALO_CALLS):
            res = rd.halo(pos, width=w, count=int(count[mesh.rank]))
        _sync(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3 / HALO_CALLS
        g = int(res.ghost_count[mesh.rank])
        out[engine] = dict(
            ms=ms, ghost_count=res.ghost_count.cpu().numpy(),
            overflow=res.overflow.cpu().numpy(),
            ghost_capacity=int(res.ghost_positions.shape[0]),
            digest=_digest(res.ghost_positions[:g]))
    return out


def _hier_part(spec, mesh, dev) -> dict:
    """``GridRedistribute(mesh=, dcn_shape=DCN_SHAPE)`` on config 1's
    rows with ``"auto"`` (several pods: the hierarchical engine),
    timed as :func:`_redistribute_part` times its engines."""
    import torch

    from mpi_grid_redistribute_tpu_torch import api
    from mpi_grid_redistribute_tpu_torch.ops import _build

    c1 = [torch.from_numpy(np.ascontiguousarray(split_rows(np.load(
        os.path.join(spec["workdir"], f"c1_{k}.npy"), mmap_mode="r"),
        mesh.size)[mesh.rank])).to(dev) for k in ("pos", "vel", "ids")]
    rd = api.GridRedistribute(lo=0.0, hi=1.0, periodic=True,
                              grid=tuple(spec["world_grid"]),
                              capacity_factor=4.0, mesh=mesh, device=dev,
                              dcn_shape=DCN_SHAPE)
    for _ in range(3):  # calibration: the synchronous checks and growth
        rd.redistribute(*c1)
    res, _, sec = _counted(torch, _build, dev, lambda: rd.redistribute(*c1))
    rd.flush_overflow_checks()
    return dict(engine=rd._last_wire["engine"], ms=sec * 1e3,
                n_pods=rd.n_pods,
                cross_cap=rd._cross_cap, mover_cap=rd._mover_cap,
                fallback=int(res.stats.fallback.sum()),
                positions=res.positions.cpu().numpy(),
                fields=[f.cpu().numpy() for f in res.fields],
                count=res.count.cpu().numpy(), stats=_stats_np(res.stats))


def _slice_small(pos, vel, count: int, mesh, dev) -> dict:
    """On the (2, 1, 1) grid of ranks 0-1 (``mesh``) from this rank's rows
    (the first ``count`` live): one drift step with its scan deposit, a
    halo of its output with each engine, and a hierarchical call (two
    pods of one rank) on the same rows; every output as numpy, and the
    drift step's kernel launches."""
    import torch

    from mpi_grid_redistribute_tpu_torch import api
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.models import nbody
    from mpi_grid_redistribute_tpu_torch.ops import _build

    n = pos.shape[0]
    dev = torch.device(dev)
    cfg = nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True), grid=ProcessGrid(DEV_GRID),
        dt=1.0, capacity=n, n_local=n, deposit_shape=SMALL_DEPOSIT_SHAPE,
        deposit_method="scan")
    step = nbody.make_drift_step(cfg, mesh, device=dev)
    res, launches, _ = _counted(torch, _build, dev, lambda: step(
        torch.from_numpy(pos).to(dev), torch.from_numpy(vel).to(dev),
        count))
    out = {"drift": (tuple(a.cpu().numpy() for a in res[:3]),
                     _stats_np(res[3]), res[4].cpu().numpy()),
           "launches": launches}
    kw = dict(lo=0.0, hi=1.0, periodic=True, grid=DEV_GRID, mesh=mesh,
              device=dev)
    for engine in ("auto", "rowmajor"):
        h = api.GridRedistribute(engine=engine, **kw).halo(
            res[0], res[1], width=0.05, count=res[2])
        out[f"halo_{engine}"] = (h.ghost_positions.cpu().numpy(),
                                 h.ghost_fields[0].cpu().numpy(),
                                 h.ghost_count.cpu().numpy(),
                                 h.overflow.cpu().numpy())
    rd = api.GridRedistribute(engine="hierarchical", dcn_shape=DEV_GRID,
                              capacity=n, out_capacity=2 * n, **kw)
    ids = torch.arange(n, dtype=torch.int32, device=dev) + mesh.rank * n
    r = rd.redistribute(torch.from_numpy(pos).to(dev), ids, count=count)
    out["hier"] = (r.positions.cpu().numpy(), r.fields[0].cpu().numpy(),
                   r.count.cpu().numpy(), _stats_np(r.stats),
                   rd._last_wire["engine"])
    return out


def _same_tree(a, b) -> bool:
    """Byte equality of nested tuples/dicts of numpy arrays and scalars."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k])
                                            for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_tree(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.tobytes() == b.tobytes()
    return a == b


def _card_vs_cpu_part(spec, mesh, dev) -> dict:
    """The small width as dev grid (2, 1, 1) x vgrid (1, 2, 2) over
    ``mesh`` (gloo, which takes both devices' tensors), each deposit
    method each step, on ``dev`` and on the CPU: which outputs are bit
    for bit the same, and the density's largest difference."""
    import torch

    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.models import nbody

    small = spec["small"]
    inp = [np.ascontiguousarray(split_rows(np.load(os.path.join(
        spec["workdir"], f"small_{k}.npy")), 2)[mesh.rank])
        for k in ("pos", "vel", "alive")]
    out = {}
    for method in ("scan", "mxu"):
        cfg = nbody.DriftConfig(
            domain=Domain(0.0, 1.0, periodic=True),
            grid=ProcessGrid(DEV_GRID), dt=1.0, capacity=small["capacity"],
            n_local=SMALL_N, local_budget=small["local_budget"],
            deposit_shape=SMALL_DEPOSIT_SHAPE, deposit_method=method)
        runs = [nbody.make_migrate_loop(cfg, 5, vgrid=ProcessGrid(VGRID),
                                        mesh=mesh, device=d,
                                        deposit_each_step=True)(*inp)
                for d in (dev, "cpu")]
        same = {name: _same_bits(a, b) for name, a, b in zip(
            ("pos", "vel", "alive", "rho"), runs[0][:3] + (runs[0][4],),
            runs[1][:3] + (runs[1][4],))}
        for f, a in runs[0][3]._asdict().items():
            if a is not None:
                same[f"stats.{f}"] = bool(torch.equal(
                    a.cpu(), getattr(runs[1][3], f)))
        out[method] = dict(same=same, rho_err=_max_err(runs[0][4],
                                                       runs[1][4]),
                           rows=int(runs[1][2].sum()),
                           moved=int(runs[1][3].sent.sum()))
    rows = _rank_rows(spec, "small_", 2, mesh.rank)
    card, cpu = (_slice_small(*rows, mesh, d) for d in (dev, "cpu"))
    out["slice"] = dict(
        same={k: _same_tree(card[k], cpu[k]) for k in cpu
              if k != "launches"},
        launches=card["launches"],
        hier_engine=cpu["hier"][4],
        ghosts=int(cpu["halo_auto"][2].sum()),
        moved=int(cpu["drift"][1]["send_counts"].sum()
                  - np.trace(cpu["drift"][1]["send_counts"])))
    return out


def world_main(ctx, spec):
    """One rank of the world (see the module docstring): the parts
    ``spec["parts"]`` names, on the inputs :func:`prepare` wrote."""
    import torch
    import torch.distributed as dist

    from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid
    from mpi_grid_redistribute_tpu_torch.ops import _build
    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib

    r, dev = ctx.rank, ctx.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        _build.build_all()  # loads the libraries the caller built
    parts = spec["parts"]
    out = {"device": str(dev), "backend": ctx.backend}
    world = mesh_lib.make_mesh(ProcessGrid(spec["world_grid"]))
    # subgroups of the first ranks, created on every rank
    Wv = int(np.prod(spec["dev_grid"]))
    sub = (world.group if Wv == ctx.world_size
           else dist.new_group(list(range(Wv))))
    if "card_vs_cpu" in parts:
        pair = sub if Wv == 2 else dist.new_group([0, 1])
    seconds = out["seconds"] = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        t = time.perf_counter()
        seconds[name] = t - t0
        t0 = t

    if "vranks" in parts and r < Wv:
        out["vranks"] = _vranks_part(
            spec, mesh_lib.make_mesh(ProcessGrid(spec["dev_grid"]),
                                     group=sub),
            dev, lambda: dist.barrier(group=sub), "vranks")
    dist.barrier()
    lap("vranks")
    if "flat" in parts:
        out["flat"] = _flat_part(spec, world, dev, dist.barrier)
        lap("flat")
    out["redistribute"] = _redistribute_part(spec, world, dev)
    dist.barrier()
    lap("redistribute")
    if "drift" in parts:
        out["drift"] = _drift_part(spec, world, dev, dist.barrier)
        dist.barrier()
        lap("drift")
    if "halo" in parts:
        out["halo"] = _halo_part(spec, world, dev, dist.barrier)
        dist.barrier()
        lap("halo")
    if "hier" in parts:
        out["hier"] = _hier_part(spec, world, dev)
        dist.barrier()
        lap("hier")
    if "card_vs_cpu" in parts and r < 2 and dev.type == "cuda":
        out["card_vs_cpu"] = _card_vs_cpu_part(
            spec, mesh_lib.make_mesh(ProcessGrid(DEV_GRID), group=pair), dev)
    dist.barrier()
    lap("card_vs_cpu")
    return out


def prepare(workdir: str, n_local: int, fill: float = 0.9,
            migration: float = 0.02, state=None,
            deposit_shape=DEPOSIT_SHAPE, config1_n: int = CONFIG1_N,
            dev_grid=DEV_GRID, vgrid=VGRID, world_grid=GRID,
            parts=("vranks", "flat", "drift", "halo", "hier", "card_vs_cpu"),
            halo_n: int = HALO_N) -> dict:
    """Write the world's inputs to ``workdir`` and return its ``spec``:
    the bench state (``common.uniform_state`` of the 2x2x2 grid from seed
    0 at the ``drift_sizing`` velocities, or ``state``, the same arrays
    the caller already drew), the small width's (seed 1, 4x the
    velocities) and config 1's ``config1_n`` rows; ``deposit_shape`` is
    the deposits' mesh (config 5's by default). The world has
    ``prod(world_grid)`` ranks (``GridRedistribute(mesh=)`` runs over
    that grid); the vranks part runs ``dev_grid`` x ``vgrid`` (which must
    make the 2x2x2 grid) on its first ranks; ``"flat"``, ``"drift"`` and
    ``"halo"`` need ``world_grid`` to be the 2x2x2 grid; ``halo_n`` is
    the halo part's rows a rank (config 6's by default)."""
    from mpi_grid_redistribute_tpu_torch.bench import common, config1_oracle

    if tuple(d * v for d, v in zip(dev_grid, vgrid)) != GRID:
        raise ValueError(f"dev grid {dev_grid} x vgrid {vgrid} is not {GRID}")
    for part in ("flat", "drift", "halo"):
        if part in parts and tuple(world_grid) != GRID:
            raise ValueError(f"the {part} part runs on {GRID}, not "
                             f"{world_grid}")
    v, cap, budget = common.drift_sizing(GRID, n_local, fill, migration)
    if state is None:
        state = common.uniform_state(GRID, n_local, fill,
                                     np.random.default_rng(0), vel_scale=v)
    vs, cap_s, budget_s = common.drift_sizing(GRID, SMALL_N, fill, migration)
    small = common.uniform_state(GRID, SMALL_N, fill,
                                 np.random.default_rng(1), vel_scale=4 * vs)
    for prefix, arrays in (("", state), ("small_", small),
                           ("c1_", config1_oracle.inputs(config1_n))):
        for name, a in zip(("pos", "vel", "alive") if prefix != "c1_"
                           else ("pos", "vel", "ids"), arrays):
            np.save(os.path.join(workdir, f"{prefix}{name}.npy"), a)
    return dict(workdir=workdir, n_local=n_local, capacity=cap,
                local_budget=budget, steps=6, vel_scale=v.tolist(),
                deposit_shape=tuple(deposit_shape), config1_n=config1_n,
                small=dict(capacity=cap_s, local_budget=budget_s),
                dev_grid=tuple(dev_grid), vgrid=tuple(vgrid),
                world_grid=tuple(world_grid), parts=tuple(parts),
                halo_n=halo_n)


def reference(spec, device, single=None) -> dict:
    """What :func:`verify` holds the world against, on one process:
    ``digests`` of the single-process 8-vrank loop's slabs (``single``,
    the caller's ``(pos, vel, alive)`` output of ``spec["steps"]`` steps
    from the bench state, or run here with ``engine="planar"``), the
    port's NumPy oracle on config 1 over ``spec["world_grid"]``
    (``oracle``) and, with the flat part, the one-device mxu and scan
    densities of the bench state from the plain versions (``rho``)."""
    import torch

    from mpi_grid_redistribute_tpu_torch import api
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.models import nbody
    from mpi_grid_redistribute_tpu_torch.ops import deposit

    wd = spec["workdir"]
    n = spec["n_local"]
    pos, vel, alive = (np.load(os.path.join(wd, f"{k}.npy"))
                       for k in ("pos", "vel", "alive"))
    dom = Domain(0.0, 1.0, periodic=True)
    one = ProcessGrid((1, 1, 1))
    if single is None:
        cfg = nbody.DriftConfig(domain=dom, grid=one, dt=1.0,
                                capacity=spec["capacity"], n_local=n,
                                local_budget=spec["local_budget"],
                                engine="planar")
        single = nbody.make_migrate_loop(
            cfg, spec["steps"], vgrid=ProcessGrid(GRID), device=device)(
            pos, vel, alive)
    ref = dict(digests=slab_digests(*single[:3], n),
               backlog=int(single[3].backlog.sum()))
    c1 = [np.load(os.path.join(wd, f"c1_{k}.npy"))
          for k in ("pos", "vel", "ids")]
    ref["oracle"] = api.GridRedistribute(
        lo=0.0, hi=1.0, periodic=True, grid=tuple(spec["world_grid"]),
        capacity_factor=4.0, backend="numpy").redistribute(*c1)
    if "drift" in spec["parts"]:
        # one process's plain density of the drift loop's final rows
        rows = np.concatenate([np.load(os.path.join(wd, f"drift_pos_{r}.npy"))
                               for r in range(8)])
        p = torch.from_numpy(np.ascontiguousarray(rows.T)).to(device)
        ones = torch.ones((rows.shape[0],), dtype=torch.float32,
                          device=device)
        ref["drift_rho"] = deposit.shard_deposit_device_planar_fn(
            dom, one, tuple(spec["deposit_shape"]), plain=True)(
                p, ones, ones > 0).cpu().numpy()
    if "halo" in spec["parts"]:
        ref["halo"] = _halo_reference(spec, device)
    if "flat" in spec["parts"]:
        p = torch.from_numpy(nbody.rows_to_planar(pos, 1)).to(
            device).reshape(3, -1)
        a = torch.from_numpy(alive).to(device)
        shape = tuple(spec["deposit_shape"])
        ones = torch.ones(a.shape, dtype=torch.float32, device=device)
        ref["rho"] = {
            "mxu": deposit.shard_deposit_device_mxu_fn(
                dom, one, shape, plain=True)(p, None, a).cpu().numpy(),
            "scan": deposit.shard_deposit_device_planar_fn(
                dom, one, shape, plain=True)(p, ones, a).cpu().numpy(),
        }
    return ref


def _halo_reference(spec, device) -> dict:
    """Config 6's state through the one-device vrank engines (planar and
    row-major): each vrank's ghost digest and count, the engines' ghosts
    held against each other and against ``oracle.brute_force_ghosts``
    (rows sorted, float64 oracle, 1e-5)."""
    import torch

    from mpi_grid_redistribute_tpu_torch import oracle
    from mpi_grid_redistribute_tpu_torch.bench import config6_halo
    from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid

    pos_v, count, w, pc, gc = config6_halo.setup(spec["halo_n"])
    fns = config6_halo.engines(w, pc, gc)
    states, count_t = config6_halo.device_states(pos_v, count, device)
    ghost, gcount, overflow = fns["planar"](states["planar"], count_t)
    rows = ghost.transpose(1, 2)  # [V, G, 3]
    r_ghost, r_count, r_over = fns["rowmajor"](states["rowmajor"], count_t)
    gcount = gcount.cpu().numpy()
    if (r_count.cpu().numpy() != gcount).any() or overflow.any() \
            or r_over.any():
        raise AssertionError("config 6 vrank engines: counts differ or "
                             "overflow")
    want = oracle.brute_force_ghosts(config6_halo.DOMAIN, ProcessGrid(GRID),
                                     list(pos_v), w)
    out = {"gcount": gcount, "digest": {"auto": [], "rowmajor": []}}
    for v in range(len(gcount)):
        g = int(gcount[v])
        a = rows[v, :g].contiguous()
        b = r_ghost[v, :g]
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"config 6 vrank {v}: engines differ")
        got = a.cpu().numpy()
        exp = want[v]
        if len(exp) != g or not np.allclose(
                got[np.lexsort(got.T[::-1])], exp[np.lexsort(exp.T[::-1])],
                atol=1e-5):
            raise AssertionError(f"config 6 vrank {v}: ghosts are not the "
                                 f"oracle's set")
        out["digest"]["auto"].append(_digest(a))
        out["digest"]["rowmajor"].append(_digest(b))
    return out


def _oracle_shards(res, R: int) -> dict:
    """The oracle's global result as each rank's shard (positions,
    fields, count) and its global stats."""
    return dict(positions=split_rows(res.positions, R),
                fields=[split_rows(f, R) for f in res.fields],
                count=split_rows(res.count, R),
                stats={k: np.asarray(v) for k, v in res.stats._asdict().items()
                       if v is not None})


def _same_shard(got, o, r: int) -> bool:
    return (got["positions"].tobytes() == o["positions"][r].tobytes()
            and all(g.tobytes() == w[r].tobytes()
                    for g, w in zip(got["fields"], o["fields"]))
            and got["count"].tobytes() == o["count"][r].tobytes())


def _same_multisets(label, got, want, backlogs):
    """Per slab when nothing backlogged anywhere, else the union (counts
    and fingerprints add up)."""
    if not any(backlogs):
        bad = [s for s, (g, w) in enumerate(zip(got, want)) if g != w]
        if bad:
            raise AssertionError(f"{label}: slabs {bad} hold other rows "
                                 f"than the single-process run")
        return "per slab"
    tot = lambda ds: (sum(d[0] for d in ds),  # noqa: E731
                      sum(d[2] for d in ds) % (1 << 64))
    if tot(got) != tot(want):
        raise AssertionError(f"{label}: the union of the slabs differs from "
                             f"the single-process run's")
    return "union"


# the stated tolerance of a density from kernel 4 (the mxu deposit,
# float32 corner sums in another order) against its plain version or one
# device's; kernel 5's is held to the same
DEPOSIT_TOL = 2e-5


def verify(results, spec, ref, device_kind: str) -> dict:
    """Check the world's ``results`` (rank order) against ``ref``
    (:func:`reference`); raise ``AssertionError`` on any difference and
    return the summary of each part that ran: launches a step per rank,
    ms per step per rank, how the multisets were compared, the deposits'
    largest differences from the plain versions and one device's."""
    S = spec["steps"]
    n = spec["n_local"]
    parts = spec["parts"]
    total = int(np.load(os.path.join(spec["workdir"], "alive.npy")).sum())
    on_card = device_kind == "cuda"
    summary = {"backend": results[0]["backend"]}

    def check(cond, msg):
        if not cond:
            raise AssertionError(msg)

    def launches(label, got, want):
        if not on_card:
            check(not any(got.values()), f"{label}: a kernel launched on "
                                         f"the CPU")
            return
        for name, k in got.items():
            check(k == want.get(name, 0),
                  f"{label}: {name} launched {k} times, expected "
                  f"{want.get(name, 0)}")

    def state_ok(label, st):
        check(int(st["dropped_recv"].sum()) == 0, f"{label}: drops")
        check(int(st["population"][-1].sum()) == total,
              f"{label}: rows not conserved")
        check((st["sent"].sum(1) == st["received"].sum(1)).all(),
              f"{label}: sent != received")

    if "vranks" in parts:
        Wv = int(np.prod(spec["dev_grid"]))
        vr = [results[r]["vranks"] for r in range(Wv)]
        for r, x in enumerate(vr):
            launches(f"vranks rank {r}", x["launches"],
                     {"overlay_scatter_planar": S})
            check(x["owned"], f"vranks rank {r}: a row off its owner slab")
        state_ok("vranks", vr[0]["stats"])
        check(all(np.array_equal(x["stats"][k], vr[0]["stats"][k])
                  for x in vr for k in vr[0]["stats"]),
              "vranks: ranks disagree on stats")
        backlog = int(vr[0]["stats"]["backlog"].sum())
        cmp = _same_multisets("vranks", [d for x in vr for d in x["digests"]],
                              ref["digests"], [backlog, ref["backlog"]])
        summary["vranks"] = dict(
            ranks=Wv, vranks_a_rank=int(np.prod(spec["vgrid"])),
            slots=8 * n, steps=S, compared=cmp, backlog=backlog,
            kernel2_launches_a_step=[x["launches"].get(
                "overlay_scatter_planar", 0) / S for x in vr],
            kernel1_launches=[x["launches"].get("drift_wrap_bin", 0)
                              for x in vr],
            ms_per_step=[x["ms_per_step"] for x in vr],
            raw_ms_per_step=[x["raw_ms_per_step"] for x in vr],
            profile=[x.get("profile") for x in vr])

    if "flat" in parts:
        fl = [results[r]["flat"] for r in range(8)]
        errs = {"loop_vs_plain": {}, "vs_plain": {}, "vs_one_device": {}}
        for r, x in enumerate(fl):
            launches(f"flat rank {r} (mxu)", x["mxu"]["launches"],
                     {"overlay_scatter_planar": S, "segsum_sorted": S})
            k = x["scan"]["steps"]
            launches(f"flat rank {r} (scan)", x["scan"]["launches"],
                     {"overlay_scatter_planar": k, "tile_df_cumsum_rows": k})
            check(x["owned"], f"flat rank {r}: a row off its owner")
        state_ok("flat", fl[0]["stats"])
        backlog_f = int(fl[0]["stats"]["backlog"].sum())
        cmp_f = _same_multisets("flat", [d for x in fl for d in x["digests"]],
                                ref["digests"], [backlog_f, ref["backlog"]])
        rho_sum = sum(x["mxu"]["rho_sum"] for x in fl)
        check(abs(rho_sum - total) <= 1e-5 * total,
              f"flat: the mxu density holds {rho_sum} of {total} rows' mass")
        for method in ("mxu", "scan"):
            for r, x in enumerate(fl):
                check(x[method]["state_equals_plain"],
                      f"flat loop ({method}) rank {r}: state differs from "
                      f"the plain loop's")
            err = max(x[method]["rho_err_vs_plain"] for x in fl)
            check(err <= DEPOSIT_TOL, f"flat loop ({method}): density "
                                      f"{err} from the plain loop's")
            errs["loop_vs_plain"][method] = err
            blocks = split_grid(ref["rho"][method], GRID)
            one = plain = 0.0
            for r, x in enumerate(fl):
                d = x[f"deposit_{method}"]
                one = max(one, float(np.abs(d["rho"] - blocks[r]).max()))
                plain = max(plain, d["err_vs_plain"])
                launches(f"deposit {method} rank {r}", d["launches"],
                         {"segsum_sorted" if method == "mxu"
                          else "tile_df_cumsum_rows": 1})
            check(plain <= DEPOSIT_TOL, f"deposit {method} across ranks: "
                                        f"{plain} from its plain version")
            check(one <= DEPOSIT_TOL, f"deposit {method} across ranks: {one} "
                                      f"from one device's plain density")
            errs["vs_plain"][method] = plain
            errs["vs_one_device"][method] = one
        summary["flat"] = dict(
            ranks=8, slots=8 * n, steps=S, compared=cmp_f, backlog=backlog_f,
            kernel2_launches_a_step=[x["mxu"]["launches"].get(
                "overlay_scatter_planar", 0) / S for x in fl],
            kernel4_launches_a_step=[x["mxu"]["launches"].get(
                "segsum_sorted", 0) / S for x in fl],
            kernel5_launches_a_step=[x["scan"]["launches"].get(
                "tile_df_cumsum_rows", 0) / x["scan"]["steps"] for x in fl],
            ms_per_step_mxu=[x["mxu"]["ms_per_step"] for x in fl],
            raw_ms_per_step_mxu=[x["mxu"]["raw_ms_per_step"] for x in fl],
            ms_per_step_scan=[x["scan"]["ms_per_step"] for x in fl],
            deposit_max_abs_err=errs,
            deposit_ms={m: [x[f"deposit_{m}"]["ms"] for x in fl]
                        for m in ("mxu", "scan")},
            profile_mxu=[x.get("profile") for x in fl])

    if "drift" in parts:
        dr = [results[r]["drift"] for r in range(8)]
        total_in = sum(x["count_in"] for x in dr)
        blocks = split_grid(ref["drift_rho"], GRID)
        errs = {}
        for method in ("mxu", "scan"):
            kernel = ("segsum_sorted" if method == "mxu"
                      else "tile_df_cumsum_rows")
            one = 0.0
            for r, x in enumerate(dr):
                y = x[method]
                launches(f"drift rank {r} ({method})", y["launches"],
                         {kernel: DRIFT_STEPS})
                check(y["state_equals_plain"], f"drift ({method}) rank {r}: "
                      f"state differs from the plain loop's")
                check(method != "scan" or y["rho_equals_plain"],
                      f"drift (scan) rank {r}: density differs from the "
                      f"plain loop's")
                check(y["rho_err_vs_plain"] <= DEPOSIT_TOL,
                      f"drift ({method}) rank {r}: density "
                      f"{y['rho_err_vs_plain']} from the plain loop's")
                check(y["owned"] and y["finite"], f"drift ({method}) rank "
                      f"{r}: a row off its owner, or not finite")
                check(all(np.array_equal(y["stats"][k],
                                         dr[0][method]["stats"][k])
                          for k in y["stats"]),
                      f"drift ({method}): ranks disagree on stats")
                one = max(one, float(np.abs(y["rho"] - blocks[r]).max()))
            st = dr[0][method]["stats"]
            check(int(st["dropped_send"].sum()) == 0
                  and int(st["dropped_recv"].sum()) == 0,
                  f"drift ({method}): rows dropped")
            check(sum(x[method]["count"] for x in dr) == total_in,
                  f"drift ({method}): rows not conserved")
            check(one <= DEPOSIT_TOL, f"drift ({method}): density {one} "
                                      f"from one process's plain density")
            errs[method] = dict(vs_plain=max(x[method]["rho_err_vs_plain"]
                                             for x in dr), vs_one=one)
        summary["drift"] = dict(
            ranks=8, rows=total_in, steps=DRIFT_STEPS,
            ms_per_step={m: [x[m]["ms_per_step"] for x in dr]
                         for m in ("mxu", "scan")},
            raw_ms_per_step={m: [x[m]["raw_ms_per_step"] for x in dr]
                             for m in ("mxu", "scan")},
            kernel4_launches_a_step=[x["mxu"]["launches"].get(
                "segsum_sorted", 0) / DRIFT_STEPS for x in dr],
            kernel5_launches_a_step=[x["scan"]["launches"].get(
                "tile_df_cumsum_rows", 0) / DRIFT_STEPS for x in dr],
            deposit_max_abs_err=errs)

    if "halo" in parts:
        hl = [results[r]["halo"] for r in range(8)]
        hr = ref["halo"]
        for engine in ("auto", "rowmajor"):
            for r, x in enumerate(hl):
                y = x[engine]
                check(np.array_equal(y["ghost_count"], hr["gcount"]),
                      f"halo ({engine}) rank {r}: ghost counts differ from "
                      f"the vrank engine's")
                check(not y["overflow"].any(), f"halo ({engine}): overflow")
                check(y["digest"] == hr["digest"][engine][r],
                      f"halo ({engine}) rank {r}: ghosts differ from the "
                      f"vrank engine's")
        summary["halo"] = dict(
            ranks=8, rows_a_rank=spec["halo_n"], width=hl[0]["width"],
            ghosts=int(hr["gcount"].sum()),
            ghost_capacity=hl[0]["auto"]["ghost_capacity"],
            ms={e: [x[e]["ms"] for x in hl] for e in ("auto", "rowmajor")})

    W = len(results)
    o = _oracle_shards(ref["oracle"], W)
    for engine in ("auto", "planar"):
        for r, x in enumerate(results):
            got = x["redistribute"][engine]
            check(_same_shard(got, o, r),
                  f"GridRedistribute(mesh=, engine={engine!r}) rank {r} "
                  f"differs from the oracle")
            for f in ("send_counts", "recv_counts", "dropped_send",
                      "dropped_recv", "needed_capacity"):
                check(np.array_equal(got["stats"][f], o["stats"][f]),
                      f"GridRedistribute(mesh=, engine={engine!r}) stat {f}")
        resolved = results[0]["redistribute"][engine]["engine"]
        check(resolved == ("sparse" if engine == "auto" else "planar"),
              f"engine {engine!r} resolved to {resolved!r}")
    summary["redistribute"] = dict(
        ranks=W, grid=tuple(spec["world_grid"]), rows=spec["config1_n"],
        ms={e: [x["redistribute"][e]["ms"] for x in results]
            for e in ("auto", "planar")})

    if "hier" in parts:
        for r, x in enumerate(results):
            got = x["hier"]
            check(got["engine"] == "hierarchical",
                  f"hier: 'auto' resolved to {got['engine']!r}")
            check(_same_shard(got, o, r), f"hier rank {r}: differs from "
                                          f"the oracle")
            planar = x["redistribute"]["planar"]
            check(_same_tree([got[k] for k in ("positions", "fields",
                                               "count")],
                             [planar[k] for k in ("positions", "fields",
                                                  "count")]),
                  f"hier rank {r}: differs from the planar engine")
            for f in ("send_counts", "recv_counts", "dropped_send",
                      "dropped_recv", "needed_capacity"):
                check(np.array_equal(got["stats"][f], o["stats"][f]),
                      f"hier stat {f}")
        summary["hier"] = dict(
            ranks=W, dcn_shape=DCN_SHAPE,
            n_pods=results[0]["hier"]["n_pods"],
            cross_cap=results[0]["hier"]["cross_cap"],
            mover_cap=results[0]["hier"]["mover_cap"],
            fallback=results[0]["hier"]["fallback"],
            ms=[x["hier"]["ms"] for x in results])

    if on_card and "card_vs_cpu" in parts:
        cv = [results[r]["card_vs_cpu"] for r in range(2)]
        loops = ("scan", "mxu")
        for r, x in enumerate(cv):
            for method in loops:
                y = x[method]
                # kernel 4 adds in another order than its plain version:
                # the mxu density is held to the stated tolerance
                bad = [k for k, ok in y["same"].items()
                       if not ok and not (method == "mxu" and k == "rho")]
                check(not bad, f"card vs CPU ({method}) rank {r}: {bad} "
                               f"differ")
                check(y["rho_err"] <= DEPOSIT_TOL,
                      f"card vs CPU ({method}) rank {r}: density "
                      f"{y['rho_err']} apart")
                check(y["moved"] > 0, "card vs CPU: no row moved")
            sl = x["slice"]
            bad = [k for k, ok in sl["same"].items() if not ok]
            check(not bad, f"card vs CPU (drift step, halo, hierarchical) "
                           f"rank {r}: {bad} differ")
            launches(f"card vs CPU drift step rank {r}", sl["launches"],
                     {"tile_df_cumsum_rows": 1})
            check(sl["hier_engine"] == "hierarchical",
                  f"card vs CPU: hierarchical ran {sl['hier_engine']!r}")
            check(sl["moved"] > 0 and sl["ghosts"] > 0,
                  "card vs CPU: no row moved or no ghost")
        summary["card_vs_cpu"] = dict(
            ranks=2, n_local=SMALL_N,
            bit_equal={m: sorted(k for k, ok in cv[0][m]["same"].items()
                                 if ok and all(x[m]["same"][k] for x in cv))
                       for m in loops + ("slice",)},
            rho_max_abs_err={m: max(x[m]["rho_err"] for x in cv)
                             for m in loops})
    return summary


def small_loop(ctx):
    """One step of the small width's loop on this rank of a 2-rank world
    (dev grid (2, 1, 1) x vgrid (1, 2, 2), the scan deposit each step) on
    the rank's device, from the small state drawn here: ``(pos, vel,
    alive, stats, rho)`` as numpy, the kernel launches, every collective
    once, and :func:`_slice_small` of the same rows (a drift step with its
    scan deposit, a halo with each engine, a hierarchical call)."""
    import torch

    from mpi_grid_redistribute_tpu_torch.bench import common
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.models import nbody
    from mpi_grid_redistribute_tpu_torch.ops import _build

    n_local = SMALL_N
    v, cap, budget = common.drift_sizing(GRID, n_local, 0.9, 0.02)
    pos, vel, alive = common.uniform_state(
        GRID, n_local, 0.9, np.random.default_rng(1), vel_scale=4 * v)
    pos, vel, alive = (split_rows(a, 2)[ctx.rank] for a in (pos, vel, alive))
    cfg = nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True), grid=ProcessGrid(DEV_GRID),
        dt=1.0, capacity=cap, n_local=n_local, local_budget=budget,
        deposit_shape=SMALL_DEPOSIT_SHAPE, deposit_method="scan")
    loop = nbody.make_migrate_loop(cfg, 1, vgrid=ProcessGrid(VGRID),
                                   device=ctx.device, deposit_each_step=True)
    res, launches, _ = _counted(torch, _build, ctx.device,
                                lambda: loop(pos, vel, alive))
    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib

    pair = mesh_lib.make_mesh(ProcessGrid(DEV_GRID))
    return (tuple(x.cpu().numpy() for x in res[:3]), _stats_np(res[3]),
            res[4].cpu().numpy(), launches, _each_collective(ctx),
            _slice_small(*_live_first(pos, vel, alive), pair, ctx.device))


def _each_collective(ctx) -> dict:
    """Every collective of ``parallel.collectives`` once on this rank's
    device (the four backend operations beneath them included), as
    numpy."""
    import torch

    from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid
    from mpi_grid_redistribute_tpu_torch.parallel import collectives as col
    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(ProcessGrid((ctx.world_size,)))
    me, R = mesh.rank, mesh.size
    dev = ctx.device
    x = torch.arange(3 * R, dtype=torch.int32, device=dev) + 100 * me
    f = torch.tensor([0.1 * (me + 1), -2.5 ** me], device=dev)
    out = {
        "all_to_all": col.all_to_all(x, mesh),
        "all_to_all_int16": col.all_to_all(x.to(torch.int16), mesh),
        "all_gather": col.all_gather(x, mesh),
        "psum": col.psum(x, mesh),
        "psum_ordered": col.psum_ordered(f, mesh),
        "pmin": col.pmin(x, mesh),
        "broadcast": col.broadcast(x, mesh, src=R - 1),
        "ppermute": col.ppermute(x, mesh, [(i, (i + 1) % R)
                                           for i in range(R)]),
    }
    return {k: v.cpu().numpy() for k, v in out.items()}


# the bench grid on 4 cards, one rank a card: 4 ranks x 2 vranks
CARDS_DEV_GRID = (2, 2, 1)
CARDS_VGRID = (1, 1, 2)


def main(argv=None) -> int:
    """``python -m mpi_grid_redistribute_tpu_torch.bench.multirank
    [--backend nccl] [--device cuda] [--n-local N] [--profile DIR]``: the
    bench grid on 4 ranks, one card each (dev grid (2, 2, 1) x vgrid (1,
    1, 2), and ``GridRedistribute(mesh=)`` over (2, 2, 1): the planar and
    sparse engines, and the hierarchical one over two pods of two cards),
    held against the one-process 8-vrank run and the oracle; prints one
    JSON line. Needs 4 cards with ``--device cuda``."""
    import argparse
    import json
    import subprocess
    import tempfile

    import torch

    from mpi_grid_redistribute_tpu_torch.parallel import launch

    ap = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-local", type=int, default=1 << 20)
    ap.add_argument("--profile", default=None,
                    help="profile the loop; rank 0's op table goes to DIR")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as wd:
        spec = prepare(wd, args.n_local, dev_grid=CARDS_DEV_GRID,
                       vgrid=CARDS_VGRID, world_grid=CARDS_DEV_GRID,
                       parts=("vranks", "hier"))
        spec["profile"] = bool(args.profile)
        spec["profile_dir"] = args.profile
        t0 = time.perf_counter()
        results = launch.run_world(
            "mpi_grid_redistribute_tpu_torch.bench.multirank:world_main", 4,
            args=(spec,), backend=args.backend, device=args.device,
            timeout=900, pg_timeout=600)
        world_s = time.perf_counter() - t0
        summary = verify(results, spec, reference(spec, args.device),
                         args.device)
    card = None
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
    print(json.dumps(dict(summary, world_seconds=world_s, cards=card,
                          torch=torch.__version__)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
