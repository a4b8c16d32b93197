"""Per-rank case runners for the multi-rank tests, and the shared world
fixture helper.

The runners run inside the ranks that ``parallel.launch.run_world`` starts,
so this module imports the port and nothing of JAX or of the JAX package:
every rank is a fresh interpreter that imports only it. Inputs are made
here from fixed seeds with NumPy, so the test (which runs the JAX package
on the same inputs) and the ranks build the same arrays.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import os
import pickle
import sys
from typing import NamedTuple

import numpy as np

from mpi_grid_redistribute_tpu_torch.convert import split_rows

# (shape, periodic, mover_cap, n_local, cap, out_cap, drift), the cases of
# the JAX package's count-driven exchange test
EXCHANGE_CASES = {
    "g222-drift": ((2, 2, 2), (True,) * 3, 16, 120, 60, 300, 0.01),
    "g222-zero": ((2, 2, 2), (True,) * 3, 8, 120, 60, 300, 0.0),
    "g421-nonperiodic": ((4, 2, 1), (False,) * 3, 16, 100, 64, 300, 0.008),
    "g222-reshuffle": ((2, 2, 2), (True,) * 3, 2, 120, 100, 400, 0.45),
}


def shared_world(tmp_path_factory, key: str, target: str, world_size: int,
                 args=(), timeout: float = 240.0, pg_timeout: float = 60.0):
    """Run a world once per test session, whichever xdist worker asks
    first, and hand every caller its pickled results: the first caller
    runs it under a file lock in the session's shared temporary root,
    the others wait on the lock and read the file."""
    from mpi_grid_redistribute_tpu_torch.parallel import launch

    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / f"world_{key}.pkl"
    with open(base / f"world_{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                with open(path, "rb") as f:
                    status, payload = pickle.load(f)
            else:
                try:
                    status, payload = "ok", launch.run_world(
                        target, world_size, args=args, device="cpu",
                        timeout=timeout, pg_timeout=pg_timeout)
                except launch.RankFailed as err:
                    status, payload = "error", str(err)
                with open(path, "wb") as f:
                    pickle.dump((status, payload), f)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if status == "error":
        raise launch.RankFailed(payload)
    return payload


# ------------------------------------------------------------- exchange


def exchange_inputs(name: str, K: int = 7):
    """``(grid shape, periodic, fused [R, K, n] float32, count [R])``:
    shard-local particles plus a gaussian drift."""
    shape, periodic, _, n_local, _, _, drift = EXCHANGE_CASES[name]
    rng = np.random.default_rng(list(EXCHANGE_CASES).index(name) + 71)
    R = int(np.prod(shape))
    strides = np.cumprod((1,) + shape[::-1])[:-1][::-1]
    pos = np.empty((R, 3, n_local), np.float32)
    for r in range(R):
        cell = [(r // s) % g for s, g in zip(strides, shape)]
        for a in range(3):
            pos[r, a] = (cell[a] + rng.random(n_local)) / shape[a]
    pos = pos + rng.normal(0, drift, size=pos.shape).astype(np.float32)
    pos = np.mod(pos, 1.0).astype(np.float32)
    other = rng.standard_normal((R, K - 3, n_local)).astype(np.float32)
    fused = np.concatenate([pos, other], axis=1)
    count = rng.integers(n_local // 2, n_local + 1, size=R).astype(np.int32)
    return shape, periodic, fused, count


def rows_inputs(R: int, n_local: int, drift: float, seed: int,
                clustered: bool = False):
    """``(pos [R * n, 3] float32, vel [R * n, 3] float32, ids [R * n]
    int32, tag [R * n] int16)`` rows for a 2x2x2 grid: uniform, or with
    ``clustered`` most rows packed into one corner (forces the capacity
    rebuild)."""
    rng = np.random.default_rng(seed)
    pos = rng.random((R * n_local, 3))
    if clustered:
        pos = np.where(rng.random((R * n_local, 1)) < 0.8, pos * 0.3, pos)
    pos = np.mod(pos + rng.normal(0, drift, pos.shape), 1.0).astype(
        np.float32)
    vel = rng.standard_normal((R * n_local, 3)).astype(np.float32)
    ids = np.arange(R * n_local, dtype=np.int32)
    tag = rng.integers(-3000, 3000, R * n_local).astype(np.int16)
    return pos, vel, ids, tag


def _np(x):
    return None if x is None else x.detach().cpu().numpy()


def _stats_np(stats):
    return {k: _np(v) for k, v in stats._asdict().items() if v is not None}


class Wire(NamedTuple):
    """One ``torch.distributed`` call as this rank made it: the function
    (``op``) and the elements it sent to (``sent``) and received from
    (``recv``) each rank of the call's group, ranks with none left out."""

    op: str
    sent: dict
    recv: dict


def _per_rank(t, splits, size: int) -> dict:
    if splits is None:  # equal chunks along dim 0
        return {r: t.numel() // size for r in range(size) if t.numel()}
    row = int(np.prod(tuple(t.shape[1:]), dtype=np.int64))
    return {r: int(s) * row for r, s in enumerate(splits) if s}


@contextlib.contextmanager
def wire_recording():
    """Record a :class:`Wire` for every ``all_to_all_single``,
    ``all_gather``, ``all_reduce`` and ``broadcast`` this rank makes inside
    the block (the four calls ``parallel.collectives`` is built from),
    read off the tensors and split sizes the call is given."""
    import torch.distributed as dist

    records = []
    real = {op: getattr(dist, op) for op in (
        "all_to_all_single", "all_gather", "all_reduce", "broadcast")}

    def all_to_all_single(output, input, output_split_sizes=None,
                          input_split_sizes=None, group=None, **kw):
        size = dist.get_world_size(group)
        records.append(Wire("all_to_all_single",
                            _per_rank(input, input_split_sizes, size),
                            _per_rank(output, output_split_sizes, size)))
        return real["all_to_all_single"](
            output, input, output_split_sizes, input_split_sizes,
            group=group, **kw)

    def all_gather(tensor_list, tensor, group=None, **kw):
        records.append(Wire(
            "all_gather",
            {r: tensor.numel() for r in range(len(tensor_list))},
            {r: t.numel() for r, t in enumerate(tensor_list)}))
        return real["all_gather"](tensor_list, tensor, group=group, **kw)

    def all_reduce(tensor, *args, group=None, **kw):
        every = {r: tensor.numel()
                 for r in range(dist.get_world_size(group))}
        records.append(Wire("all_reduce", every, dict(every)))
        return real["all_reduce"](tensor, *args, group=group, **kw)

    def broadcast(tensor, src, group=None, **kw):
        me = dist.get_rank()
        root = src if group is None else dist.get_group_rank(group, src)
        records.append(Wire(
            "broadcast",
            {r: tensor.numel() for r in range(dist.get_world_size(group))}
            if me == src else {},
            {} if me == src else {root: tensor.numel()}))
        return real["broadcast"](tensor, src, group=group, **kw)

    patched = dict(all_to_all_single=all_to_all_single,
                   all_gather=all_gather, all_reduce=all_reduce,
                   broadcast=broadcast)
    for op, fn in patched.items():
        setattr(dist, op, fn)
    try:
        yield records
    finally:
        for op, fn in real.items():
            setattr(dist, op, fn)


def run_exchange(ctx):
    """Every exchange case on this rank: the planar, row-major, sparse and
    neighbor engines and ``GridRedistribute(mesh=)``; returns
    ``{key: numpy results}``."""
    import torch

    from mpi_grid_redistribute_tpu_torch import api
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.parallel import exchange
    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib

    r = ctx.rank
    out = {}
    for name, (shape, periodic, B, n, cap, out_cap, _) in (
            EXCHANGE_CASES.items()):
        _, _, fused, count = exchange_inputs(name)
        grid = ProcessGrid(shape)
        dom = Domain((0.0,) * 3, (1.0,) * 3, periodic)
        mesh = mesh_lib.make_mesh(grid)
        # the reference's lane-sharded [K, R * n] as rank r's [K, n]
        f = torch.from_numpy(fused[r].copy())
        c = torch.from_numpy(split_rows(count, len(count))[r])
        res = exchange.shard_redistribute_planar_sharded(
            mesh, dom, grid, cap, out_cap, 3)(f, c)
        out[(name, "planar")] = (_np(res[0]), _np(res[1]), _stats_np(res[2]))
        # the per-rank function itself: this rank's rows of the stats
        res = exchange.shard_redistribute_planar_fn(dom, grid, cap, out_cap,
                                                    3, mesh=mesh)(f, c)
        out[(name, "planar-rows")] = _stats_np(res[2])
        for eng in exchange.COUNT_DRIVEN_ENGINES:
            res = exchange.shard_redistribute_count_driven_sharded(
                mesh, dom, grid, cap, out_cap, B, 3, engine=eng)(f, c)
            out[(name, eng)] = (_np(res[0]), _np(res[1]), _stats_np(res[2]))
        # row-major: positions + an int16 field ride as words of their width
        pos = f[:3].T.contiguous()
        rest = f[3:].T.contiguous()
        tag = torch.from_numpy(
            (np.arange(n, dtype=np.int16) * (r + 3)).astype(np.int16))
        res = exchange.build_redistribute(mesh, dom, grid, cap, out_cap,
                                          2)(pos, c, rest, tag)
        out[(name, "rowmajor")] = (tuple(_np(a) for a in res[:-1]),
                                   _stats_np(res[-1]))

    # the public API on the 2x2x2 mesh
    grid = ProcessGrid((2, 2, 2))
    mesh = mesh_lib.make_mesh(grid)
    n = 96
    for key, drift, clustered, kw in (
        ("auto", 0.02, False, dict()),
        ("planar", 0.02, False, dict(engine="planar")),
        ("neighbor", 0.02, False, dict(engine="neighbor")),
        ("grow", 0.0, True, dict(capacity_factor=1.0)),
        ("sparse-fallback", 0.45, False,
         dict(engine="sparse", mover_cap=1, capacity=96, out_capacity=256,
              on_overflow="ignore")),
        ("sparse-ratchet", 0.05, False,
         dict(engine="sparse", mover_cap=1, capacity=96, out_capacity=256)),
    ):
        pos, vel, ids, tag = (split_rows(a, 8)[r] for a in rows_inputs(
            8, n, drift, 5, clustered))
        rd = api.GridRedistribute(
            grid=(2, 2, 2), lo=(0.0,) * 3, hi=(1.0,) * 3,
            periodic=(True,) * 3, device="cpu", mesh=mesh, **kw)
        res = rd.redistribute(pos, vel, ids)
        out[("api", key)] = (
            _np(res.positions), tuple(_np(a) for a in res.fields),
            _np(res.count), _stats_np(res.stats),
            dict(capacity=rd.capacity, out_capacity=rd.out_capacity,
                 mover_cap=rd._mover_cap, engine=rd._last_wire["engine"],
                 fetches=rd._blocking_fetches))
        out[("api-telemetry", key)] = telemetry_views(rd)
    # the functional forms and engine_fn on the mesh
    pos, vel, ids, _ = rows_inputs(8, n, 0.02, 7)
    mine = [split_rows(a, 8)[r] for a in (pos, vel, ids)]
    kw = dict(domain=Domain(0.0, 1.0, periodic=True), grid=(2, 2, 2),
              device="cpu", mesh=mesh)
    res = api.redistribute(*mine, **kw)
    out[("api", "functional")] = (_np(res.positions), _np(res.count),
                                  _stats_np(res.stats))
    live = pos[: 8 * n - 37]  # unpadded live rows, the same on every rank
    res = api.reshard(live, ids[: 8 * n - 37], n_local=n + 32,
                      backend="torch", **kw)
    out[("api", "reshard")] = (_np(res.positions), _np(res.fields[0]),
                               _np(res.count), _stats_np(res.stats))
    rd = api.GridRedistribute(grid=(2, 2, 2), lo=0.0, hi=1.0, periodic=True,
                              device="cpu", mesh=mesh)
    p_r, v_r = torch.from_numpy(mine[0]), torch.from_numpy(mine[1])
    fn, cap, out_cap = rd.engine_fn(p_r, v_r)
    res = fn(p_r, torch.tensor([n]), v_r)
    out[("api", "engine_fn")] = (_np(res[0]), _np(res[1]), cap, out_cap,
                                 rd._last_wire["engine"])
    # what this interpreter imported: the port, never JAX
    out[("imports",)] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "mpi_grid_redistribute_tpu"))
    # the mesh and the collectives themselves
    for shape in ((2, 2, 2), (4, 2, 1), (1, 2, 4), (8, 1, 1)):
        m = mesh_lib.make_mesh(ProcessGrid(shape))
        out[("mesh", shape)] = (m.rank, m.coords, m.size, m.backend)
    out[("collectives",)] = _collectives(mesh)
    # a non-32-bit field: "auto" takes the row-major engine
    pos, _, _, tag = (split_rows(a, 8)[r] for a in rows_inputs(
        8, n, 0.02, 6))
    rd = api.GridRedistribute(
        grid=(2, 2, 2), lo=(0.0,) * 3, hi=(1.0,) * 3, periodic=(True,) * 3,
        device="cpu", mesh=mesh)
    res = rd.redistribute(pos, tag)
    out[("api", "rowmajor")] = (
        _np(res.positions), tuple(_np(a) for a in res.fields),
        _np(res.count), _stats_np(res.stats),
        dict(out_capacity=rd.out_capacity, engine=rd._last_wire["engine"]))
    return out


def telemetry_views(rd):
    """What an instance's telemetry shows after its calls: the journal
    (kind and payload, without the random trace id), ``report()`` at 1 ms
    a step, ``flow()``, ``health()`` and the rendered ``metrics()``."""
    journal = [(e.kind, {k: v for k, v in e.data.items() if k != "trace"})
               for e in rd.telemetry.events()]
    flow = rd.flow(k=3)
    return dict(journal=journal, report=rd.report(step_seconds=1e-3),
                flow=dict(flow, matrix=np.asarray(flow["matrix"])),
                health=rd.health(), metrics=rd.metrics(render=True))


def _collectives(mesh):
    import torch

    from mpi_grid_redistribute_tpu_torch.parallel import collectives as col

    me = mesh.rank
    R = mesh.size
    x = torch.arange(R * 3, dtype=torch.int32) + 100 * me
    y = (torch.arange(2 * R * 2, dtype=torch.int16).reshape(2, R * 2)
         + 1000 * me).to(torch.int16)
    f = torch.tensor([0.1 * (me + 1), -2.5 ** me], dtype=torch.float32)
    ring = [(i, (i + 1) % R) for i in range(R - 1)]
    return dict(
        all_to_all=_np(col.all_to_all(x, mesh)),
        all_to_all_dim1=_np(col.all_to_all(y, mesh, dim=1)),
        all_gather=_np(col.all_gather(torch.tensor([me, -me]), mesh)),
        psum=_np(col.psum(torch.tensor([me, 1]), mesh)),
        psum_ordered=_np(col.psum_ordered(f, mesh)),
        pmin=_np(col.pmin(torch.tensor([me + 5]), mesh)),
        ppermute=_np(col.ppermute(torch.full((2, 2), float(me)), mesh,
                                  ring)),
        broadcast=_np(col.broadcast(torch.tensor([me * 7]), mesh, src=R - 1)),
        axis_index=col.axis_index(mesh),
    )


def fail_or_hang(ctx, mode: str):
    """A world with a faulty rank: ``"raise"`` (rank 1 raises) or
    ``"hang"`` (rank 1 never reaches the collective rank 0 waits in)."""
    import time

    import torch
    import torch.distributed as dist

    if ctx.rank == 1:
        if mode == "raise":
            raise ValueError("rank 1 fails on purpose")
        time.sleep(120)
    t = torch.ones(1)
    dist.all_reduce(t)
    return float(t)


# -------------------------------------------------------- migrate loop

# name: (dev grid, vgrid or None, n_local, capacity, dt, steps, start,
#        extra config).  ``start``: "legal" (live rows on their owner,
#        ~1/8 holes), "random" (random fill, not legal), "lossless" (a
#        nearly full remote slab), "cycle3" (a 3-cycle of full ranks),
#        "xcycle" (a full 3-cycle spanning two devices).  dt is a power
#        of two (or 0): the reference's jitted drift may fuse p + v*dt on
#        the CPU, and v*dt is exact for a power of two, so both round once.
MIGRATE_CASES = {
    "flat-222": ((2, 2, 2), None, 64, 64, 0.0625, 5, "legal", {}),
    "flat-421": ((4, 2, 1), None, 64, 64, 0.0625, 5, "legal", {}),
    "flat-cycle3": ((3, 1, 1), None, 6, 6, 0.0, 6, "cycle3", {}),
    "vr-221x122": ((2, 2, 1), (1, 2, 2), 64, 64, 0.0625, 5, "legal", {}),
    "vr-211x221": ((2, 1, 1), (2, 2, 1), 64, 64, 0.0625, 5, "legal", {}),
    "vr-lossless": ((2, 1, 1), (1, 2, 1), 32, 32, 1.0, 1, "lossless", {}),
    "vr-xcycle": ((2, 1, 1), (2, 1, 1), 8, 8, 0.0, 10, "xcycle", {}),
    "vr-budget": ((2, 1, 1), (2, 2, 1), 48, 4, 0.25, 6, "random",
                  dict(local_budget=24)),
}
for _seed in range(3):
    MIGRATE_CASES[f"flat-pressure{_seed}"] = (
        (2, 2, 2), None, 24 + 16 * _seed, 2 + 3 * _seed, 0.25, 6, "random",
        {})
    MIGRATE_CASES[f"vr-pressure{_seed}"] = (
        (2, 1, 1), (2, 2, 1), 24 + 16 * _seed, 2 + 3 * _seed, 0.25, 6,
        "random", dict(local_budget=8 + 20 * _seed))
# the loop with its deposit each step: (method, deposit_shape)
DEPOSIT_LOOP_CASES = {
    "vr-221x122-scan": ("vr-221x122", "scan", (8, 8, 8)),
    "vr-221x122-mxu": ("vr-221x122", "mxu", (8, 8, 8)),
    "vr-211x221-segment": ("vr-211x221", "segment", (8, 8, 8)),
    "flat-222-segment": ("flat-222", "segment", (8, 8, 8)),
    "flat-222-scan": ("flat-222", "scan", (8, 8, 8)),
}


# make_migrate_step on the flat 2x2x2 case: (key, dt, deposit)
STEP_CASES = (
    ("dt0", 0.0, None),
    ("drift", 0.0625, None),
    ("drift-scan", 0.0625, ("scan", (8, 8, 8))),
    ("drift-segment", 0.0625, ("segment", (8, 8, 8))),
)


def _full_grid(dev_shape, v_shape):
    return tuple(d * v for d, v in zip(dev_shape, v_shape or (1,) * 3))


def slab_ranks(dev_shape, v_shape):
    """Full-grid rank of each (device, vrank) slab, device-major."""
    from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid

    v_shape = v_shape or (1,) * len(dev_shape)
    dev, vg = ProcessGrid(dev_shape), ProcessGrid(v_shape)
    full = ProcessGrid(_full_grid(dev_shape, v_shape))
    out = []
    for d in range(dev.nranks):
        dc = dev.cell_of_rank(d)
        for v in range(vg.nranks):
            vc = vg.cell_of_rank(v)
            out.append(full.rank_of_cell(tuple(
                dc[a] * v_shape[a] + vc[a] for a in range(len(dc)))))
    return np.asarray(out)


def migrate_inputs(name: str):
    """``(pos [N, 3], vel [N, 3], alive [N])`` float32/bool rows of a case,
    device-major slabs of ``n_local`` rows."""
    from mpi_grid_redistribute_tpu_torch import oracle
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid

    dev_shape, v_shape, n_local, _, _, _, start, _ = MIGRATE_CASES[name]
    rng = np.random.default_rng(list(MIGRATE_CASES).index(name) + 500)
    slabs = slab_ranks(dev_shape, v_shape)
    S = len(slabs)
    n = S * n_local
    dom = Domain(0.0, 1.0, periodic=True)
    if start in ("legal", "random"):
        pos = rng.random((n, 3), dtype=np.float32)
        vel = (0.6 * (rng.random((n, 3), dtype=np.float32) - 0.5)).astype(
            np.float32)
        if start == "random":
            alive = rng.random(n) < rng.uniform(0.3, 1.0)
        else:
            full = ProcessGrid(_full_grid(dev_shape, v_shape))
            dest = oracle.rank_of_position(pos, dom, full)
            alive = (rng.random(n) > 0.125) & (
                dest == np.repeat(slabs, n_local))
        return pos, vel, alive
    vel = np.zeros((n, 3), np.float32)
    alive = np.ones((n,), bool)
    if start == "lossless":
        # slab 2 (device 1) full but for 4 holes; slab 0's movers aim at it
        pos = np.zeros((n, 3), np.float32)
        m = n_local
        pos[:m] = rng.uniform(0.01, 0.45, (m, 3))
        vel[:m, 0] = 0.5
        pos[m:2 * m] = rng.uniform(0.01, 0.45, (m, 3))
        pos[m:2 * m, 1] += 0.5
        pos[2 * m:3 * m] = rng.uniform(0.55, 0.95, (m, 3))
        pos[2 * m:3 * m, 1] = (pos[2 * m:3 * m, 1] - 0.5) % 0.5
        alive[3 * m - 4:3 * m] = False
        pos[3 * m:] = rng.uniform(0.55, 0.95, (m, 3))
        return pos.astype(np.float32), vel, alive
    pos = rng.random((n, 3), dtype=np.float32)
    cycle = ({0: 1, 1: 2, 2: 0} if start == "cycle3" else {0: 2, 2: 3, 3: 0})
    for g in range(S):
        pos[g * n_local:(g + 1) * n_local, 0] = (cycle.get(g, g) + 0.5) / S
    return pos, vel, alive


def _subgroups(sizes):
    """One process group per world size a case needs (every rank takes
    part in creating each, as torch.distributed requires)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    return {k: (None if k == world else dist.new_group(list(range(k))))
            for k in sorted(set(sizes))}


def _loop_cfg(name, deposit=None):
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.models import nbody

    dev_shape, v_shape, n_local, cap, dt, steps, _, extra = (
        MIGRATE_CASES[name])
    kw = dict(extra)
    if deposit is not None:
        kw.update(deposit_method=deposit[0], deposit_shape=deposit[1])
    cfg = nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True), grid=ProcessGrid(dev_shape),
        dt=dt, capacity=cap, n_local=n_local, **kw)
    return cfg, (None if v_shape is None else ProcessGrid(v_shape)), steps


def run_migrate(ctx):
    """Every migrate-loop case on this rank (on a subgroup of the first
    ``Dev`` ranks), then the deposit cases; returns ``{key: numpy}``."""
    from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid
    from mpi_grid_redistribute_tpu_torch.models import nbody
    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib

    r = ctx.rank
    sizes = [int(np.prod(c[0])) for c in MIGRATE_CASES.values()]
    groups = _subgroups(sizes + [8])
    out = {}
    loops = [(k, c[0], None) for k, c in MIGRATE_CASES.items()] + [
        (k, MIGRATE_CASES[c[0]][0], (c[0], c[1], c[2]))
        for k, c in DEPOSIT_LOOP_CASES.items()]
    for key, dev_shape, dep in loops:
        base = key if dep is None else dep[0]
        Dev = int(np.prod(dev_shape))
        if r >= Dev:
            continue
        cfg, vgrid, steps = _loop_cfg(
            base, None if dep is None else dep[1:])
        mesh = mesh_lib.make_mesh(ProcessGrid(dev_shape), group=groups[Dev])
        mine = [split_rows(a, Dev)[r] for a in migrate_inputs(base)]
        loop = nbody.make_migrate_loop(
            cfg, steps, vgrid=vgrid, mesh=mesh, device="cpu",
            deposit_each_step=dep is not None)
        res = loop(*mine)
        out[key] = (
            tuple(_np(a) for a in res[:3]),
            {k: _np(v) for k, v in res[3]._asdict().items()
             if v is not None},
            None if dep is None else _np(res[4]),
        )
    # make_migrate_step: the flat engine, one step, row-major shards
    for key, dt, dep in STEP_CASES:
        cfg, _, _ = _loop_cfg("flat-222", dep)
        cfg = dataclasses.replace(cfg, dt=dt)
        mesh = mesh_lib.make_mesh(ProcessGrid((2, 2, 2)))
        mine = [split_rows(a, 8)[r] for a in migrate_inputs("flat-222")]
        res = nbody.make_migrate_step(cfg, mesh=mesh, device="cpu")(*mine)
        out[("step", key)] = (
            tuple(_np(a) for a in res[:3]),
            {k: _np(v) for k, v in res[3]._asdict().items()
             if v is not None},
            None if dep is None else _np(res[4]))
    out.update(_run_deposits(ctx, groups))
    return out


# ------------------------------------------------------------- deposit

# name: (grid, periodic, method, mesh_shape, n_local)
DEPOSIT_CASES = {
    "periodic-scan": ((2, 2, 2), True, "scan", (8, 8, 8), 300),
    "periodic-segment": ((2, 2, 2), True, "segment", (8, 8, 8), 300),
    "open-scan": ((2, 2, 2), False, "scan", (8, 8, 8), 300),
    "open-segment": ((2, 2, 2), False, "segment", (8, 8, 8), 300),
    "mixed-scan": ((2, 2, 2), (True, False, True), "scan", (8, 8, 8), 300),
    "mixed-424-scan": ((4, 2, 1), (False, True, False), "scan", (8, 4, 4),
                       200),
}
# the per-device deposits of the loop: (dev grid, vgrid, periodic,
# method, mesh_shape, n_local a vrank)
DEVICE_DEPOSIT_CASES = {
    "planar-scan": ((2, 2, 2), None, True, "scan", (8, 8, 8), 300),
    "planar-scan-open": ((2, 2, 2), None, False, "scan", (8, 8, 8), 300),
    "mxu-flat": ((2, 2, 2), None, True, "mxu", (8, 8, 8), 300),
    "mxu-slab": ((2, 1, 1), (1, 2, 2), True, "mxu", (8, 8, 8), 200),
    "vranks-scan": ((2, 1, 1), (1, 2, 2), True, "scan-vranks", (8, 8, 8),
                    200),
    "vranks-segment-open": ((2, 1, 1), (1, 2, 2), False, "segment-vranks",
                            (8, 8, 8), 200),
}


def deposit_inputs(seed: int, R: int, n_local: int, grid_shape):
    """``(pos [R*n, 3], mass [R*n], count [R])`` with each rank's rows in
    its own cell, a batch on the upper faces (ghost spill) and, for open
    axes, a few exactly on the domain bounds."""
    rng = np.random.default_rng(seed)
    strides = np.cumprod((1,) + tuple(grid_shape)[::-1])[:-1][::-1]
    pos = np.empty((R, n_local, 3), np.float32)
    for r in range(R):
        cell = [(r // s) % g for s, g in zip(strides, grid_shape)]
        for a in range(3):
            pos[r, :, a] = (cell[a] + rng.random(n_local)) / grid_shape[a]
    pos = pos.reshape(R * n_local, 3)
    pos[::17] = np.float32(0.999999)
    pos[5::29, 0] = np.float32(0.0)
    mass = rng.random(R * n_local).astype(np.float32)
    count = rng.integers(n_local // 2, n_local + 1, R).astype(np.int32)
    return pos, mass, count


def _run_deposits(ctx, groups):
    import torch

    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.ops import deposit
    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib

    r = ctx.rank
    out = {}
    for i, (name, (shape, periodic, method, ms, n)) in enumerate(
            DEPOSIT_CASES.items()):
        R = int(np.prod(shape))
        if r >= R:
            continue
        grid = ProcessGrid(shape)
        mesh = mesh_lib.make_mesh(grid, group=groups[R])
        pos, mass, count = (torch.from_numpy(split_rows(a, R)[r])
                            for a in deposit_inputs(900 + i, R, n, shape))
        fn, _ = deposit.shard_deposit_fn(
            Domain(0.0, 1.0, periodic=periodic), grid, ms, method=method,
            mesh=mesh)
        out[("dep", name)] = _np(fn(pos, mass, count))
    for i, (name, (shape, v_shape, periodic, method, ms, n)) in enumerate(
            DEVICE_DEPOSIT_CASES.items()):
        Dev = int(np.prod(shape))
        if r >= Dev:
            continue
        V = 1 if v_shape is None else int(np.prod(v_shape))
        dev_grid = ProcessGrid(shape)
        vgrid = None if v_shape is None else ProcessGrid(v_shape)
        mesh = mesh_lib.make_mesh(dev_grid, group=groups[Dev])
        dom = Domain(0.0, 1.0, periodic=periodic)
        p, m = (torch.from_numpy(split_rows(a, Dev)[r])
                for a in device_deposit_inputs(950 + i, name))
        valid = m > 0.05
        if method == "mxu":
            fn = deposit.shard_deposit_device_mxu_fn(dom, dev_grid, ms,
                                                     vgrid=vgrid, mesh=mesh)
            rho = fn(p.T.contiguous(), m, valid)
        elif method == "scan":
            fn = deposit.shard_deposit_device_planar_fn(dom, dev_grid, ms,
                                                        mesh=mesh)
            rho = fn(p.T.contiguous(), m, valid)
        else:
            fn = deposit.shard_deposit_vranks_fn(
                dom, dev_grid, vgrid, ms, method=method.split("-")[0],
                mesh=mesh)
            rho = fn(p.reshape(V, n, 3), m.reshape(V, n), valid.reshape(V, n))
        out[("devdep", name)] = _np(rho)
    return out


def device_deposit_inputs(seed: int, name: str):
    """``(pos [Dev*V*n, 3], mass)`` rows in their (device, vrank) slab's
    block: slab ``s`` of the device-major order holds ``n`` rows of the
    full-grid cell ``slab_ranks[s]``."""
    from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid

    shape, v_shape, _, _, _, n = DEVICE_DEPOSIT_CASES[name]
    full = ProcessGrid(_full_grid(shape, v_shape))
    rng = np.random.default_rng(seed)
    slabs = slab_ranks(shape, v_shape)
    pos = np.empty((len(slabs), n, 3), np.float32)
    for s, g in enumerate(slabs):
        cell = full.cell_of_rank(int(g))
        for a in range(3):
            pos[s, :, a] = (cell[a] + 0.999 * rng.random(n)) / full.shape[a]
    mass = rng.random(len(slabs) * n).astype(np.float32)
    return pos.reshape(-1, 3), mass


# ------------------------------------------------------------------ halo

# name: (grid, periodic, width, n_local, pass_capacity, ghost_capacity,
#        domain lo, hi); None capacities: default_capacities per call
HALO_CASES = {
    "g222-periodic": ((2, 2, 2), True, 0.08, 64, 256, 1024, 0.0, 1.0),
    "g222-open": ((2, 2, 2), False, 0.08, 64, 256, 1024, 0.0, 1.0),
    "g421-periodic": ((4, 2, 1), True, 0.08, 64, 256, 1024, 0.0, 1.0),
    "fields": ((2, 2, 2), True, 0.1, 32, 128, 512, 0.0, 1.0),
    "overflow": ((2, 2, 2), True, 0.25, 64, 4, 8, 0.0, 1.0),
    "auto": ((2, 2, 2), True, 0.08, 128, None, None, 0.0, 1.0),
    "two-sort": ((2, 2, 2), True, 0.25, 256, None, None, 0.0, 1.0),
    "two-sort-tight": ((2, 2, 2), True, 0.3, 256, 64, 160, 0.0, 1.0),
    "open-wide": ((2, 2, 1), False, 0.2, 96, 128, 512, -1.0, 1.0),
    "negzero-periodic": ((2, 2, 2), True, 0.2, 40, 128, 512, -1.0, 1.0),
    "negzero-open": ((2, 2, 2), False, 0.2, 40, 128, 512, -1.0, 1.0),
}
# GridRedistribute(mesh=).halo(): (engine, on_overflow, headroom, pinned
# (pass, ghost) or None)
HALO_API_CASES = {
    "auto": ("auto", "grow", 2.0, None),
    "rowmajor": ("rowmajor", "grow", 2.0, None),
    "grow": ("auto", "grow", 0.05, None),
    "grow-rowmajor": ("rowmajor", "grow", 0.05, None),
    "ignore": ("auto", "ignore", 0.05, None),
    "raise": ("auto", "raise", 0.05, None),
    "pinned": ("auto", "grow", 2.0, (4, 8)),
}


def halo_inputs(name: str):
    """``(pos [R * n, 3] float32, count [R], ids [R * n] int32)``: each
    rank's valid rows inside its own cell, padding rows random; the
    ``negzero`` cases put a row of cell (1, 1, 1) at (-0.0, -0.0, 0.5) on
    Domain(-1, 1), whose interior faces are at 0.0."""
    shape, _, _, n, _, _, lo, hi = HALO_CASES[name]
    rng = np.random.default_rng(list(HALO_CASES).index(name) + 300)
    R = int(np.prod(shape))
    strides = np.cumprod((1,) + shape[::-1])[:-1][::-1]
    ext = hi - lo
    pos = rng.random((R, n, 3), dtype=np.float32)
    for r in range(R):
        cell = np.asarray([(r // s) % g for s, g in zip(strides, shape)])
        pos[r] = (lo + (cell + pos[r]) * (ext / np.asarray(shape))).astype(
            np.float32)
    count = rng.integers(n // 2, n + 1, R).astype(np.int32)
    if name.startswith("negzero"):
        count[:] = n
        src = int(np.dot((1, 1, 1), strides))
        pos[src, 0] = (-0.0, -0.0, 0.5)
    for r in range(R):  # padding past the count: junk the engines skip
        pos[r, count[r]:] = rng.random((n - count[r], 3)) * 7.0
    ids = np.arange(R * n, dtype=np.int32)
    return pos.reshape(R * n, 3), count, ids


def run_halo(ctx):
    """Every halo case on this rank (both engines, through the global forms
    and the per-rank functions) and ``GridRedistribute(mesh=).halo()``;
    returns ``{key: numpy}``."""
    import torch

    from mpi_grid_redistribute_tpu_torch import api
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.parallel import halo
    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib

    r = ctx.rank
    out = {}
    groups = _subgroups([int(np.prod(c[0])) for c in HALO_CASES.values()])
    for name, (shape, periodic, w, n, H, G, lo, hi) in HALO_CASES.items():
        R = int(np.prod(shape))
        if r >= R:
            continue
        grid = ProcessGrid(shape)
        dom = Domain(lo, hi, periodic=periodic)
        mesh = mesh_lib.make_mesh(grid, group=groups[R])
        pos, count, ids = (torch.from_numpy(split_rows(a, R)[r].copy())
                           for a in halo_inputs(name))
        res = halo.build_halo_exchange(mesh, dom, grid, w, H, G)(
            pos, count, ids)
        out[(name, "rowmajor")] = (_np(res.ghost_positions),
                                   _np(res.ghost_count),
                                   _np(res.ghost_fields[0]),
                                   _np(res.overflow))
        if H is None:
            H, G = halo.default_capacities(dom, grid, w, n)
        fused = torch.cat([pos.T, ids.view(torch.float32)[None]])
        ghost, gcount, overflow = halo.build_halo_planar(
            mesh, dom, grid, w, H, G)(fused, count)
        out[(name, "planar")] = (_np(ghost), _np(gcount), _np(overflow))
        # the per-rank functions: this rank's counters only
        pg = halo.shard_halo_planar_fn(dom, grid, w, H, G, mesh=mesh)(
            fused, count)
        rg = halo.shard_halo_fn(dom, grid, w, H, G, mesh=mesh)(pos, count,
                                                               ids)
        out[(name, "rows")] = (_np(pg[1]), _np(pg[2]), _np(rg[1]),
                               _np(rg[-1]))
    # the public API on the 2x2x2 mesh
    grid = ProcessGrid((2, 2, 2))
    mesh = mesh_lib.make_mesh(grid)
    pos, count, ids = (split_rows(a, 8)[r] for a in halo_inputs("auto"))
    for key, (engine, policy, headroom, pinned) in HALO_API_CASES.items():
        rd = api.GridRedistribute(grid=(2, 2, 2), lo=0.0, hi=1.0,
                                  periodic=True, device="cpu", mesh=mesh,
                                  engine=engine, on_overflow=policy)
        kw = {} if pinned is None else dict(pass_capacity=pinned[0],
                                            ghost_capacity=pinned[1])
        try:
            res = rd.halo(pos, ids, width=0.12, count=int(count[0]),
                          headroom=headroom, **kw)
        except RuntimeError as err:
            out[("api", key)] = ("raised", str(err))
            continue
        out[("api", key)] = (
            _np(res.ghost_positions), _np(res.ghost_fields[0]),
            _np(res.ghost_count), _np(res.overflow), dict(rd._halo_caps))
    out[("imports",)] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "mpi_grid_redistribute_tpu"))
    return out


# ------------------------------------------------------------ drift loop

# name: (grid, periodic, n_local, n_fill, capacity, dt, steps,
#        (deposit method, shape) or None, deposit_each_step).  dt is a
#        power of two: the reference's jitted drift may fuse p + v*dt on
#        the CPU, and v*dt is exact for a power of two, so both round once
DRIFT_CASES = {
    "step": ((2, 2, 2), True, 200, 150, 200, 0.0625, 1, None, False),
    "loop4": ((2, 2, 2), True, 200, 150, 200, 0.0625, 4, None, False),
    "scan-final": ((2, 2, 2), True, 200, 150, 200, 0.0625, 2,
                   ("scan", (8, 8, 8)), False),
    "scan-each": ((2, 2, 2), True, 64, 64, 16, 0.015625, 3,
                  ("scan", (8, 8, 8)), True),
    "mxu-final": ((2, 2, 2), True, 200, 150, 200, 0.0625, 2,
                  ("mxu", (8, 8, 8)), False),
    "mxu-each": ((2, 2, 2), True, 64, 64, 16, 0.015625, 3,
                 ("mxu", (8, 8, 8)), True),
    "open-scan-each": ((2, 2, 2), False, 200, 150, 200, 0.0625, 2,
                       ("scan", (8, 8, 8)), True),
    "g421-scan-each": ((4, 2, 1), True, 96, 80, 96, 0.0625, 2,
                       ("scan", (8, 4, 4)), True),
}


def drift_inputs(name: str):
    """``(pos [R * n, 3], vel [R * n, 3], count [R])`` float32 rows (the
    reference's nbody test state: unique x-velocities)."""
    shape, _, n, n_fill, _, _, _, _, _ = DRIFT_CASES[name]
    rng = np.random.default_rng(list(DRIFT_CASES).index(name) + 700)
    R = int(np.prod(shape))
    pos = rng.uniform(0, 1, size=(R * n, 3)).astype(np.float32)
    vel = rng.normal(scale=0.3, size=(R * n, 3)).astype(np.float32)
    vel[:, 0] = np.linspace(-0.5, 0.5, R * n, dtype=np.float32)
    if name.endswith("each") and n == n_fill:
        vel[:] = 0.0  # the reference's deposit test: a scattered start
    count = np.full((R,), n_fill, dtype=np.int32)
    return pos, vel, count


def drift_cfg(name: str):
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.models import nbody

    shape, periodic, n, _, cap, dt, _, dep, _ = DRIFT_CASES[name]
    kw = {} if dep is None else dict(deposit_method=dep[0],
                                     deposit_shape=dep[1])
    return nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=periodic), grid=ProcessGrid(shape),
        dt=dt, capacity=cap, n_local=n, **kw)


def _redist_np(stats):
    return {k: _np(v) for k, v in stats._asdict().items() if v is not None}


def run_drift(ctx):
    """Every drift case on this rank: ``make_drift_step`` once and
    ``make_drift_loop`` (each also with ``plain=True``), the standalone
    deposits; returns ``{key: numpy}``."""
    import torch

    from mpi_grid_redistribute_tpu_torch.models import nbody
    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib

    r = ctx.rank
    out = {}
    groups = _subgroups([int(np.prod(c[0])) for c in DRIFT_CASES.values()])
    for name, (shape, _, n, _, _, _, steps, dep, each) in (
            DRIFT_CASES.items()):
        R = int(np.prod(shape))
        if r >= R:
            continue
        cfg = drift_cfg(name)
        mesh = mesh_lib.make_mesh(cfg.grid, group=groups[R])
        pos, vel, count = (split_rows(a, R)[r] for a in drift_inputs(name))
        if steps == 1:
            res = nbody.make_drift_step(cfg, mesh, device="cpu")(
                pos, vel, count)
        else:
            res = nbody.make_drift_loop(cfg, steps, mesh=mesh,
                                        deposit_each_step=each,
                                        device="cpu")(pos, vel, count)
        out[name] = (tuple(_np(a) for a in res[:3]), _redist_np(res[3]),
                     None if dep is None else _np(res[4]))
        if dep is not None:
            plain = nbody.make_drift_loop(
                cfg, steps, mesh=mesh, deposit_each_step=each, device="cpu",
                plain=True)(pos, vel, count)
            out[(name, "plain")] = _np(plain[4])
    # the standalone deposits of the 2x2x2 scan case's input state
    cfg = drift_cfg("scan-final")
    mesh = mesh_lib.make_mesh(cfg.grid)
    pos, _, count = (split_rows(a, 8)[r] for a in drift_inputs("scan-final"))
    mass = np.random.default_rng(77).random(8 * 200).astype(np.float32)
    mass = split_rows(mass, 8)[r]
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    out["deposit_step"] = _np(nbody.build_deposit_step(cfg, mesh)(
        p, m, torch.from_numpy(count)))
    valid = torch.from_numpy(mass > 0.3)
    out["deposit_masked"] = _np(nbody.build_deposit_masked(cfg, mesh)(
        p, m, valid))
    out[("imports",)] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "mpi_grid_redistribute_tpu"))
    return out


# --------------------------------------------------------- hierarchical

# name: (grid, dcn, periodic, n_local, cap, out_cap, mover_cap, cross_cap,
#        drift): the reference's sharded cases, a clipping cross block,
#        the dense intra fallback, one-rank pods and an open grid
HIER_CASES = {
    "2pods-122": ((2, 2, 2), (2, 1, 1), True, 120, 60, 300, 16, 16, 0.01),
    "4pods-211": ((2, 2, 2), (1, 2, 2), True, 120, 60, 300, 16, 16, 0.01),
    "clip": ((2, 2, 2), (2, 1, 1), True, 120, 60, 300, 16, 2, 0.05),
    "fallback": ((2, 2, 2), (2, 1, 1), True, 120, 60, 300, 2, 64, 0.3),
    "8pods": ((2, 2, 2), (2, 2, 2), True, 120, 60, 300, 16, 32, 0.05),
    "open-421": ((4, 2, 1), (2, 1, 1), False, 100, 64, 300, 16, 16, 0.02),
}
# GridRedistribute(mesh=, dcn_shape=): (engine, dcn, drift, kwargs)
HIER_API_CASES = {
    "explicit": ("hierarchical", (2, 1, 1), 0.02,
                 dict(capacity=96, out_capacity=256)),
    "auto": ("auto", (1, 2, 2), 0.02, dict(capacity=96, out_capacity=256)),
    "flat-none": ("hierarchical", None, 0.02,
                  dict(capacity=96, out_capacity=256)),
    "flat-ones": ("hierarchical", (1, 1, 1), 0.02,
                  dict(capacity=96, out_capacity=256)),
    "planar": ("planar", None, 0.02, dict(capacity=96, out_capacity=256)),
    "ratchet": ("hierarchical", (2, 1, 1), 0.05,
                dict(cross_cap=1, capacity=96)),
    "ratchet-planar": ("planar", None, 0.05, dict(capacity=96)),
}


def hier_inputs(name: str, K: int = 7):
    """``(fused [R, K, n] float32, count [R])``: shard-local particles plus
    a gaussian drift (the reference's hierarchical test inputs)."""
    shape, _, _, n, _, _, _, _, drift = HIER_CASES[name]
    rng = np.random.default_rng(list(HIER_CASES).index(name) + 800)
    R = int(np.prod(shape))
    strides = np.cumprod((1,) + shape[::-1])[:-1][::-1]
    pos = np.empty((R, 3, n), np.float32)
    for r in range(R):
        cell = [(r // s) % g for s, g in zip(strides, shape)]
        for a in range(3):
            pos[r, a] = (cell[a] + rng.random(n)) / shape[a]
    pos = pos + rng.normal(0, drift, size=pos.shape).astype(np.float32)
    pos = np.mod(pos, 1.0).astype(np.float32)
    other = rng.standard_normal((R, K - 3, n)).astype(np.float32)
    count = rng.integers(n // 2, n + 1, size=R).astype(np.int32)
    return np.concatenate([pos, other], axis=1), count


def run_hier(ctx):
    """Every hierarchical case on this rank: the engine beside the port's
    planar engine (with its collectives recorded), and
    ``GridRedistribute(mesh=, dcn_shape=)``; returns ``{key: numpy}``."""
    import torch

    from mpi_grid_redistribute_tpu_torch import api
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.parallel import collectives as col
    from mpi_grid_redistribute_tpu_torch.parallel import exchange
    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib

    r = ctx.rank
    out = {}
    for name, (shape, dcn, periodic, n, cap, oc, B, B2, _) in (
            HIER_CASES.items()):
        grid = ProcessGrid(shape)
        dom = Domain((0.0,) * 3, (1.0,) * 3, periodic)
        mesh = mesh_lib.make_hybrid_mesh(grid, dcn)
        hier = mesh_lib.HierarchicalMesh(grid, dcn)
        fused, count = hier_inputs(name)
        f = torch.from_numpy(fused[r].copy())
        c = torch.from_numpy(split_rows(count, len(count))[r])
        with wire_recording() as traffic:
            res = exchange.shard_redistribute_hierarchical_sharded(
                mesh, dom, grid, hier, cap, oc, B, B2, 3)(f, c)
        out[(name, "hier")] = (_np(res[0]), _np(res[1]), _stats_np(res[2]),
                               list(traffic))
        res = exchange.shard_redistribute_planar_sharded(
            mesh, dom, grid, cap, oc, 3)(f, c)
        out[(name, "planar")] = (_np(res[0]), _np(res[1]), _stats_np(res[2]))
    grid = ProcessGrid((2, 2, 2))
    mesh = mesh_lib.make_mesh(grid)
    # the sub-axis collectives: an all-to-all inside each pod and a
    # ppermute between the pods' same slots, each one world call
    for dcn in ((2, 1, 1), (1, 2, 2)):
        hier = mesh_lib.HierarchicalMesh(grid, dcn)
        L, P = hier.pod_size, hier.n_pods
        x = torch.arange(L * 3, dtype=torch.int32) + 100 * r
        with wire_recording() as traffic:
            a2a = col.all_to_all(x, mesh, group=hier.ici_group(r))
            perm = col.lift_perm([(p, (p + 1) % P) for p in range(P)],
                                 hier.dcn_groups())
            pp = col.ppermute(x.to(torch.int16), mesh, perm)
        out[("subaxis", dcn)] = (_np(a2a), _np(pp), list(traffic))
    for key, (engine, dcn, drift, kw) in HIER_API_CASES.items():
        pos, _, ids, _ = (split_rows(a, 8)[r] for a in rows_inputs(
            8, 96, drift, 9))
        rd = api.GridRedistribute(
            grid=(2, 2, 2), lo=(0.0,) * 3, hi=(1.0,) * 3,
            periodic=(True,) * 3, device="cpu", mesh=mesh, engine=engine,
            dcn_shape=dcn, **kw)
        res = rd.redistribute(pos, ids)
        out[("api", key)] = (
            _np(res.positions), _np(res.fields[0]), _np(res.count),
            _stats_np(res.stats),
            dict(engine=rd._last_wire["engine"], n_pods=rd.n_pods,
                 cross_cap=rd._cross_cap, mover_cap=rd._mover_cap,
                 capacity=rd.capacity, fetches=rd._blocking_fetches))
    out[("imports",)] = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "mpi_grid_redistribute_tpu"))
    return out
