"""Periodic N-body drift loop on the resident-slot migrate engine (port of
the JAX package's ``models/nbody.py``: the vrank path on one device, and
with ``mesh=`` the flat and vrank paths with one device a process).

    for step in range(S): pos += vel*dt; wrap; migrate(pos, vel)
                          [rho = CIC deposit of the new state]

The loop carries the fused PLANAR int32 state ``[2D+1, V*n]`` (position
rows, velocity rows, alive row) and runs each step as the fused drift-bin
kernel followed by one migrate step (the mover-sparse engine by default,
the dense planar step with ``engine="planar"``) and, for the config-5
workload, the CIC deposit (``ops.deposit``). Under the load-balanced
``cells``/``assignment`` decomposition the drift and wrap run as plain
ops and the engine bins with the assignment table instead (the drift-bin
kernel's key is the canonical vrank's). The reference's ``lax.scan``
is a Python loop here; stats are stacked per step as ``[S, V]`` (``flow``
as ``[S, V, V]``), exactly as in the reference. A step waits for the host
only where the reference branches with ``lax.cond``: the sparse engine's
guard (one boolean per step) and the slab deposit's residence guard (one
more with ``deposit_method="mxu"``).

Across devices (``cfg.grid`` of several ranks, each a process of
``mesh``) every rank runs the loop on its own shard: the reference's
global rows ``[r * V * n_local, (r + 1) * V * n_local)`` for rank ``r``.
It returns its shard of the output state, the stats of every rank
(``[S, R]``, gathered, the same on each) and the density as the
reference shards it (a fully periodic domain: this rank's block; else
the whole node mesh on every rank). Kernel 1 is off there, as in the
reference: the drift and the wrap run as separate ops, and the engine
bins. A step across ranks waits on the host in its collectives (gloo
moves a card's tensors through host memory) and in the remote landing's
masked assignment.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch import _device
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops import binning, deposit, driftbin
from mpi_grid_redistribute_tpu_torch.parallel import exchange, migrate
from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib
from mpi_grid_redistribute_tpu_torch.telemetry.phases import span


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Static configuration for the drift loop (same fields as the
    reference). ``engine`` ``"auto"`` (the default) and ``"sparse"`` run
    the mover-sparse engine on the single-device vrank path, ``"planar"``
    the dense step; ``mover_cap`` sizes the mover block (default
    ``local_budget``, then ``V * capacity``). ``deposit_method`` is
    ``"scan"`` (the planar double-float engine), ``"mxu"`` (the segmented
    sums) or ``"segment"`` (the row-major scatter-add, canonical vranks
    only). ``cells`` with ``assignment`` is the load-balanced
    decomposition (``parallel.migrate.balanced_assignment``)."""

    domain: Domain
    grid: ProcessGrid
    dt: float
    capacity: int
    n_local: int  # padded rows per vrank
    deposit_shape: Optional[Tuple[int, ...]] = None
    deposit_method: str = "scan"
    local_budget: Optional[int] = None
    cells: Optional[ProcessGrid] = None
    assignment: Optional[Tuple[int, ...]] = None
    engine: str = "auto"
    mover_cap: Optional[int] = None


def _check_supported(cfg: DriftConfig, vgrid) -> str:
    """Raise the reference's ``ValueError``s; return the resolved engine
    (``resolve_engine`` rejects the canonical-only names)."""
    balanced = cfg.cells is not None or cfg.assignment is not None
    if vgrid is None and balanced:
        raise ValueError(
            "cells/assignment require the vrank path (pass vgrid)"
        )
    if (
        vgrid is not None
        and cfg.assignment is not None
        and cfg.deposit_shape is not None
        and not (cfg.deposit_method in ("scan", "mxu")
                 and cfg.grid.nranks == 1)
    ):
        # the scan and mxu engines key by position, so on one device they
        # compose with any cell -> vrank map; the per-vrank block deposit
        # needs each vrank's rows inside its own block
        raise ValueError(
            "assignment-decomposed vranks own non-contiguous cell sets; "
            "the block deposit assumes each vrank owns a contiguous "
            "region -- deposit on the canonical layout, or use "
            "deposit_method='scan'/'mxu' on a single device"
        )
    eng = exchange.resolve_engine(
        cfg.engine, vranks=vgrid is not None, n_devices=cfg.grid.nranks
    )
    if cfg.deposit_shape is not None and cfg.deposit_method not in (
        "scan", "mxu", "segment"
    ):
        raise ValueError(
            f"deposit_method must be 'scan', 'mxu' or 'segment', got "
            f"{cfg.deposit_method!r}"
        )
    return eng


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _deposit_fn(cfg: DriftConfig, vgrid: ProcessGrid, plain: bool,
                mesh=None):
    """The per-device deposit the reference's loop builds for
    ``cfg.deposit_shape`` (``None`` without one): for ``"mxu"`` the
    slab-keyed engine when the canonical vrank blocks divide the mesh, the
    flat position-keyed one otherwise and under ``cells``/``assignment``
    (whose vranks own scattered cells, so the slab partition does not
    hold); the double-float scan engine for ``"scan"``; the per-vrank
    block deposit for ``"segment"`` (the masked row deposit on the flat
    path)."""
    if cfg.deposit_shape is None:
        return None
    if cfg.deposit_method == "mxu":
        slab_ok = (
            vgrid is not None
            and cfg.assignment is None
            and cfg.cells is None
            and all(
                (m // g) % v == 0
                for m, g, v in zip(
                    cfg.deposit_shape, cfg.grid.shape, vgrid.shape
                )
            )
        )
        return deposit.shard_deposit_device_mxu_fn(
            cfg.domain, cfg.grid, cfg.deposit_shape,
            vgrid=vgrid if slab_ok else None, plain=plain, mesh=mesh,
        )
    if cfg.deposit_method == "segment" and vgrid is None:
        return deposit.shard_deposit_fn_masked(
            cfg.domain, cfg.grid, cfg.deposit_shape, method="segment",
            mesh=mesh, plain=plain,
        )[0]
    if cfg.deposit_method == "segment":
        return deposit.shard_deposit_vranks_fn(
            cfg.domain, cfg.grid, vgrid, cfg.deposit_shape,
            method="segment", plain=plain, mesh=mesh,
        )
    return deposit.shard_deposit_device_planar_fn(
        cfg.domain, cfg.grid, cfg.deposit_shape, plain=plain, mesh=mesh
    )


def make_migrate_loop(cfg: DriftConfig, n_steps: int,
                      vgrid: Optional[ProcessGrid] = None, mesh=None,
                      device=None, plain: bool = False,
                      deposit_each_step: bool = False):
    """S drift + migrate steps, on one device or (``cfg.grid`` of several
    ranks) one device a process.

    Returns ``loop(pos, vel, alive) -> (pos_planar, vel_planar, alive,
    stats)``, and ``rho`` appended when ``cfg.deposit_shape`` is set: the
    CIC density of the final state (fully periodic domains: the
    ``deposit_shape`` mesh; any open axis: the ``global_node_shape``
    mesh). ``deposit_each_step=True`` deposits after EVERY step (the
    config-5 workload) and returns the last step's mesh; without it the
    loop deposits once, on the final state.

    ``pos``/``vel`` are ``[N, D]`` numpy rows or PLANAR flat
    ``[D * N]`` arrays/tensors (all x's, then all y's, ...; see
    :func:`rows_to_planar`); they are returned planar flat on the device
    (:func:`planar_to_rows` recovers rows). Rows are vrank-major: vrank
    ``v`` holds rows ``[v * n_local, (v + 1) * n_local)``. ``stats`` is a
    :class:`~..parallel.migrate.MigrateStats` of ``[S, V]`` tensors
    (``flow`` ``[S, V, V]``; ``fast_path`` ``[S, V]`` when the engine
    resolved to the sparse one, else ``None``).

    With ``vgrid=None`` each device is one rank (the flat engine); with
    ``cfg.grid`` of several devices the loop runs one device a process
    over ``mesh`` (default :func:`~..parallel.mesh.make_mesh` of
    ``cfg.grid``): each rank passes its own ``V * n_local`` rows, gets
    its rows back, and the stats of every rank (``[S, Dev * V]``).

    ``device=None`` means the GPU and raises without one; the tests pass
    ``"cpu"``, where each kernel runs as its plain version. ``plain=True``
    runs the plain versions on the GPU too (the reference run the kernels
    are held against)."""
    eng = _check_supported(cfg, vgrid)
    dev = _device.resolve(device)
    Dev = cfg.grid.nranks
    if Dev > 1 or vgrid is None:
        mesh = mesh_lib.mesh_for(cfg.grid, mesh)
    dep_fn = _deposit_fn(cfg, vgrid, plain, mesh)
    if deposit_each_step and dep_fn is None:
        raise ValueError("cfg.deposit_shape is required for deposit")
    D = cfg.domain.ndim
    V = 1 if vgrid is None else vgrid.nranks
    # kernel 1 bins into the canonical vrank grid of ONE device, as in
    # the reference; under an assignment its key would land rows on the
    # wrong slabs, and across devices the engine bins (device-major keys)
    use_driftbin = vgrid is not None and Dev == 1 and cfg.assignment is None
    mover_cap = None  # the sparse engine's mover block width
    if eng == "sparse":
        mover_cap = (
            cfg.mover_cap if cfg.mover_cap is not None
            else cfg.local_budget if cfg.local_budget is not None
            else V * cfg.capacity
        )
    if vgrid is None:
        mig = migrate.shard_migrate_fused_fn(cfg.domain, cfg.grid,
                                             cfg.capacity, mesh=mesh,
                                             plain=plain)
    else:
        mig = migrate.shard_migrate_vranks_fn(
            cfg.domain, cfg.grid, vgrid, cfg.capacity,
            local_budget=cfg.local_budget, mover_cap=mover_cap, plain=plain,
            cells=cfg.cells, assignment=cfg.assignment, mesh=mesh,
        )
    full_grid = None
    if use_driftbin:
        full_grid = ProcessGrid(
            tuple(d * v for d, v in zip(cfg.grid.shape, vgrid.shape)),
            axis_names=cfg.grid.axis_names,
        )
    bin_fn = driftbin.drift_wrap_bin_plain if plain else driftbin.drift_wrap_bin
    dt = float(cfg.dt)

    def to_planar(a):
        if a.ndim == 1:
            return a
        if isinstance(a, np.ndarray):
            return rows_to_planar(a, 1)
        raise TypeError(
            "make_migrate_loop: pass [N, D] numpy rows or planar flat "
            "[D * N] arrays"
        )

    def _deposit(fused):
        """CIC density of the planar fused state ``[K, V*n]``."""
        with span("dep:deposit"):
            with span("dep:keys"):  # the valid rows and the unit mass
                pos_rows = fused[:D].view(torch.float32)
                valid = fused[-1] > 0
                # None drops the mass row from the mxu payload sort
                mass = None
                if cfg.deposit_method == "segment" and vgrid is None:
                    pos_rows = pos_rows.T  # the masked row deposit: [n, D]
                elif cfg.deposit_method == "segment":
                    # the per-vrank block deposit takes row-major
                    # [V, n, D] slabs
                    pos_rows = pos_rows.reshape(D, V, -1).permute(1, 2, 0)
                    valid = valid.reshape(V, -1)
                if cfg.deposit_method != "mxu":
                    mass = torch.ones(valid.shape, dtype=torch.float32,
                                      device=pos_rows.device)
            return dep_fn(pos_rows, mass, valid)

    def loop(pos, vel, alive):
        p = _to_tensor(to_planar(pos), dev).reshape(D, -1)
        v = _to_tensor(to_planar(vel), dev).reshape(D, -1)
        a = _to_tensor(alive, dev)
        if p.dtype != torch.float32 or v.dtype != torch.float32:
            raise TypeError("make_migrate_loop: pos/vel must be float32")
        if p.shape[1] != V * cfg.n_local:
            raise ValueError(
                f"make_migrate_loop: {p.shape[1]} rows, expected "
                f"V * n_local = {V * cfg.n_local}"
            )
        with span("mig:init"):  # the per-call set-up
            fused = torch.cat(
                [p.view(torch.int32), v.view(torch.int32),
                 a.to(torch.int32)[None, :]],
                dim=0,
            )
            state = migrate.init_state(fused, vranks=V,
                                       batched=vgrid is not None)
            if deposit_each_step:
                rho = torch.zeros(_rho_shape(cfg), dtype=torch.float32,
                                  device=dev)
        steps = []
        for _ in range(n_steps):
            with span("mig:step"):
                if use_driftbin:
                    f, key = bin_fn(state.fused, dt, cfg.domain, full_grid,
                                    V, V)
                    state, stats = mig(state._replace(fused=f), key)
                else:
                    driftbin.drift_wrap(state.fused, dt, cfg.domain)
                    state, stats = mig(state)
            steps.append(stats)
            if deposit_each_step:
                rho = _deposit(state.fused)
        f = state.fused
        pos_f = f[:D].view(torch.float32).reshape(-1)
        vel_f = f[D : 2 * D].view(torch.float32).reshape(-1)
        stats = _stack_stats(steps, V, Dev * V, dev, mover_cap is not None)
        if mesh is not None and Dev > 1:
            stats = migrate.gather_migrate_stats(stats, mesh)
        out = (pos_f, vel_f, f[-1] > 0, stats)
        if dep_fn is None:
            return out
        return out + (rho if deposit_each_step else _deposit(f),)

    return loop


def make_migrate_step(cfg: DriftConfig, mesh=None, device=None,
                      plain: bool = False):
    """One drift + migrate step on resident slots with the flat engine
    (one device a rank): ``step(pos [n, D], vel [n, D], alive [n]) ->
    (pos, vel, alive, stats[, rho])`` on this rank's rows, the stats of
    every rank gathered (``[R]``, ``flow`` ``[R, R]``). Each call builds
    the free stack anew; :func:`make_migrate_loop` carries it. With
    ``cfg.deposit_shape`` the masked row deposit of the new state is
    appended (``cfg.deposit_method`` ``"scan"`` or ``"segment"``)."""
    dev = _device.resolve(device)
    mesh = mesh_lib.mesh_for(cfg.grid, mesh)
    mig = migrate.shard_migrate_fn(cfg.domain, cfg.grid, cfg.capacity,
                                   mesh=mesh, plain=plain)
    dep_fn = None
    if cfg.deposit_shape is not None:
        dep_fn, _ = deposit.shard_deposit_fn_masked(
            cfg.domain, cfg.grid, cfg.deposit_shape,
            method=cfg.deposit_method, mesh=mesh, plain=plain,
        )

    def step(pos, vel, alive):
        pos, vel, alive = (_to_tensor(a, dev) for a in (pos, vel, alive))
        pos = pos + vel * binning._f32(cfg.dt, pos)
        pos = binning.wrap_periodic(pos, cfg.domain)
        pos, alive, vel, stats = mig(pos, alive, vel)
        if mesh.size > 1:
            stats = migrate.gather_migrate_stats(stats, mesh)
        if dep_fn is None:
            return pos, vel, alive, stats
        ones = torch.ones(pos.shape[:1], dtype=pos.dtype, device=dev)
        return pos, vel, alive, stats, dep_fn(pos, ones, alive)

    return step


def build_deposit_step(cfg: DriftConfig, mesh=None, plain: bool = False):
    """The standalone deposit of already-redistributed state (config 5):
    ``fn(pos [n, D], mass [n], count) -> rho``, this rank's shard of the
    density (:func:`~..ops.deposit.build_deposit`, ``cfg.deposit_method``
    ``"scan"``, ``"segment"`` or ``"mxu"``)."""
    if cfg.deposit_shape is None:
        raise ValueError("cfg.deposit_shape is required for deposit")
    return deposit.build_deposit(
        mesh_lib.mesh_for(cfg.grid, mesh), cfg.domain, cfg.grid,
        cfg.deposit_shape,
        method=cfg.deposit_method, plain=plain)


def build_deposit_masked(cfg: DriftConfig, mesh=None, plain: bool = False):
    """The mask-input deposit of migrate-path state: ``fn(pos [n, D], mass
    [n], valid [n]) -> rho`` (``"scan"`` or ``"segment"``)."""
    if cfg.deposit_shape is None:
        raise ValueError("cfg.deposit_shape is required for deposit")
    return deposit.shard_deposit_fn_masked(
        cfg.domain, cfg.grid, cfg.deposit_shape, method=cfg.deposit_method,
        mesh=mesh_lib.mesh_for(cfg.grid, mesh), plain=plain)[0]


def _count1(count, dev) -> torch.Tensor:
    """A rank's count (an int, a ``[1]`` array or tensor) as int32 ``[1]``
    on ``dev``."""
    if not isinstance(count, torch.Tensor):
        count = torch.from_numpy(np.asarray(count, dtype=np.int32).reshape(1))
    return count.to(dev).reshape(1).to(torch.int32)


def service_drift(pos: torch.Tensor, vel: torch.Tensor, dt) -> torch.Tensor:
    """One service-loop drift: ``(pos + vel * dt) % 1`` as a multiply,
    an add and ``jnp.remainder``'s arithmetic (fmod, then the sign fix;
    :func:`~..ops.binning._remainder`), then the fold of a result that
    rounded up to exactly 1.0 (a tiny negative plus 1) back to 0 by
    subtracting 1: the reference's ``service_drift``, float32, any
    shape. The canonical wrap is not used on purpose: its arithmetic
    differs in the last ulp near cell edges."""
    one = binning._f32(1.0, pos)
    pos = binning._remainder(pos + vel * binning._f32(dt, pos), 1.0)
    return torch.where(pos >= one, pos - one, pos)


def eager_drift(pos: torch.Tensor, vel: torch.Tensor, dt) -> torch.Tensor:
    """The service driver's eager drift: ``(pos + vel * dt) % 1`` with
    NumPy's float ``%`` (the reference's eager loop drifts on the host in
    NumPy): fmod, the sign fix, and a zero result made ``+0.0`` (NumPy's
    ``copysign(0, 1)``), then the fold of a result that rounded up to
    1.0. It differs from :func:`service_drift` (``jnp.remainder``) only
    in the sign of a zero: an exact non-positive integer ``pos + vel *
    dt`` gives ``+0.0`` here and ``-0.0`` in a chunk, as the reference's
    two legs do (ROADMAP C13)."""
    one = binning._f32(1.0, pos)
    m = torch.fmod(pos + vel * binning._f32(dt, pos), one)
    m = torch.where(m < 0, m + one, m)
    m = torch.where(m == 0, torch.zeros_like(m), m)
    return torch.where(m >= one, m - one, m)


def make_drift_step(cfg: DriftConfig, mesh=None, device=None,
                    plain: bool = False):
    """One step of the canonical drift loop, one rank a process (the
    reference's ``shard_map`` step): ``step(pos [n, D], vel [n, D],
    count) -> (pos, vel, count [1], stats[, rho])`` on this rank's rows
    (``cfg.n_local`` of them). The drift is ``pos + vel * dt`` as two
    rounded ops (a multiply, then an add), then the periodic wrap, then
    the row-major canonical exchange with ``vel`` riding along
    (``out_capacity = cfg.n_local``), then with ``cfg.deposit_shape``
    the CIC deposit of the new state at unit mass (``"scan"``: kernel 5
    on the card; ``"mxu"``: kernel 4; ``"segment"``). ``stats`` is the
    five-leaf :class:`~..parallel.exchange.RedistributeStats` of every
    rank (``[R, R]``/``[R]``, gathered), ``rho`` this rank's shard of
    the density (:func:`~..ops.deposit.deposit_out_spec`). ``mesh``
    defaults to :func:`~..parallel.mesh.make_mesh` of ``cfg.grid``; a
    one-rank grid runs in one process without ``torch.distributed``.
    The reference's step takes ``"scan"`` and ``"segment"``; ``"mxu"``
    is the port's."""
    dev = _device.resolve(device)
    mesh = mesh_lib.mesh_for(cfg.grid, mesh)
    redist = exchange.shard_redistribute_fn(
        cfg.domain, cfg.grid, cfg.capacity, cfg.n_local, mesh=mesh)
    dep = None
    if cfg.deposit_shape is not None:
        dep = build_deposit_step(cfg, mesh, plain=plain)

    def step(pos, vel, count):
        pos, vel = (_to_tensor(a, dev) for a in (pos, vel))
        count = _count1(count, dev)
        pos = pos + vel * binning._f32(cfg.dt, pos)
        pos = binning.wrap_periodic(pos, cfg.domain)
        pos, count, vel, stats = redist(pos, count, vel)
        stats = exchange.gather_stats(stats, mesh)
        if dep is None:
            return pos, vel, count, stats
        ones = torch.ones(pos.shape[:1], dtype=pos.dtype, device=dev)
        return pos, vel, count, stats, dep(pos, ones, count)

    return step


def make_drift_loop(cfg: DriftConfig, n_steps: int, mesh=None,
                    deposit_each_step: bool = False, device=None,
                    plain: bool = False):
    """``S`` steps of :func:`make_drift_step` (the reference's ``lax.scan``
    as a Python loop): ``loop(pos, vel, count) -> (pos, vel, count,
    stats[, rho])`` with the stats stacked per step (``[S, R, R]``/``[S,
    R]``). With ``cfg.deposit_shape`` the density is appended: by default
    one deposit of the final state; with ``deposit_each_step=True`` a
    deposit inside every step, the last one returned (a zero mesh of the
    rank's shard shape when ``n_steps`` is 0). ``plain=True`` runs the
    deposit's plain PyTorch version on the card too (what its kernels
    are held against)."""
    if deposit_each_step and cfg.deposit_shape is None:
        raise ValueError("cfg.deposit_shape is required for deposit")
    dev = _device.resolve(device)
    mesh = mesh_lib.mesh_for(cfg.grid, mesh)
    step = make_drift_step(
        dataclasses.replace(
            cfg,
            deposit_shape=cfg.deposit_shape if deposit_each_step else None),
        mesh, device=dev, plain=plain)
    dep = None
    if cfg.deposit_shape is not None and not deposit_each_step:
        dep = build_deposit_step(cfg, mesh, plain=plain)
    R = cfg.grid.nranks

    def loop(pos, vel, count):
        p, v, c = pos, vel, count
        rho = None
        if deposit_each_step:
            rho = torch.zeros(_rho_shape(cfg), dtype=torch.float32,
                              device=dev)
        steps = []
        for _ in range(n_steps):
            out = step(p, v, c)
            p, v, c, st = out[:4]
            if deposit_each_step:
                rho = out[4]
            steps.append(st)
        if not steps:
            p, v = (_to_tensor(a, dev) for a in (pos, vel))
            c = _count1(count, dev)
        stats = _stack_redistribute_stats(steps, R, dev)
        out = (p, v, c, stats)
        if deposit_each_step:
            return out + (rho,)
        if dep is None:
            return out
        ones = torch.ones(p.shape[:1], dtype=p.dtype, device=dev)
        return out + (dep(p, ones, c),)

    return loop


def _stack_redistribute_stats(steps, R: int, dev):
    """Stack per-step canonical stats to ``[S, ...]`` (the five leaves the
    row-major engine fills; the others stay ``None``)."""
    if not steps:
        z = torch.zeros((0, R), dtype=torch.int32, device=dev)
        zz = torch.zeros((0, R, R), dtype=torch.int32, device=dev)
        return exchange.RedistributeStats(zz, zz, z, z, z)
    return exchange.RedistributeStats(*(
        None if getattr(steps[0], f) is None
        else torch.stack([getattr(s, f) for s in steps])
        for f in exchange.RedistributeStats._fields))


def _rho_shape(cfg: DriftConfig):
    """Shape of the loop's density output: the device's block for fully
    periodic domains (ghost-folded), the global node mesh otherwise."""
    if all(cfg.domain.periodic):
        return tuple(m // g for m, g in zip(cfg.deposit_shape, cfg.grid.shape))
    return deposit.global_node_shape(cfg.domain, cfg.deposit_shape)


def _stack_stats(steps, V: int, R_total: int, dev,
                 fast_path: bool) -> migrate.MigrateStats:
    """Stack per-step stats to ``[S, V]`` (``flow`` ``[S, V, R_total]``);
    ``fast_path`` is stacked when the sparse engine ran, else ``None``."""
    fields = migrate.MigrateStats._fields
    if not steps:
        empty = torch.zeros((0, V), dtype=torch.int32, device=dev)
        return migrate.MigrateStats(
            *[empty] * (len(fields) - 2),
            flow=torch.zeros((0, V, R_total), dtype=torch.int32,
                             device=dev),
            fast_path=empty if fast_path else None,
        )
    return migrate.MigrateStats(*[
        torch.stack([getattr(s, f) for s in steps])
        if f != "fast_path" or fast_path else None
        for f in fields
    ])


def rows_to_planar(a, n_blocks: int):
    """Host-side pack of row-major ``[N, D]`` particle data into the
    planar flat format: ``n_blocks`` device-major blocks, component-major
    within each (all x's of the block, then all y's, ...). A rank of a
    multi-device loop packs its own rows as one block."""
    a = np.asarray(a)
    n, d = a.shape
    if n % n_blocks:
        raise ValueError(f"rows {n} not divisible by n_blocks {n_blocks}")
    return np.ascontiguousarray(
        a.reshape(n_blocks, n // n_blocks, d).transpose(0, 2, 1)
    ).reshape(-1)


def planar_to_rows(a, ndim: int, n_blocks: int):
    """Inverse of :func:`rows_to_planar`: planar flat ``[D * N]`` back to
    row-major ``[N, D]`` on the host (accepts tensors on any device)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    n = a.size // (ndim * n_blocks)
    return np.ascontiguousarray(
        a.reshape(n_blocks, ndim, n).transpose(0, 2, 1)
    ).reshape(-1, ndim)
