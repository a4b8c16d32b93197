"""Periodic N-body drift loop on the resident-slot migrate engine (port of
the JAX package's ``models/nbody.py``, single-device vrank path).

    for step in range(S): pos += vel*dt; wrap; migrate(pos, vel)
                          [rho = CIC deposit of the new state]

The loop carries the fused PLANAR int32 state ``[2D+1, V*n]`` (position
rows, velocity rows, alive row) and runs each step as the fused drift-bin
kernel followed by one dense migrate step and, for the config-5
workload, the CIC deposit (``ops.deposit``). The reference's ``lax.scan``
is a Python loop here; stats are stacked per step as ``[S, V]`` (``flow``
as ``[S, V, V]``), exactly as in the reference. Nothing in a step waits
for the host except the slab deposit's residence guard (one boolean per
step with ``deposit_method="mxu"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch import _device
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops import deposit, driftbin
from mpi_grid_redistribute_tpu_torch.parallel import migrate


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Static configuration for the drift loop (same fields as the
    reference). Only ``engine="planar"`` runs in this port so far, and of
    the deposit methods the planar ``"scan"`` and ``"mxu"`` engines; the
    load-balanced ``cells``/``assignment`` decomposition is a later
    slice."""

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


def _check_supported(cfg: DriftConfig, vgrid) -> None:
    if cfg.engine in ("auto", "sparse"):
        raise NotImplementedError(
            f"engine={cfg.engine!r}: the mover-sparse migrate engine is not "
            f"ported yet (ROADMAP.md A4); pass engine='planar'"
        )
    if cfg.engine != "planar":
        raise ValueError(
            f"engine={cfg.engine!r} has no migrate-loop meaning; use "
            f"'planar'"
        )
    if vgrid is None or cfg.grid.nranks != 1:
        raise NotImplementedError(
            "only the single-device vrank path is ported: pass a one-rank "
            "grid and vgrid"
        )
    if cfg.deposit_shape is not None and cfg.deposit_method not in (
        "scan", "mxu"
    ):
        if cfg.deposit_method == "segment":
            raise NotImplementedError(
                "deposit_method='segment' (the row-major scatter-add route, "
                "shard_deposit_vranks_fn) is not ported yet (ROADMAP A7); "
                "use 'scan' or 'mxu'"
            )
        raise ValueError(
            f"deposit_method must be 'scan', 'mxu' or 'segment', got "
            f"{cfg.deposit_method!r}"
        )
    if cfg.cells is not None or cfg.assignment is not None:
        raise NotImplementedError(
            "cells/assignment decompositions are not ported yet"
        )


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _deposit_fn(cfg: DriftConfig, vgrid: ProcessGrid, plain: bool):
    """The per-device deposit the reference's loop builds for
    ``cfg.deposit_shape`` (``None`` without one): the slab-keyed mxu
    engine when the canonical vrank blocks divide the mesh, the flat
    position-keyed one otherwise; the double-float scan engine for
    ``"scan"``."""
    if cfg.deposit_shape is None:
        return None
    if cfg.deposit_method == "mxu":
        slab_ok = all(
            (m // g) % v == 0
            for m, g, v in zip(cfg.deposit_shape, cfg.grid.shape, vgrid.shape)
        )
        return deposit.shard_deposit_device_mxu_fn(
            cfg.domain, cfg.grid, cfg.deposit_shape,
            vgrid=vgrid if slab_ok else None, plain=plain,
        )
    return deposit.shard_deposit_device_planar_fn(
        cfg.domain, cfg.grid, cfg.deposit_shape, plain=plain
    )


def make_migrate_loop(cfg: DriftConfig, n_steps: int,
                      vgrid: Optional[ProcessGrid] = None, device=None,
                      plain: bool = False, deposit_each_step: bool = False):
    """S drift + migrate steps on one device.

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
    (``flow`` ``[S, V, V]``).

    ``device=None`` means the GPU and raises without one; the tests pass
    ``"cpu"``, where each kernel runs as its plain version. ``plain=True``
    runs the plain versions on the GPU too (the reference run the kernels
    are held against)."""
    _check_supported(cfg, vgrid)
    dev = _device.resolve(device)
    dep_fn = _deposit_fn(cfg, vgrid, plain)
    if deposit_each_step and dep_fn is None:
        raise ValueError("cfg.deposit_shape is required for deposit")
    D = cfg.domain.ndim
    V = vgrid.nranks
    full_grid = ProcessGrid(
        tuple(d * v for d, v in zip(cfg.grid.shape, vgrid.shape)),
        axis_names=cfg.grid.axis_names,
    )
    mig = migrate.shard_migrate_vranks_fn(
        cfg.domain, cfg.grid, vgrid, cfg.capacity,
        local_budget=cfg.local_budget, plain=plain,
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
        pos_rows = fused[:D].view(torch.float32)
        valid = fused[-1] > 0
        if cfg.deposit_method == "mxu":
            # unit mass: None drops the mass row from the payload sort
            return dep_fn(pos_rows, None, valid)
        ones = torch.ones(pos_rows.shape[1:], dtype=torch.float32,
                          device=pos_rows.device)
        return dep_fn(pos_rows, ones, valid)

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
        fused = torch.cat(
            [p.view(torch.int32), v.view(torch.int32),
             a.to(torch.int32)[None, :]],
            dim=0,
        )
        state = migrate.init_state(fused, vranks=V, batched=True)
        if deposit_each_step:
            rho = torch.zeros(_rho_shape(cfg), dtype=torch.float32,
                              device=dev)
        steps = []
        for _ in range(n_steps):
            with torch.profiler.record_function("mig:step"):
                f, key = bin_fn(state.fused, dt, cfg.domain, full_grid, V, V)
                state, stats = mig(state._replace(fused=f), key)
            steps.append(stats)
            if deposit_each_step:
                with torch.profiler.record_function("dep:deposit"):
                    rho = _deposit(state.fused)
        f = state.fused
        pos_f = f[:D].view(torch.float32).reshape(-1)
        vel_f = f[D : 2 * D].view(torch.float32).reshape(-1)
        out = (pos_f, vel_f, f[-1] > 0, _stack_stats(steps, V, dev))
        if dep_fn is None:
            return out
        return out + (rho if deposit_each_step else _deposit(f),)

    return loop


def _rho_shape(cfg: DriftConfig):
    """Shape of the loop's density output: the device's block for fully
    periodic domains (ghost-folded), the global node mesh otherwise."""
    if all(cfg.domain.periodic):
        return tuple(m // g for m, g in zip(cfg.deposit_shape, cfg.grid.shape))
    return deposit.global_node_shape(cfg.domain, cfg.deposit_shape)


def _stack_stats(steps, V: int, dev) -> migrate.MigrateStats:
    fields = migrate.MigrateStats._fields[:-1]  # fast_path stays None
    if not steps:
        empty = torch.zeros((0, V), dtype=torch.int32, device=dev)
        return migrate.MigrateStats(
            *[empty] * (len(fields) - 1),
            flow=torch.zeros((0, V, V), dtype=torch.int32, device=dev),
        )
    return migrate.MigrateStats(
        *[torch.stack([getattr(s, f) for s in steps]) for f in fields]
    )


def rows_to_planar(a, n_blocks: int):
    """Host-side pack of row-major ``[N, D]`` particle data into the
    planar flat format: ``n_blocks`` device-major blocks, component-major
    within each (all x's of the block, then all y's, ...). The port runs
    on one device, so ``n_blocks`` is 1; it stays an argument to keep the
    reference's format."""
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
