"""Periodic N-body drift loop on the resident-slot migrate engine (port of
the JAX package's ``models/nbody.py``, single-device vrank path).

    for step in range(S): pos += vel*dt; wrap; migrate(pos, vel)

The loop carries the fused PLANAR int32 state ``[2D+1, V*n]`` (position
rows, velocity rows, alive row) and runs each step as the fused drift-bin
kernel followed by one dense migrate step. The reference's ``lax.scan``
is a Python loop here and nothing in a step waits for the host; stats
are stacked per step as ``[S, V]`` (``flow`` as ``[S, V, V]``), exactly
as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch import _device
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops import driftbin
from mpi_grid_redistribute_tpu_torch.parallel import migrate


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Static configuration for the drift loop (same fields as the
    reference). Only ``engine="planar"`` runs in this port so far; the
    deposit and the load-balanced ``cells``/``assignment`` decomposition
    are later slices."""

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
    if cfg.deposit_shape is not None:
        raise NotImplementedError("the CIC deposit is not ported yet")
    if cfg.cells is not None or cfg.assignment is not None:
        raise NotImplementedError(
            "cells/assignment decompositions are not ported yet"
        )


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def make_migrate_loop(cfg: DriftConfig, n_steps: int,
                      vgrid: Optional[ProcessGrid] = None, device=None,
                      plain: bool = False):
    """S drift + migrate steps on one device.

    Returns ``loop(pos, vel, alive) -> (pos_planar, vel_planar, alive,
    stats)``. ``pos``/``vel`` are ``[N, D]`` numpy rows or PLANAR flat
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
        steps = []
        for _ in range(n_steps):
            with torch.profiler.record_function("mig:step"):
                f, key = bin_fn(state.fused, dt, cfg.domain, full_grid, V, V)
                state, stats = mig(state._replace(fused=f), key)
            steps.append(stats)
        f = state.fused
        pos_f = f[:D].view(torch.float32).reshape(-1)
        vel_f = f[D : 2 * D].view(torch.float32).reshape(-1)
        return pos_f, vel_f, f[-1] > 0, _stack_stats(steps, V, dev)

    return loop


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
