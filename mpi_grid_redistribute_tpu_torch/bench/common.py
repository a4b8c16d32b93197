"""Benchmark state and sizing, the same policy as the JAX package's
``bench/common.py`` (numpy only, so both packages build identical
inputs from one seed)."""

from __future__ import annotations

import math

import numpy as np

from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid


def uniform_state(grid_shape, n_local: int, fill: float, rng, vel_scale=0.0):
    """Uniform particles placed on their owning slab (rank-major rows).

    ``vel_scale`` may be a scalar or a per-axis array; velocities are drawn
    uniform in ``[-vel_scale, vel_scale]`` per axis. Returns
    ``(pos [N, 3], vel [N, 3], alive [N])`` with ``N = R * n_local``.
    """
    grid = ProcessGrid(grid_shape)
    R = grid.nranks
    n = R * n_local
    pos = rng.random((n, 3), dtype=np.float32)
    lo = np.zeros((n, 3), dtype=np.float32)
    for s in range(R):
        cell = grid.cell_of_rank(s)
        for a in range(3):
            lo[s * n_local : (s + 1) * n_local, a] = (
                cell[a] / grid.shape[a]
            )
    pos = lo + pos / np.asarray(grid.shape, np.float32)
    vel = (
        np.asarray(vel_scale, np.float32)
        * (rng.random((n, 3), dtype=np.float32) * 2.0 - 1.0)
    ).astype(np.float32)
    alive = np.tile(np.arange(n_local) < int(fill * n_local), R)
    return pos, vel, alive


def drift_sizing(
    grid_shape, n_local: int, fill: float, migration: float,
    headroom: float = 1.3,
):
    """Drift-loop sizing: per-axis velocity scale for ~``migration``
    fraction of rows crossing a subdomain face per step (at dt = 1),
    per-pair exchange ``capacity``, and the compact-routing
    ``local_budget``.

    Face-neighbor count per axis: extent 1 -> 0 (undecomposed), extent 2
    -> 1 (both periodic wraps reach the SAME neighbor), else 2.
    Undecomposed axes get the mean decomposed velocity scale.
    """
    g = np.asarray(grid_shape, np.int64)
    dec = g > 1
    n_dec = max(int(dec.sum()), 1)
    distinct = int(np.where(g == 1, 0, np.where(g == 2, 1, 2)).sum())
    distinct = max(distinct, 1)
    v = np.where(dec, migration / n_dec * 2.0 / g, 0.0)
    v = np.where(dec, v, v[dec].mean() if dec.any() else migration)
    cap = max(64, math.ceil(fill * n_local * migration / distinct * headroom))
    budget = max(256, math.ceil(fill * n_local * migration * headroom))
    return v.astype(np.float32), cap, budget
