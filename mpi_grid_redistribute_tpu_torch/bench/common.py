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


def lognormal_state(grid_shape, n_local: int, fill: float, rng, sigma=1.0):
    """Log-normal clustered global positions (BASELINE config 2): a heavy
    density contrast across subdomains, so a heavy load imbalance. Rows
    are NOT placed on their owners; the redistribution under test must
    move them. Returns ``(pos [N, 3], alive [N])``, the reference's draws
    from ``rng``."""
    grid = ProcessGrid(grid_shape)
    n = grid.nranks * n_local
    raw = rng.lognormal(mean=0.0, sigma=sigma, size=(n, 3))
    pos = (raw % 1.0).astype(np.float32)
    alive = np.tile(np.arange(n_local) < int(fill * n_local), grid.nranks)
    return pos, alive


def pick_layout(grid_shape):
    """Map an R-rank Cartesian grid onto the devices: the port runs on
    one device, so the whole grid runs as vrank slabs of a one-rank
    device grid. Returns ``(dev_grid, vgrid, n_chips)`` (the reference
    returns its mesh too)."""
    return ProcessGrid((1,) * len(grid_shape)), ProcessGrid(grid_shape), 1


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


def segdep_edge_streams(tile: int, rng):
    """Key streams that put runs across the segmented deposit's tile
    edges (``tile`` rows a tile), each ``(keys int32 [N], n_cells)`` with
    valid keys non-decreasing and the sentinel ``n_cells``:

    - ``run_spans_tiles``: one cell's run starts mid-tile and covers
      three more tiles;
    - ``runs_end_at_tile_ends``: run boundaries on tile ends, runs of one
      row and of a whole tile, a sentinel run ending on a tile end;
    - ``sentinel_tile_between_slabs``: two per-slab sorts (vrank-major
      keys) with more than a whole tile of sentinels between them;
    - ``all_sentinel``: no valid row;
    - ``empty_canvas_ends``: valid keys only in the middle of the canvas,
      sentinels scattered through the stream."""
    t = tile
    streams = {}
    streams["run_spans_tiles"] = (np.concatenate([
        np.sort(rng.integers(0, 20, t // 2)), np.full(3 * t + 5, 30),
        np.sort(rng.integers(31, 64, t)),
    ]), 64)
    lengths = [t, t // 2, t // 2, 1, t - 1, 2 * t, t]
    keys = np.repeat(np.asarray([3, 5, 6, 7, 8, 9, 64]), lengths)
    streams["runs_end_at_tile_ends"] = (
        np.concatenate([keys, np.sort(rng.integers(10, 64, t + 7))]), 64
    )
    streams["sentinel_tile_between_slabs"] = (np.concatenate([
        np.sort(rng.integers(0, 32, t - 300)), np.full(t + t // 2, 64),
        np.sort(rng.integers(32, 64, t)), np.full(5, 64),
    ]), 64)
    streams["all_sentinel"] = (np.full(2 * t + 3, 64), 64)
    n = 3 * t
    keys = np.sort(rng.integers(100, 3000, n))
    streams["empty_canvas_ends"] = (
        np.where(rng.random(n) < 0.2, 4096, keys), 4096
    )
    return {k: (v.astype(np.int32), c) for k, (v, c) in streams.items()}
