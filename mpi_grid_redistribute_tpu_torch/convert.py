"""Carry state between the JAX package and this port as numpy arrays.

The JAX side hands over (and takes back) plain numpy arrays; this module
turns them into the port's tensors and back, bit for bit. It imports
nothing of the JAX package: a JAX array becomes numpy with
``numpy.asarray`` on the caller's side.

  * planar particle state: ``pos``/``vel`` float32 ``[D * N]`` (or
    ``[D, N]``) and ``alive`` bool ``[N]``, as ``make_migrate_loop``
    takes and returns them;
  * a ``MigrateState``: ``fused`` int32 ``[K, V * n]``, ``free_stack``
    int32 ``[V, n]``, ``n_free`` int32 ``[V]``;
  * across ranks, a global array of the reference as the shard each rank
    holds, and back: row-sharded ``[R * n, ...]``, lane-sharded planar
    ``[K, R * n]``, the loop's planar flat ``[D * N]``, a density sharded
    over the grid axes, and the ``[R]`` stats.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch import _device
from mpi_grid_redistribute_tpu_torch.parallel.migrate import MigrateState

_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def to_tensor(a, device=None) -> torch.Tensor:
    """numpy array (float32, int32 or bool) -> tensor on ``device``
    (``None``: the GPU), same dtype and bits. Always a copy: the port
    updates its state in place, so it never aliases the caller's array."""
    a = np.array(a, copy=True, order="C")
    if a.dtype not in _DTYPES:
        raise TypeError(f"convert: unsupported dtype {a.dtype}")
    return torch.from_numpy(a).to(_device.resolve(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor on any device -> numpy array, same dtype and bits."""
    return t.detach().cpu().numpy()


def planar_to_torch(pos, vel, alive, device=None):
    """Planar ``pos``/``vel``/``alive`` numpy arrays -> tensors."""
    return (to_tensor(np.asarray(pos, np.float32), device),
            to_tensor(np.asarray(vel, np.float32), device),
            to_tensor(np.asarray(alive, np.bool_), device))


def planar_to_numpy(pos, vel, alive):
    """Inverse of :func:`planar_to_torch`."""
    return to_numpy(pos), to_numpy(vel), to_numpy(alive)


def migrate_state_to_torch(fused, free_stack, n_free,
                           device=None) -> MigrateState:
    """A JAX ``MigrateState``'s leaves (as numpy) -> the port's
    :class:`MigrateState`."""
    leaves = []
    for name, a in (("fused", fused), ("free_stack", free_stack),
                    ("n_free", n_free)):
        a = np.asarray(a)
        if a.dtype != np.int32:
            raise TypeError(f"convert: {name} must be int32, got {a.dtype}")
        leaves.append(to_tensor(a, device))
    return MigrateState(*leaves)


def migrate_state_to_numpy(state: MigrateState):
    """Inverse of :func:`migrate_state_to_torch`: ``(fused, free_stack,
    n_free)`` numpy arrays."""
    return tuple(to_numpy(x) for x in state)


# ---- the reference's global arrays as per-rank shards, and back --------
#
# The reference holds one global array sharded over its device mesh; the
# port holds shard r on rank r. These helpers are the one place that
# maps between the two (numpy arrays or tensors alike).


def split_rows(a, R: int) -> list:
    """Row-sharded ``[R * n, ...]`` (the reference's ``P(axes)`` on the
    leading axis, or its ``[R]`` counters) -> ``R`` shards ``[n, ...]``."""
    if a.shape[0] % R:
        raise ValueError(f"{a.shape[0]} rows do not split over {R} ranks")
    n = a.shape[0] // R
    return [a[r * n:(r + 1) * n] for r in range(R)]


def join_rows(shards):
    """Inverse of :func:`split_rows`."""
    if isinstance(shards[0], torch.Tensor):
        return torch.cat(list(shards))
    return np.concatenate(list(shards))


def split_lanes(a, R: int) -> list:
    """Lane-sharded planar ``[K, R * n]`` (``P(None, axes)``) -> ``R``
    shards ``[K, n]``."""
    if a.shape[-1] % R:
        raise ValueError(f"{a.shape[-1]} lanes do not split over {R} ranks")
    n = a.shape[-1] // R
    return [a[..., r * n:(r + 1) * n] for r in range(R)]


def join_lanes(shards):
    """Inverse of :func:`split_lanes`."""
    if isinstance(shards[0], torch.Tensor):
        return torch.cat(list(shards), dim=-1)
    return np.concatenate(list(shards), axis=-1)


def split_flat(a, R: int) -> list:
    """The loop's planar flat ``[D * N]`` (shard-major: each rank's ``D``
    component rows one after the other) -> ``R`` flat shards."""
    return [x.reshape(-1) for x in split_rows(a.reshape(R, -1), R)]


def split_grid(a, grid_shape) -> list:
    """A mesh sharded over the grid axes (``P(*axes)``: the density of a
    fully periodic domain) -> each rank's block, in rank order."""
    grid_shape = tuple(grid_shape)
    R = int(np.prod(grid_shape))
    strides = [int(np.prod(grid_shape[a + 1:])) for a in range(len(
        grid_shape))]
    out = []
    for r in range(R):
        cell = [(r // s) % g for s, g in zip(strides, grid_shape)]
        out.append(a[tuple(slice(c * (m // g), (c + 1) * (m // g))
                           for c, m, g in zip(cell, a.shape, grid_shape))])
    return out


def split_stats(stats, R: int, axis: int = 0) -> list:
    """A global stats record (NamedTuple of arrays with the rank axis
    ``axis``: 0 for a call's ``[R]``/``[R, R]`` leaves, the loop's
    ``[S, R]`` leaves take 1) -> each rank's rows, the per-rank function's
    view (``None`` leaves stay ``None``)."""
    def one(leaf, r):
        if leaf is None:
            return None
        n = leaf.shape[axis] // R
        idx = [slice(None)] * leaf.ndim
        idx[axis] = slice(r * n, (r + 1) * n)
        return leaf[tuple(idx)]

    return [type(stats)(*(one(leaf, r) for leaf in stats)) for r in range(R)]
