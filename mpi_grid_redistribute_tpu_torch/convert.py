"""Carry state between the JAX package and this port as numpy arrays.

The JAX side hands over (and takes back) plain numpy arrays; this module
turns them into the port's tensors and back, bit for bit. It imports
nothing of the JAX package: a JAX array becomes numpy with
``numpy.asarray`` on the caller's side.

  * planar particle state: ``pos``/``vel`` float32 ``[D * N]`` (or
    ``[D, N]``) and ``alive`` bool ``[N]``, as ``make_migrate_loop``
    takes and returns them;
  * a ``MigrateState``: ``fused`` int32 ``[K, V * n]``, ``free_stack``
    int32 ``[V, n]``, ``n_free`` int32 ``[V]``.
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
