"""The inputs of a run, made from ``--seed`` on the device.

A copy of the program's ``bench/common.uniform_state``, frozen here and
drawn with a ``torch.Generator`` on the run's device in a few large calls:
every live particle uniform in the cell of the slab that holds it,
velocities uniform in ``[-vel_scale, vel_scale]`` per axis, the first
``fill * n_local`` slots of each slab alive. Rows come out planar, as the
loop takes them: ``pos [3, m]`` and ``vel [3, m]`` float32 and ``alive
[m]`` bool for the ``m = V * n_local`` slots of one card. A card's rows
depend only on the seed and the card's rank, so the reference makes the
same rows again after the window.
"""

from __future__ import annotations

import torch

from benchmark.spec import Cell

_SEED_MIX = 0x9E3779B97F4A7C15


def card_seed(seed: int, rank: int) -> int:
    """The generator seed of card ``rank``: any whole ``seed`` (negative or
    beyond 64 bits too) mixed with the rank into 63 bits."""
    return (int(seed) * _SEED_MIX + int(rank) * 0xBF58476D1CE4E5B9) % (1 << 63)


def card_state(cell: Cell, seed: int, rank: int, device):
    """``(pos [3, m], vel [3, m], alive [m])`` of card ``rank``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(card_seed(seed, rank))
    V, n = cell.V, cell.n_local
    m = V * n
    cells = torch.as_tensor(cell.slab_cells()[rank * V:(rank + 1) * V].T,
                            dtype=torch.float32, device=device)  # [3, V]
    g = torch.tensor(cell.grid, dtype=torch.float32, device=device)[:, None]
    u = torch.rand((3, V, n), generator=gen, device=device)
    pos = (cells[:, :, None] / g[:, :, None] + u / g[:, :, None]).reshape(3, m)
    scale = torch.tensor(cell.vel_scale, dtype=torch.float32,
                         device=device)[:, None]
    w = torch.rand((3, m), generator=gen, device=device)
    vel = scale * (w * 2.0 - 1.0)
    alive = (torch.arange(n, device=device) < cell.live_per_slab).repeat(V)
    return pos.contiguous(), vel.contiguous(), alive
