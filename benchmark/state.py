"""The inputs of a run, made from ``--seed`` on the device.

Drawn with a ``torch.Generator`` on the run's device in a few large calls.
Rows come out planar, as the loop takes them: ``pos [3, m]`` and ``vel
[3, m]`` float32 and ``alive [m]`` bool for the ``m = V * n_local`` slots
of one card. A card's rows depend only on the seed and the card's rank,
so the reference makes the same rows again after the window.

* Uniform rows (:func:`card_state`): a copy of the program's
  ``bench/common.uniform_state``, frozen here: every live particle
  uniform in the cell of the slab that holds it, velocities uniform in
  ``[-vel_scale, vel_scale]`` per axis, the first ``fill * n_local``
  slots of each slab alive.
* Clustered rows (:func:`lognormal_state`, a configuration's ``rows``):
  as ``bench/config2_clustered`` draws them, ``lognormal(mu, sigma) % 1``
  per axis, velocities uniform in ``[-vel_scale, vel_scale]``; the cells
  of the ``cells`` grid go to the slabs by LPT of this draw's own cell
  histogram, and each row to the head of the slab its cell is assigned
  to, in the order drawn. Before every call of the loop :func:`turn`
  turns around the particles that are due, so that they swing back and
  forth as bound matter does, each with a period and a phase of its own.

:func:`draw` picks by the configuration and returns the cell too: under
an assignment, completed with the assignment and the exchange's sizes.

* Snapshots of the one-shot call (:func:`snapshots`, a configuration's
  ``entry`` ``"redistribute"``): rows in the caller's layout, as each
  rank reads a block of a file, a few of them drawn anew before every
  call (:class:`Edits`); see there.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark import reference, spec
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


def lognormal_state(cell: Cell, seed: int, rank: int, device):
    """``(cell, pos [3, m], vel [3, m], alive [m])`` of the clustered rows
    of card ``rank``; ``cell`` completed with its assignment, ``capacity``
    and ``budget``. Raises if a slab would hold more rows than its
    slots."""
    gen = torch.Generator(device=device)
    gen.manual_seed(card_seed(seed, rank))
    N, V, n = cell.live_total, cell.V, cell.n_local
    rows = cell.rows
    x = torch.empty((3, N), dtype=torch.float32, device=device)
    x.log_normal_(float(rows["mu"]), float(rows["sigma"]), generator=gen)
    x.sub_(torch.floor(x))  # % 1, exact
    scale = torch.tensor(cell.vel_scale, dtype=torch.float32,
                         device=device)[:, None]
    w = torch.rand((3, N), generator=gen, device=device)
    v = scale * (w * 2.0 - 1.0)
    del w
    cid = reference.cell_index(cell.cells, x)
    n_cells = math.prod(cell.cells)
    hist = torch.bincount(cid, minlength=n_cells).cpu().numpy()
    assign = spec.lpt_assignment(hist, V)
    owner = torch.as_tensor(assign, dtype=torch.int64, device=device)[cid]
    del cid
    k = torch.bincount(owner, minlength=V)
    hot = int(k.max())
    if hot > n:
        raise ValueError(f"{cell.name}: seed {seed} puts {hot} rows on a "
                         f"slab of {n} slots")
    # one stable sort by owner; each slab's rows fill its head in order
    o, order = torch.sort(owner, stable=True)
    del owner
    start = torch.cumsum(k, 0) - k
    dest = o * n + torch.arange(N, device=device) - start[o]
    del o
    m = V * n
    pos = torch.zeros((3, m), dtype=torch.float32, device=device)
    pos[:, dest] = x[:, order]
    del x
    vel = torch.zeros((3, m), dtype=torch.float32, device=device)
    vel[:, dest] = v[:, order]
    del v, order
    alive = torch.zeros((m,), dtype=torch.bool, device=device)
    alive[dest] = True
    cap, budget = spec.hot_slab_sizing(hot, float(cell.traffic["migration"]))
    cell = dataclasses.replace(cell, assignment=assign, capacity=cap,
                               budget=budget)
    return cell, pos, vel, alive


def turn(vel: torch.Tensor, call: int, turn_calls: int) -> None:
    """Before call ``call`` of the loop, negate in place, on every axis, the
    velocity of each row due to turn (``reference.turn_schedule``: a row's
    period and phase follow from the low 12 bits of its x velocity's bit
    pattern). ``vel`` is planar, ``[3, m]`` or flat ``[3 * m]``. The rule
    is tabled over the 4,096 keys, so a turn is a mask, a gather and a
    multiply by ``-1.0`` or ``1.0``, which changes the sign bit alone,
    zeros' too."""
    v = vel.view(3, -1)
    key = torch.arange(4096, dtype=torch.int32, device=v.device)
    period = turn_calls + (key & 15)
    sign = torch.where((((key >> 4) % period) + call) % period == 0,
                       -1.0, 1.0)
    v.mul_(sign[v[0].view(torch.int32) & 4095])


def draw(cell: Cell, seed: int, rank: int, device):
    """``(cell, pos, vel, alive)`` of card ``rank``: the cell as given for
    uniform rows, completed for clustered ones."""
    if cell.rows is None:
        return (cell,) + card_state(cell, seed, rank, device)
    return lognormal_state(cell, seed, rank, device)


def snapshots(cell: Cell, seed: int, device) -> list:
    """The traffic's ``snapshots`` inputs of the one-shot call, each
    ``(pos [R * n, 3], vel [R * n, 3], count [R])``: float32 rows in the
    caller's layout (rank ``r`` in rows ``[r * n, (r + 1) * n)``) and int32
    counts. Every rank holds ``count = fill * n`` live rows and zeros after
    them; its live rows lie uniform over the whole unit box, as when each
    rank reads a block of a file, and their velocities uniform in
    ``[-vel_scale, vel_scale]``. Drawn one after another from one
    generator, so every seed gives the same sizes."""
    gen = torch.Generator(device=device)
    gen.manual_seed(card_seed(seed, 0))
    R, n, c = cell.n_slabs, cell.n_local, cell.live_per_slab
    scale = float(cell.vel_scale[0])
    count = torch.full((R,), c, dtype=torch.int32, device=device)
    out = []
    for _ in range(int(cell.traffic["snapshots"])):
        pos = torch.rand((R, n, 3), generator=gen, device=device)
        pos[:, c:] = 0.0
        vel = torch.rand((R, n, 3), generator=gen, device=device)
        vel.mul_(2.0 * scale).sub_(scale)
        vel[:, c:] = 0.0
        out.append((pos.reshape(R * n, 3), vel.reshape(R * n, 3), count))
    return out


class Edits:
    """The traffic's change to its input before each call of the one-shot
    call: :meth:`apply` draws anew, in place, the rows ``[j, j + k)`` of
    every rank of the snapshot that call takes (positions uniform over the
    box, velocities uniform in ``[-vel_scale, vel_scale]``), ``k`` the
    traffic's ``edit_rows`` and ``j`` drawn from the seed among the live
    rows. So no call takes an input that an earlier call has seen. The
    edits are drawn in call order from generators seeded once, so making
    them again on the snapshots drawn again, call after call
    (:func:`inputs`), gives each call's input."""

    def __init__(self, cell: Cell, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(card_seed(seed, 1))
        self.rng = np.random.default_rng(card_seed(seed, 2))
        self.R, self.n, self.c = cell.n_slabs, cell.n_local, cell.live_per_slab
        self.k = int(cell.traffic["edit_rows"])
        self.scale = float(cell.vel_scale[0])

    def apply(self, snapshot) -> None:
        pos, vel, _ = snapshot
        R, n, k = self.R, self.n, self.k
        j = int(self.rng.integers(0, self.c - k + 1))
        w = torch.rand((2, R, k, 3), generator=self.gen, device=pos.device)
        pos.view(R, n, 3)[:, j:j + k] = w[0]
        vel.view(R, n, 3)[:, j:j + k] = w[1].mul_(2.0 * self.scale).sub_(
            self.scale)


def inputs(cell: Cell, seed: int, device, calls: int):
    """Yield ``(i, snapshot)`` for the calls ``i < calls``: the input call
    ``i`` took, the snapshot ``i % snapshots`` with every edit up to its
    own made. The snapshot is edited in place for the next call."""
    snaps = snapshots(cell, seed, device)
    edits = Edits(cell, seed, device)
    for i in range(calls):
        snap = snaps[i % len(snaps)]
        edits.apply(snap)
        yield i, snap
