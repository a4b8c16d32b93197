"""The plain reference the timed path is judged against, in PyTorch.

It imports nothing of the program. From the same seed it makes the same
rows (:mod:`.state`), follows each particle through every step the program
ran, and says where each one must be and what the density is:

* drift and wrap: ``p = wrap(p + v * dt)`` in float32, the product and the
  sum as two roundings, ``wrap(x) = x - floor(x)`` and a result that
  rounds to 1 folded to 0 (the periodic unit box); clustered rows turn
  around with periods and phases of their own (:class:`Drift`,
  :func:`turn_schedule`);
* ownership: a particle belongs to grid cell ``clip(floor(x * g), 0, g-1)``
  on each axis, and so to the slab that holds that cell; under an
  assignment, to cell ``clip(floor(x * c), 0, c-1)`` of the ``cells`` grid
  and so to the slab the assignment gives it;
* density: cloud-in-cell onto nodes ``i / M`` of the periodic ``M^3``
  mesh, unit mass, each particle giving ``prod(1 - f)`` or ``prod(f)`` to
  the 8 nodes around it, summed in float64.

* the one-shot call's receive order (:func:`receive_order`): each rank
  receives the rows it owns in MPI ``Alltoallv`` order, source ranks
  ascending and each source's rows in input order; that is one stable
  sort by owner of the live rows taken in (source, index) order.

:func:`digests` condenses a set of rows into one count and one 64-bit
fingerprint a slab: the sum (wrapping) of a mixing hash of each row's six
float32 bit patterns, so the fingerprint of a slab does not depend on the
order of its rows, and those of the cards add up to the whole.

``precision="bf16"`` is the control: the same arithmetic rounded through
bfloat16, the nearest precision below the float32 the configuration
states. It has to come out not correct. The one-shot call's control bins
positions rounded to bfloat16 (``receive_order(bin_pos=...)``).
"""

from __future__ import annotations

import itertools

import torch

from benchmark.spec import Cell

# odd 64-bit multipliers of the row hash, as signed int64
_MIX = tuple(m - (1 << 64) if m >= 1 << 63 else m for m in (
    0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
    0xD6E8FEB86659FD93, 0xFF51AFD7ED558CCD, 0xC4CEB9FE1A85EC53))
BLOCK = 1 << 24  # rows a block, to bound the temporaries


def wrap_unit(x: torch.Tensor) -> torch.Tensor:
    """``x - floor(x)`` in place, a result of 1 folded to 0. A zero comes
    out ``+0.0`` whatever its sign (``-0.0 - floor(-0.0)`` is ``+0.0``
    under round to nearest), as from the program's wrap; the fingerprint
    hashes bit patterns, so the sign of a zero counts."""
    x.sub_(torch.floor(x))
    return x.masked_fill_(x >= 1.0, 0.0)


def turn_schedule(vx: torch.Tensor, turn_calls: int):
    """``(period, phase)``, ``[n]`` each, of the rows of a clustered
    deployment, from the low 12 bits of each row's x velocity's float32 bit
    pattern, which a turn (a change of sign) leaves as they are: the
    period is ``turn_calls + (bits & 15)`` calls, the phase ``((bits >> 4)
    & 255) % period``. A row turns before call ``c`` when ``(c + phase) %
    period == 0``."""
    b = vx.contiguous().view(torch.int32)
    period = turn_calls + (b & 15)
    return period, ((b >> 4) & 255) % period


class Drift:
    """Every particle of some rows, followed step by step. With
    ``turn_calls`` (clustered rows) a particle turns around, its velocity
    negated on every axis, before the calls of the loop (``steps_per_call``
    steps each; call 0 the first warm call) that its
    :func:`turn_schedule` names: it swings back and forth, each particle
    with a period and a phase of its own."""

    def __init__(self, pos, vel, alive, dt: float, precision: str = "f32",
                 turn_calls: int = None, steps_per_call: int = 1):
        if precision not in ("f32", "bf16"):
            raise ValueError(f"precision {precision!r}: 'f32' or 'bf16'")
        self.precision = precision
        self.turn_calls, self.S = turn_calls, steps_per_call
        keep = alive.nonzero().squeeze(1)
        self.pos = pos[:, keep].contiguous()
        self.vel = vel[:, keep].contiguous()
        dt = torch.tensor(dt, dtype=torch.float32, device=pos.device)
        if precision == "bf16":
            self.pos = self.pos.bfloat16().float()
            self.vdt = (self.vel.bfloat16() * dt.bfloat16()).float()
        else:
            self.vdt = self.vel * dt
        if turn_calls is not None:
            self.period, self.phase = turn_schedule(self.vel[0], turn_calls)
        self.steps = 0

    def _turn(self) -> None:
        due = (self.phase + self.steps // self.S) % self.period == 0
        self.vel = torch.where(due, -self.vel, self.vel)
        self.vdt = torch.where(due, -self.vdt, self.vdt)

    def advance(self, steps: int) -> None:
        for _ in range(steps):
            if self.turn_calls and self.steps % self.S == 0:
                self._turn()
            if self.precision == "bf16":
                q = (self.pos.bfloat16() + self.vdt.bfloat16())
                q = q - torch.floor(q)
                self.pos = q.float().masked_fill_(q.float() >= 1.0, 0.0)
            else:
                self.pos.add_(self.vdt)
                wrap_unit(self.pos)
            self.steps += 1


def cell_index(shape, pos: torch.Tensor) -> torch.Tensor:
    """``[n]`` int64 row-major cell of the grid ``shape`` holding each
    position of ``pos [3, n]``: ``clip(floor(x * g), 0, g - 1)`` on each
    axis, in float32."""
    idx = torch.zeros(pos.shape[1], dtype=torch.int64, device=pos.device)
    acc = 1
    for a in reversed(range(3)):
        g = shape[a]
        c = torch.floor(pos[a] * float(g)).to(torch.int64).clamp_(0, g - 1)
        idx += c * acc
        acc *= g
    return idx


def owner_slab(cell: Cell, pos: torch.Tensor) -> torch.Tensor:
    """``[n]`` int64 slab owning each position of ``pos [3, n]``: the slab
    of its grid cell, or under an assignment the slab its cell of the
    ``cells`` grid is assigned to."""
    shape = cell.grid if cell.cells is None else cell.cells
    table = torch.as_tensor(cell.slab_of_cell_table(), device=pos.device)
    return table[cell_index(shape, pos)]


def row_hash(pos: torch.Tensor, vel: torch.Tensor) -> torch.Tensor:
    """``[n]`` int64 mixing hash of the bit patterns of ``pos``/``vel``
    ``[3, n]`` float32."""
    words = torch.cat([pos, vel]).contiguous().view(torch.int32)
    h = torch.zeros(words.shape[1], dtype=torch.int64, device=pos.device)
    for c in range(6):
        w = words[c].to(torch.int64) & 0xFFFFFFFF
        h = (h ^ w) * _MIX[c]
        h = h ^ (h >> 29)
    return h


def row_hashes(pos: torch.Tensor, vel: torch.Tensor) -> torch.Tensor:
    """:func:`row_hash` of row-major ``pos``/``vel`` ``[n, 3]``, in blocks."""
    out = torch.empty(pos.shape[0], dtype=torch.int64, device=pos.device)
    for b in range(0, pos.shape[0], BLOCK):
        out[b:b + BLOCK] = row_hash(pos[b:b + BLOCK].T, vel[b:b + BLOCK].T)
    return out


def rank_slabs(cell: Cell) -> list:
    """The slab of each rank ``r`` of the one-shot call. Ranks take the
    grid's cells in MPI's Cartesian order, row-major with the last axis
    fastest (``MPI_Cart_coords``): rank ``r`` holds the cell whose
    row-major index is ``r``."""
    return [int(s) for s in cell.slab_of_cell_table()]


def receive_order(cell: Cell, pos, vel, count, bin_pos=None):
    """``(pos [N, 3], vel [N, 3], slab_counts [n_slabs])``: the ``N`` live
    rows of a one-shot input (``pos``/``vel`` ``[R * n, 3]``, block ``r``
    the source rank ``r``'s ``n`` slots, its first ``count[r]`` live) as
    the slabs receive them: grouped by owning slab in slab order, each
    slab's rows in (source, index) order. ``bin_pos`` (the control) gives
    the positions the owners are taken from; the rows moved are
    ``pos``'s."""
    n = cell.n_local
    slots = torch.arange(n, device=pos.device)
    live = (slots < count.to(pos.device)[:, None]).reshape(-1)
    idx = live.nonzero().squeeze(1)
    del live
    where = pos if bin_pos is None else bin_pos
    owner = torch.empty(idx.shape[0], dtype=torch.int64, device=pos.device)
    for b in range(0, idx.shape[0], BLOCK):
        owner[b:b + BLOCK] = owner_slab(cell, where[idx[b:b + BLOCK]].T)
    order = torch.sort(owner, stable=True).indices
    counts = torch.bincount(owner, minlength=cell.n_slabs)
    del owner
    idx = idx[order]
    del order
    return pos[idx], vel[idx], counts


def digests(pos, vel, slab, n_slabs: int):
    """``(count [n_slabs], fingerprint [n_slabs])`` int64 of the rows
    ``pos``/``vel`` ``[3, n]`` placed on slabs ``slab [n]``."""
    dev = pos.device
    count = torch.zeros(n_slabs, dtype=torch.int64, device=dev)
    fp = torch.zeros(n_slabs, dtype=torch.int64, device=dev)
    for b in range(0, pos.shape[1], BLOCK):
        s = slab[b:b + BLOCK]
        count.index_add_(0, s, torch.ones_like(s))
        fp.index_add_(0, s, row_hash(pos[:, b:b + BLOCK], vel[:, b:b + BLOCK]))
    return count, fp


def cic_density(pos: torch.Tensor, mesh, dtype=torch.float64):
    """Cloud-in-cell density of unit masses at ``pos [3, n]`` (float32)
    onto the periodic ``mesh`` node grid, accumulated in ``dtype``."""
    M = tuple(int(m) for m in mesh)
    rho = torch.zeros(M[0] * M[1] * M[2], dtype=dtype, device=pos.device)
    for b in range(0, pos.shape[1], BLOCK):
        p = pos[:, b:b + BLOCK].to(dtype)
        base, frac = [], []
        for a in range(3):
            r = p[a] * M[a]
            i0 = torch.floor(r).clamp_(0, M[a] - 1)
            frac.append((r - i0).clamp_(0.0, 1.0))
            base.append(i0.to(torch.int64))
        for corner in itertools.product((0, 1), repeat=3):
            w = None
            node = None
            for a in range(3):
                t = frac[a] if corner[a] else 1.0 - frac[a]
                w = t if w is None else w * t
                i = (base[a] + corner[a]) % M[a]
                node = i if node is None else node * M[a] + i
            rho.index_add_(0, node, w)
    return rho.reshape(M)
