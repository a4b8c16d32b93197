"""Halo / ghost-particle exchange (port of the JAX package's
``parallel/halo.py``: the single-device vrank engines and the multi-rank
ones).

Stencil codes (short-range forces, SPH, CIC with force interpolation)
need copies of the neighbour shards' particles within ``halo_width`` of
each subdomain face. The exchange runs two passes per axis: take a
snapshot of the rank's own rows plus the ghosts received on earlier
axes, select the rows within the width of the hi and lo faces, send each
selection one step along the axis (+1, then -1) and append what arrives.
Ghosts received on an earlier axis take part in later axes' passes, so
edge and corner ghosts arrive in at most ``ndim`` hops with ``2 * ndim``
sends. Crossing a periodic wrap shifts the ghost's coordinate by the
extent, into the receiver's frame. Everything is capacity-padded
(``pass_capacity`` columns a send, ``ghost_capacity`` in all) with the
overflow counted per rank and returned, never dropped silently.

The V ranks of the grid are virtual ranks on one device: the leading
batch dimension of every tensor, and the send along axis ``a`` is the
roll of the grid-shaped rank axis that the wire would perform (receiver
``j`` gets sender ``j - dirn``). Two engines give the same ghost set, in
the same order, with the same bits:

  * :func:`vrank_halo_planar_fn` (what ``GridRedistribute.halo`` runs
    when every array is 32-bit): ``[V, K, n]`` int32 columns, one packed
    sort per axis when the two face bands cannot overlap, contiguous
    block appends into a ghost buffer with a scratch tail;
  * :func:`vrank_halo_fn`: row-major ``[V, n, ...]`` arrays of any dtype,
    two sorts per axis, row appends.

Where the bits are decided (each pinned by ``tests/test_torch_halo.py``):

  * the face thresholds are float32 values built in separate rounded
    steps, ``lo_a = lo + coord * cell_w``, ``hi_a = lo_a + cell_w``, then
    ``hi_a - w`` and ``lo_a + w``; a fused multiply-add would change them;
  * the frame shift is an add on every selected row, also where the
    shift is zero: ``-0.0 + 0.0`` is ``+0.0``. One exception, kept from
    the reference: on an open axis the planar engine's shift is zero for
    every rank when the program is built, the reference's compiler folds
    its ``x + 0`` to ``x``, and a -0.0 face coordinate keeps its sign
    there, while the row-major engine's add (a scatter-add) still runs
    (``ROADMAP.md`` C7);
  * each vrank's windows (the second band of the banded order, the start
    of an append) begin at a count computed on the device; they are
    gathers and scatters with device indices, so an exchange makes no
    host sync.

Across ranks (one rank a process over a :class:`~.mesh.RankMesh`) the
same passes run on the rank's own columns or rows, its cell coordinate
taking the place of the vrank's, and each send is one ``ppermute`` to
the neighbour along the axis (:func:`shard_halo_planar_fn`,
:func:`shard_halo_fn`); the global forms :func:`build_halo_planar` and
:func:`build_halo_exchange` return the rank's ghosts with the ghost
counts and overflow of every rank gathered. The -0.0 rule above holds
there too: the reference's shard engines keep the sign on an open axis
(planar) and turn it to +0.0 (row-major), as its vrank engines do.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch

from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops.pack import (
    _mask_rows, _stable_order, _take, _take_cols, _take_rows,
)
from mpi_grid_redistribute_tpu_torch.parallel import collectives as col
from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib
from mpi_grid_redistribute_tpu_torch.parallel.exchange import _WORD

# bits of a rank-axis iota that fit one int32 word beside a 2-bit band;
# past it the banded order is one stable sort of the band
_BAND_PACK_BITS = 29


class HaloResult(NamedTuple):
    """Global ghost buffers: positions ``[R * ghost_capacity, D]``
    (shifted into the receiver's frame across periodic wraps), per-rank
    ghost counts ``[R]``, the carried fields, and the per-rank overflow
    counter ``[R]``."""

    ghost_positions: object
    ghost_count: object
    ghost_fields: Tuple
    overflow: object


def _as_per_axis(width, ndim: int) -> Tuple[float, ...]:
    if isinstance(width, (int, float)):
        return (float(width),) * ndim
    t = tuple(float(w) for w in width)
    if len(t) != ndim:
        raise ValueError(f"halo_width must have {ndim} entries, got {len(t)}")
    return t


def _validate_widths(domain: Domain, grid: ProcessGrid, halo_width):
    ndim = domain.ndim
    widths = _as_per_axis(halo_width, ndim)
    cell_w = grid.cell_widths(domain)
    for a in range(ndim):
        if widths[a] < 0:
            raise ValueError(f"halo_width[{a}] must be >= 0")
        if widths[a] > cell_w[a]:
            raise ValueError(
                f"halo_width[{a}]={widths[a]} exceeds subdomain width "
                f"{cell_w[a]}; multi-hop halos are not supported"
            )
    return widths, cell_w


def default_capacities(
    domain: Domain,
    grid: ProcessGrid,
    halo_width,
    n_local: int,
    headroom: float = 2.0,
) -> Tuple[int, int]:
    """Derived ``(pass_capacity, ghost_capacity)`` for near-uniform density.

    ``n_local`` is the PADDED per-rank row count (``positions.shape[0] //
    R``), not the valid count. Per axis the face-shell fraction is ``f_a =
    w_a / cell_w_a`` a direction; a pass along axis ``a`` selects from own
    rows plus the ghosts of earlier axes, so its expected send is
    ``n_local * f_a * prod_{b<a}(1 + 2 f_b)``, and the shell population is
    ``n_local * (prod_a(1 + 2 f_a) - 1)``. Both are padded by ``headroom``
    and rounded up to a multiple of 8. Clustered inputs can exceed them:
    the exchange counts the overflow per rank.
    """
    widths, cell_w = _validate_widths(domain, grid, halo_width)
    if n_local <= 0:
        raise ValueError(f"n_local must be positive, got {n_local}")
    f = [w / cw for w, cw in zip(widths, cell_w)]
    pass_cap = 0.0
    grown = 1.0
    for a in range(domain.ndim):
        pass_cap = max(pass_cap, n_local * f[a] * grown)
        grown *= 1.0 + 2.0 * f[a]
    ghost_cap = n_local * (grown - 1.0)

    def pad(x: float) -> int:
        return max(8, int(math.ceil(x * headroom / 8.0)) * 8)

    return pad(pass_cap), pad(ghost_cap)


def _fill(value, dtype, device) -> torch.Tensor:
    """A 0-d constant made on the device (no host-to-device copy)."""
    return torch.full((), value, dtype=dtype, device=device)


def _vrank_coords(grid: ProcessGrid):
    """``coord_of(a, device) -> [V]``: the row-major cell coordinate of
    every vrank along axis ``a``."""
    def coord_of(a: int, device):
        ranks = torch.arange(grid.nranks, dtype=torch.int32, device=device)
        return (ranks // grid.strides[a]) % grid.shape[a]

    return coord_of


def _rank_coords(mesh):
    """``coord_of(a, device) -> [1]``: this rank's cell coordinate along
    axis ``a`` (``lax.axis_index`` of the axis)."""
    def coord_of(a: int, device):
        return torch.full((1,), mesh.coords[a], dtype=torch.int32,
                          device=device)

    return coord_of


def _bounds_at(domain: Domain, a: int, cell_w_a: float, coord, dtype):
    """``(lo_a, hi_a)`` of the ranks at cell coordinates ``coord`` along
    axis ``a``: the float thresholds in two rounded steps (``lo + coord *
    cell_w``, then ``+ cell_w``), never fused."""
    device = coord.device
    cw = _fill(cell_w_a, dtype, device)
    lo_a = _fill(domain.lo[a], dtype, device) + coord.to(dtype) * cw
    return lo_a, lo_a + cw


def _frame_shift(at_edge: torch.Tensor, periodic: bool, dirn: int,
                 extent_a: torch.Tensor) -> torch.Tensor:
    """Per-vrank shift into the receiver's frame: ``-dirn * extent``
    across a periodic wrap, else zero."""
    step = -_fill(dirn, extent_a.dtype, extent_a.device) * extent_a
    return torch.where(at_edge & periodic, step, _fill(0, extent_a.dtype,
                                                       extent_a.device))


def _roll_wire(grid: ProcessGrid):
    """The vrank wire: receiver ``j`` gets sender ``j - dirn`` along grid
    axis ``a`` (the reference's ``jnp.roll`` of the grid-shaped rank
    axis)."""
    def wire(x: torch.Tensor, dirn: int, a: int):
        shaped = x.reshape(grid.shape + tuple(x.shape[1:]))
        return torch.roll(shaped, dirn, dims=a).reshape(x.shape)

    return wire


def _ppermute_wire(grid: ProcessGrid, mesh):
    """The multi-rank wire: this rank's ``[1, ...]`` send goes one step
    along the axis (:func:`~.mesh.axis_shift_perm`), one ``ppermute`` a
    send."""
    perms = {(a, d): mesh_lib.axis_shift_perm(grid, a, d)
             for a in range(grid.ndim) for d in (1, -1)}

    def wire(x: torch.Tensor, dirn: int, a: int):
        return col.ppermute(x, mesh, perms[(a, dirn)])

    return wire


def _band_mask(coord, valid, dirn, lo_a, hi_a, w):
    """``[V, m]`` valid rows within ``w`` of the hi face (``dirn`` 1:
    ``coord >= hi_a - w``) or the lo face (-1: ``coord < lo_a + w``), each
    threshold one rounded op on the per-vrank bounds ``[V]``."""
    if dirn == 1:
        return valid & (coord >= (hi_a - w)[:, None])
    return valid & (coord < (lo_a + w)[:, None])


def _select_for_pass(cand, cand_valid, a, dirn, lo_a, hi_a, w, at_edge,
                     periodic, extent_a, H):
    """Row-major outgoing selection of one (axis, direction), batched over
    V: the valid candidate rows within ``w`` of the face, stable-packed
    into ``H`` rows (the rest zero), the periodic shift added to the
    face coordinate of every slot (zero on empty slots). ``cand`` is the
    tuple ``(pos words, *field words)``, ``[V, m, ...]``; positions are
    read through their float view ``pos_dtype``. Returns ``(send tuple,
    send_cnt [V], overflow_inc [V])``."""
    pos_dtype = lo_a.dtype
    mask = _band_mask(cand[0].view(pos_dtype)[:, :, a], cand_valid, dirn,
                      lo_a, hi_a, w)
    if not periodic:
        mask = mask & ~at_edge[:, None]
    cnt = mask.sum(dim=1, dtype=torch.int32)
    overflow_inc = (cnt - H).clamp(min=0)
    send_cnt = cnt.clamp(max=H)
    take = _take_rows(_stable_order(~mask), H)
    slot_valid = torch.arange(H, dtype=torch.int32,
                              device=mask.device) < send_cnt[:, None]
    send = [_mask_rows(_take(arr, take), slot_valid) for arr in cand]
    shift = _frame_shift(at_edge, periodic, dirn, extent_a)
    pos = send[0].view(pos_dtype).clone()
    pos[:, :, a] = pos[:, :, a] + torch.where(
        slot_valid, shift[:, None], _fill(0, pos_dtype, pos.device))
    send[0] = pos.view(send[0].dtype)
    return tuple(send), send_cnt, overflow_inc


def _append_recv(ghost, gcount, overflow, recv, recv_cnt, H, G):
    """Append a received row-major slab to the ghost buffers ``[V, G + 1,
    ...]``: slot ``j`` goes to row ``gcount + j`` while ``j < recv_cnt``
    and the row is below ``G``; every other slot goes to the scratch row
    ``G`` (the reference drops it with ``mode="drop"``), which no result
    reads."""
    V = gcount.shape[0]
    dev = gcount.device
    j = torch.arange(H, dtype=torch.int32, device=dev)
    overflow = overflow + (gcount + recv_cnt - G).clamp(min=0)
    row = gcount[:, None] + j
    keep = (j < recv_cnt[:, None]) & (row < G)
    row = torch.where(keep, row, _fill(G, torch.int32, dev))
    flat = (row.long() + torch.arange(V, device=dev)[:, None] * (G + 1))
    out = []
    for gh, rc in zip(ghost, recv):
        rest = tuple(gh.shape[2:])
        gh = gh.reshape((V * (G + 1),) + rest)
        gh.index_copy_(0, flat.reshape(-1), rc.reshape((V * H,) + rest))
        out.append(gh.reshape((V, G + 1) + rest))
    return tuple(out), (gcount + recv_cnt).clamp(max=G), overflow


def _rowmajor_passes(domain: Domain, grid: ProcessGrid, halo_width, H: int,
                     G: int, coord_of, wire):
    """The row-major exchange over a batch of ranks: ``run(pos [B, n, D],
    count [B], *fields [B, n, ...]) -> (ghost_pos [B, G, D], ghost_count
    [B], *ghost_fields, overflow [B])``. ``coord_of(a, device)`` gives
    the batch's cell coordinates along axis ``a`` and ``wire(x, dirn,
    a)`` moves a send one step along it: every vrank of one device (a
    roll) or this rank alone (a ``ppermute``)."""
    widths, cell_w = _validate_widths(domain, grid, halo_width)

    def run(pos, count, *fields):
        V, n = pos.shape[0], pos.shape[1]
        dev = pos.device
        arrays = (pos,) + tuple(fields)
        words = tuple(x.view(_WORD[x.element_size()]) for x in arrays)
        valid = torch.arange(n, dtype=torch.int32,
                             device=dev)[None, :] < count[:, None]
        # one scratch row past G takes the dropped appends
        ghost = tuple(torch.zeros((V, G + 1) + tuple(x.shape[2:]),
                                  dtype=x.dtype, device=dev) for x in words)
        gcount = torch.zeros((V,), dtype=torch.int32, device=dev)
        overflow = torch.zeros((V,), dtype=torch.int32, device=dev)
        g_iota = torch.arange(G, dtype=torch.int32, device=dev)[None, :]

        for a in range(domain.ndim):
            g = grid.shape[a]
            w = _fill(widths[a], pos.dtype, dev)
            extent_a = _fill(domain.extent[a], pos.dtype, dev)
            coord = coord_of(a, dev)
            lo_a, hi_a = _bounds_at(domain, a, cell_w[a], coord, pos.dtype)
            # snapshot before this axis's passes: both directions select
            # from it, so a ghost just received is never bounced back
            cand = tuple(torch.cat([own, gh[:, :G]], dim=1)
                         for own, gh in zip(words, ghost))
            cand_valid = torch.cat([valid, g_iota < gcount[:, None]], dim=1)
            incoming = []
            for dirn in (1, -1):
                at_edge = coord == (g - 1 if dirn == 1 else 0)
                send, send_cnt, ov = _select_for_pass(
                    cand, cand_valid, a, dirn, lo_a, hi_a, w, at_edge,
                    domain.periodic[a], extent_a, H,
                )
                overflow = overflow + ov
                incoming.append((tuple(wire(x, dirn, a) for x in send),
                                 wire(send_cnt, dirn, a)))
            for recv, recv_cnt in incoming:
                ghost, gcount, overflow = _append_recv(
                    ghost, gcount, overflow, recv, recv_cnt, H, G)

        out = tuple(gh[:, :G].view(x.dtype) for gh, x in zip(ghost, arrays))
        return (out[0], gcount) + out[1:] + (overflow,)

    return run


def vrank_halo_fn(
    domain: Domain,
    grid: ProcessGrid,
    halo_width,
    pass_capacity: int,
    ghost_capacity: int,
):
    """Row-major V-rank halo exchange on one device.

    Signature: ``(pos [V, n, D], count [V], *fields [V, n, ...]) ->
    (ghost_pos [V, G, D], ghost_count [V], *ghost_fields, overflow [V])``.
    Fields of any dtype ride along as integer words of their width; the
    ghost arrays keep the inputs' dtypes. Rows past a rank's ghost count
    are zero. Each axis selects from the rank's own rows and all ``G``
    ghost rows (two sorts an axis)."""
    return _rowmajor_passes(domain, grid, halo_width, pass_capacity,
                            ghost_capacity, _vrank_coords(grid),
                            _roll_wire(grid))


# The reference jits and caches these per width tuple; PyTorch runs
# eagerly and the engines normalise the width themselves, so the
# reference's names are the engines.
build_halo_vranks = vrank_halo_fn


def _bands_disjoint(domain: Domain, a: int, widths, cell_w) -> bool:
    """True when axis ``a``'s two face bands cannot overlap even after the
    float32 rounding of their thresholds. ``fl(fl(lo_a + cell_w) - w)``
    and ``fl(lo_a + w)`` each carry up to ~1.5 ulp of the coordinate's
    magnitude, so at exactly ``2w == cell_w`` they can cross by an ulp and
    a row would satisfy both masks. The one-sort path needs ``2w <=
    cell_w - 4 ulp(max |domain coord|)``; anything closer takes the
    two-sort path, which handles overlap. Decided in Python float64."""
    hi_abs = max(
        abs(domain.lo[a]), abs(domain.lo[a] + domain.extent[a])
    )
    margin = 4.0 * 2.0**-23 * max(hi_abs, 1e-30)
    return 2.0 * widths[a] <= cell_w[a] - margin


def _axis_band_order(mask_hi: torch.Tensor, mask_lo: torch.Tensor):
    """One sort ordering the +dir band first, then the -dir band, then
    the rest, by position within each band (``[V, m]`` masks -> int64
    ``[V, m]``). With disjoint bands its first ``cnt_hi`` entries equal
    :func:`_stable_order` of ``mask_hi`` and the next ``cnt_lo`` that of
    ``mask_lo``. A 2-bit band and the position share one int32 key,
    unique, so an unstable sort gives the stable order; past
    ``_BAND_PACK_BITS`` bits of position, one stable sort of the band."""
    m = mask_hi.shape[-1]
    dev = mask_hi.device
    band = torch.where(
        mask_hi, _fill(0, torch.int32, dev),
        torch.where(mask_lo, _fill(1, torch.int32, dev),
                    _fill(2, torch.int32, dev)))
    b = max(1, (m - 1).bit_length())
    if b <= _BAND_PACK_BITS:
        iota = torch.arange(m, dtype=torch.int32, device=dev)
        packed = torch.sort((band << b) | iota, dim=-1).values
        return (packed & ((1 << b) - 1)).long()
    return torch.sort(band, dim=-1, stable=True).indices


def _banded_send_cols(cand, order_window, send_cnt, a, slot_shift, H):
    """One direction's planar send ``[V, K, H]`` int32 from an order
    window: gather ``H`` columns, zero past ``send_cnt``, add the frame
    shift to the face row of every valid slot; ``slot_shift`` None on an
    open axis, where the reference's compiled program adds nothing
    (``ROADMAP.md`` C7)."""
    slot_valid = torch.arange(H, dtype=torch.int32,
                              device=cand.device) < send_cnt[:, None]
    send = torch.where(slot_valid[:, None, :],
                       _take_cols(cand, order_window),
                       _fill(0, torch.int32, cand.device))
    if slot_shift is None:
        return send
    row_a = send[:, a, :].view(torch.float32)
    row_a = torch.where(slot_valid, row_a + slot_shift[:, None], row_a)
    send[:, a, :] = row_a.view(torch.int32)
    return send


def _select_cols_for_pass(cand, cand_valid, a, dirn, lo_a, hi_a, w,
                          at_edge, periodic, extent_a, H):
    """Planar outgoing selection of one (axis, direction), batched over V:
    ``cand [V, K, m]`` int32. Returns ``(send [V, K, H], send_cnt [V],
    overflow_inc [V])``, the columns, order and bits of
    :func:`_select_for_pass`."""
    mask = _band_mask(cand[:, a, :].view(torch.float32), cand_valid, dirn,
                      lo_a, hi_a, w)
    if not periodic:
        mask = mask & ~at_edge[:, None]
    cnt = mask.sum(dim=1, dtype=torch.int32)
    overflow_inc = (cnt - H).clamp(min=0)
    send_cnt = cnt.clamp(max=H)
    take = _take_rows(_stable_order(~mask), H)  # zero-padded past m
    shift = (_frame_shift(at_edge, periodic, dirn, extent_a) if periodic
             else None)
    return (_banded_send_cols(cand, take, send_cnt, a, shift, H), send_cnt,
            overflow_inc)


def _select_cols_for_axis(cand, cand_valid, a, lo_a, hi_a, w,
                          at_edge_hi, at_edge_lo, periodic, extent_a, H):
    """Planar selection of both directions of one axis with one banded
    sort (callers take it only when :func:`_bands_disjoint`); the sends'
    bits equal two :func:`_select_cols_for_pass` calls. Returns
    ``(send_hi, cnt_hi, ov_hi, send_lo, cnt_lo, ov_lo)``."""
    face = cand[:, a, :].view(torch.float32)
    mask_hi = _band_mask(face, cand_valid, 1, lo_a, hi_a, w)
    mask_lo = _band_mask(face, cand_valid, -1, lo_a, hi_a, w)
    if not periodic:
        mask_hi = mask_hi & ~at_edge_hi[:, None]
        mask_lo = mask_lo & ~at_edge_lo[:, None]
    cnt_hi_f = mask_hi.sum(dim=1, dtype=torch.int32)
    cnt_lo_f = mask_lo.sum(dim=1, dtype=torch.int32)
    ov_hi = (cnt_hi_f - H).clamp(min=0)
    ov_lo = (cnt_lo_f - H).clamp(min=0)
    cnt_hi = cnt_hi_f.clamp(max=H)
    cnt_lo = cnt_lo_f.clamp(max=H)
    order = _axis_band_order(mask_hi, mask_lo)
    # the +dir band is the window [0, H); the -dir band starts at each
    # vrank's own cnt_hi_f, a gather with device indices (the zero pad
    # keeps the window inside, so it never clamps short)
    order_pad = torch.cat([order, order.new_zeros((order.shape[0], H))],
                          dim=1)
    take_hi = order_pad[:, :H]
    j = torch.arange(H, dtype=torch.int64, device=cand.device)
    take_lo = torch.gather(order_pad, 1, cnt_hi_f[:, None].long() + j)
    shift_hi = shift_lo = None
    if periodic:
        shift_hi = _frame_shift(at_edge_hi, periodic, 1, extent_a)
        shift_lo = _frame_shift(at_edge_lo, periodic, -1, extent_a)
    send_hi = _banded_send_cols(cand, take_hi, cnt_hi, a, shift_hi, H)
    send_lo = _banded_send_cols(cand, take_lo, cnt_lo, a, shift_lo, H)
    return send_hi, cnt_hi, ov_hi, send_lo, cnt_lo, ov_lo


def _append_recv_cols(ghost, gcount, overflow, recv, recv_cnt, H, G):
    """Append a received planar slab ``[V, K, H]`` to the ghost buffer
    ``[V, K, G + H]`` as one contiguous block per vrank, starting at its
    own ``min(gcount, G)`` (a scatter with device indices). The H-column
    scratch tail takes the block when the buffer is full, so an overflow
    drops cleanly; the slab's columns past ``recv_cnt`` are zero, and the
    next append claims them. Callers slice ``[:, :, :G]``."""
    overflow = overflow + (gcount + recv_cnt - G).clamp(min=0)
    start = gcount.clamp(max=G).long()
    j = torch.arange(H, dtype=torch.int64, device=ghost.device)
    idx = (start[:, None] + j)[:, None, :].expand(recv.shape)
    ghost.scatter_(2, idx, recv)
    return ghost, (gcount + recv_cnt).clamp(max=G), overflow


def _planar_passes(domain: Domain, grid: ProcessGrid, halo_width, H: int,
                   G: int, coord_of, wire):
    """The planar exchange over a batch of ranks: ``run(fi [B, K, n] int32,
    count [B]) -> (ghost [B, K, G] int32, gcount [B], overflow [B])``,
    with ``coord_of`` and ``wire`` as in :func:`_rowmajor_passes`."""
    widths, cell_w = _validate_widths(domain, grid, halo_width)
    nd = domain.ndim

    def run(fi, count):
        dev = fi.device
        V, K, n = fi.shape
        valid = torch.arange(n, dtype=torch.int32,
                             device=dev)[None, :] < count[:, None]
        ghost = torch.zeros((V, K, G + H), dtype=torch.int32, device=dev)
        gcount = torch.zeros((V,), dtype=torch.int32, device=dev)
        overflow = torch.zeros((V,), dtype=torch.int32, device=dev)

        for a in range(nd):
            g = grid.shape[a]
            w = _fill(widths[a], torch.float32, dev)
            extent_a = _fill(domain.extent[a], torch.float32, dev)
            coord = coord_of(a, dev)
            lo_a, hi_a = _bounds_at(domain, a, cell_w[a], coord,
                                    torch.float32)
            Wa = min(G, 2 * a * H)
            cand = torch.cat([fi, ghost[:, :, :Wa]], dim=2)
            cand_valid = torch.cat([
                valid,
                torch.arange(Wa, dtype=torch.int32, device=dev)[None, :]
                < gcount[:, None],
            ], dim=1)
            at_hi = coord == (g - 1)
            at_lo = coord == 0
            if _bands_disjoint(domain, a, widths, cell_w):
                s_hi, c_hi, o_hi, s_lo, c_lo, o_lo = _select_cols_for_axis(
                    cand, cand_valid, a, lo_a, hi_a, w, at_hi, at_lo,
                    domain.periodic[a], extent_a, H,
                )
                overflow = overflow + o_hi + o_lo
                sends = [(1, s_hi, c_hi), (-1, s_lo, c_lo)]
            else:
                sends = []
                for dirn, at_edge in ((1, at_hi), (-1, at_lo)):
                    send, send_cnt, ov = _select_cols_for_pass(
                        cand, cand_valid, a, dirn, lo_a, hi_a, w, at_edge,
                        domain.periodic[a], extent_a, H,
                    )
                    overflow = overflow + ov
                    sends.append((dirn, send, send_cnt))
            incoming = [(wire(send, dirn, a), wire(send_cnt, dirn, a))
                        for dirn, send, send_cnt in sends]
            for recv, recv_cnt in incoming:
                ghost, gcount, overflow = _append_recv_cols(
                    ghost, gcount, overflow, recv, recv_cnt, H, G)
        return ghost[:, :, :G], gcount, overflow

    return run


def _planar_input(fused: torch.Tensor, nd: int, lead: int):
    """Validate a planar state of ``lead + 2`` dims (``[..., K >= nd, n]``,
    32-bit): ``(as_f32, int32 view)``."""
    if fused.dim() != lead + 2 or fused.shape[-2] < nd:
        want = "[V, K, n]" if lead else "[K, n] per rank"
        raise ValueError(
            f"fused must be {want} with K >= {nd}, got {tuple(fused.shape)}"
        )
    if fused.dtype not in (torch.float32, torch.int32):
        raise TypeError(
            f"fused must be float32 or int32, got {fused.dtype}"
        )
    as_f32 = fused.dtype == torch.float32
    # viewed only when float32, a 4-byte dtype (gridlint G004)
    return as_f32, (fused.view(torch.int32)  # gridlint: disable=G004
                    if as_f32 else fused)


def vrank_halo_planar_fn(
    domain: Domain,
    grid: ProcessGrid,
    halo_width,
    pass_capacity: int,
    ghost_capacity: int,
):
    """Planar V-rank halo exchange on one device: ``[V, K, n]`` state.

    Same passes, predicate and append order as :func:`vrank_halo_fn` (the
    same ghost set and order), with the payload component-major (``K``
    rows: ``D`` position components first, then 32-bit fields) and an
    int32 transport, so every 32-bit pattern arrives as it left.

    Signature: ``(fused [V, K, n], count [V]) -> (ghost [V, K, G], gcount
    [V], overflow [V])``; ``fused`` may be float32 or int32 (the output
    matches it). Ghost columns past ``gcount[v]`` are zero. Before axis
    ``a`` at most ``2aH`` ghost columns can be valid, so that axis selects
    from the own columns and the first ``min(G, 2aH)`` ghost columns."""
    V = grid.nranks
    run = _planar_passes(domain, grid, halo_width, pass_capacity,
                         ghost_capacity, _vrank_coords(grid),
                         _roll_wire(grid))

    def fn(fused, count):
        if fused.dim() == 3 and fused.shape[0] != V:
            raise ValueError(
                f"fused must be [V={V}, K, n], got {tuple(fused.shape)}")
        as_f32, fi = _planar_input(fused, domain.ndim, 1)
        out, gcount, overflow = run(fi, count)
        return (out.view(torch.float32) if as_f32 else out), gcount, overflow

    return fn


build_halo_planar_vranks = vrank_halo_planar_fn


# ---------------------------------------------------------------------------
# Multi-rank engines: one rank a process, over torch.distributed
# ---------------------------------------------------------------------------


def shard_halo_planar_fn(
    domain: Domain,
    grid: ProcessGrid,
    halo_width,
    pass_capacity: int,
    ghost_capacity: int,
    mesh=None,
):
    """Planar multi-rank halo exchange, one rank's part (the reference's
    ``shard_map`` body): the passes of :func:`vrank_halo_planar_fn` on
    this rank's columns, each send one ``ppermute`` to the neighbour
    along its axis over ``mesh`` (default :func:`~.mesh.make_mesh` of
    ``grid``). ``fn(fused [K, n], count) -> (ghost [K, G], gcount [1],
    overflow [1])``, this rank's rows."""
    _validate_widths(domain, grid, halo_width)
    mesh = mesh_lib.mesh_for(grid, mesh)
    run = _planar_passes(domain, grid, halo_width, pass_capacity,
                         ghost_capacity, _rank_coords(mesh),
                         _ppermute_wire(grid, mesh))

    def fn(fused, count):
        as_f32, fi = _planar_input(fused, domain.ndim, 0)
        out, gcount, overflow = run(fi[None], count.reshape(1).to(
            torch.int32))
        out = out[0]
        return (out.view(torch.float32) if as_f32 else out), gcount, overflow

    return fn


@functools.lru_cache(maxsize=64)
def build_halo_planar(mesh, domain: Domain, grid: ProcessGrid, halo_width,
                      pass_capacity: int, ghost_capacity: int):
    """The reference's global planar halo (``[K, R * n]`` lane-sharded) as
    each rank sees it: :func:`shard_halo_planar_fn` with the per-rank
    counters gathered. ``fn(fused [K, n], count) -> (ghost [K, G], gcount
    [R], overflow [R])``, the counters the same on every rank. Built once
    for each set of arguments (``halo_width`` a float or a tuple), as the
    reference caches its jit."""
    _validate_widths(domain, grid, halo_width)
    mesh = mesh_lib.mesh_for(grid, mesh)
    fn = shard_halo_planar_fn(domain, grid, halo_width, pass_capacity,
                              ghost_capacity, mesh=mesh)

    def call(fused, count):
        ghost, gcount, overflow = fn(fused, count)
        return (ghost, col.all_gather(gcount, mesh).reshape(-1),
                col.all_gather(overflow, mesh).reshape(-1))

    return call


def shard_halo_fn(
    domain: Domain,
    grid: ProcessGrid,
    halo_width,
    pass_capacity: int,
    ghost_capacity: int,
    mesh=None,
):
    """Row-major multi-rank halo exchange, one rank's part: the passes of
    :func:`vrank_halo_fn` on this rank's rows, one ``ppermute`` a send and
    array. ``fn(pos [n, D], count, *fields [n, ...]) -> (ghost_pos [G,
    D], ghost_count [1], *ghost_fields, overflow [1])``."""
    _validate_widths(domain, grid, halo_width)
    mesh = mesh_lib.mesh_for(grid, mesh)
    run = _rowmajor_passes(domain, grid, halo_width, pass_capacity,
                           ghost_capacity, _rank_coords(mesh),
                           _ppermute_wire(grid, mesh))

    def fn(pos, count, *fields):
        out = run(pos[None], count.reshape(1).to(torch.int32),
                  *(f[None] for f in fields))
        return ((out[0][0], out[1]) + tuple(f[0] for f in out[2:-1])
                + (out[-1],))

    return fn


@functools.lru_cache(maxsize=64)
def build_halo_exchange(
    mesh,
    domain: Domain,
    grid: ProcessGrid,
    halo_width,
    pass_capacity: int = None,
    ghost_capacity: int = None,
    headroom: float = 2.0,
):
    """The reference's global row-major halo as each rank sees it:
    ``wrapped(pos [n, D], count, *fields) -> HaloResult`` with this rank's
    ghost rows ``[G, ...]`` and the ghost counts and overflow of every
    rank (``[R]``, gathered). Capacities left ``None`` come from
    :func:`default_capacities` of each call's row count, one engine a
    distinct count, the last 16 kept (pass both to pin one engine for
    every count); a rank takes any number of fields. Built once for each
    set of arguments, as :func:`build_halo_planar` is."""
    from collections import OrderedDict

    _validate_widths(domain, grid, halo_width)
    mesh = mesh_lib.mesh_for(grid, mesh)
    built = OrderedDict()  # n_local -> engine, LRU-bounded
    max_builds = 16

    def _build(n_local: int):
        pc, gc = pass_capacity, ghost_capacity
        if pc is None or gc is None:
            dpc, dgc = default_capacities(domain, grid, halo_width, n_local,
                                          headroom)
            pc = dpc if pc is None else pc
            gc = dgc if gc is None else gc
        return shard_halo_fn(domain, grid, halo_width, pc, gc, mesh=mesh)

    def wrapped(pos, count, *fields):
        key = (pos.shape[0] if pass_capacity is None
               or ghost_capacity is None else 0)
        if key in built:
            built.move_to_end(key)
        else:
            built[key] = _build(key)
            if len(built) > max_builds:
                built.popitem(last=False)
        out = built[key](pos, count, *fields)
        return HaloResult(out[0], col.all_gather(out[1], mesh).reshape(-1),
                          tuple(out[2:-1]),
                          col.all_gather(out[-1], mesh).reshape(-1))

    return wrapped
