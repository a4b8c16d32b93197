"""Cloud-in-cell (CIC) particle-mesh deposit (port of the JAX package's
``ops/deposit.py``: the planar scan and segmented-sum engines, the
row-major scatter-add and scan deposits of vrank slabs, their per-device
wrappers, the ghost fold and the dense assembly, on one device or one
rank a process).

Each particle spreads ``mass * w`` to the 2^D mesh nodes around it. The
sorted engines key every particle by its base cell, sort, and sum per
cell; the per-cell channel sums are then placed onto a +1-ghost node
mesh (corner ``c`` lands at ``base + c``), whose ghost faces fold onto
plane 0 of periodic axes (:func:`fold_ghosts`) or stay as the clamp-edge
planes of open axes (:func:`assemble_dense`). Three methods:

  * ``"scan"`` (:func:`cic_deposit_device_planar`): a stable sort by
    ``key`` (on the card one key-value radix sort whose pack computes
    each particle's key and block-local coordinates from its position and
    moves them with the key, ``ops.rowsort.sort_keyed_rows``), the
    corner-weight channels, a two-level double-float prefix sum (kernel
    5, ``ops.dfscan``, within 256-row tiles, computing the fractions and
    corner weights in its load on the card; ``ops.tilecarry`` over the
    tile totals) and differences at the run bounds. Per-cell
    error ~ulp(cell value); bit-equal to the JAX package on the same
    inputs;
  * ``"mxu"`` (:func:`cic_deposit_device_mxu`, and the slab-keyed
    :func:`cic_deposit_vranks_mxu`): the sort feeds the segmented-sum
    kernel 4 (``ops.segdep``) directly. float32 accumulation; the
    reference's sort is unstable, so its per-cell summation order is not
    a contract and the two packages agree at float32 tolerance (bit for
    bit on dyadic data);
  * ``"segment"`` (:func:`shard_deposit_vranks_fn`): each vrank's
    row-major slab is scattered onto its own +1-ghost block with
    ``index_add_`` (:func:`cic_deposit_vranks_segment`, the reference's
    ``segment_sum``; no kernel of the reference's is on this route) and
    the blocks are added onto the device mesh. Bit-equal to the JAX
    package on the CPU; atomics on the card.

The reference's ``lax.sort((key, iota, payload...), num_keys=2)`` is a
stable ``torch.sort`` on the key (the same permutation) followed by ONE
gather of the stacked payload rows; the scan engine's radix sort on the
card gives the same bits. Sorts here are always stable, so the port is
deterministic even where the reference is not.

On a grid of several devices each rank is a process of a
:class:`~..parallel.mesh.RankMesh` (``mesh=``, default
:func:`~..parallel.mesh.make_mesh` of the device grid): the block origin
comes from the rank's cell, the ghost fold moves each upper ghost face to
the next rank along its axis (one ``ppermute`` an axis), and the dense
assembly sums the ranks' canvases in rank order
(:func:`~..parallel.collectives.psum_ordered`, the order that gives the
reference's bits). The slab engine's residence guard (the reference's
``lax.cond``) reads one boolean on the host per call; :data:`HOST_SYNCS`
counts those reads.
"""

from __future__ import annotations

import itertools
import math
from typing import Tuple

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch._device import OnDevice
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops import (
    binning, dfscan, rowsort, segdep, tilecarry,
)
from mpi_grid_redistribute_tpu_torch.ops.dfscan import (  # noqa: F401
    _df_add, _df_cumsum, _two_sum,
)
from mpi_grid_redistribute_tpu_torch.parallel import collectives as col
from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib
from mpi_grid_redistribute_tpu_torch.telemetry.phases import host_read, span

# host reads of device values, by cause (the residence guard of the slab
# engine is the only one on the deposit path); telemetry.phases.host_read
# counts each and labels its wait "sync:residence_guard"
HOST_SYNCS = {"residence_guard": 0}

_F32 = torch.float32
_I32 = torch.int32


def _check_mesh_shape(domain: Domain, grid: ProcessGrid,
                      mesh_shape: Tuple[int, ...]) -> None:
    if len(mesh_shape) != domain.ndim:
        raise ValueError(
            f"mesh_shape must have {domain.ndim} axes, got {mesh_shape}"
        )
    for a, (m, g) in enumerate(zip(mesh_shape, grid.shape)):
        if m % g:
            raise ValueError(
                f"axis {a}: mesh cells {m} not divisible by grid extent {g}"
            )


def global_node_shape(domain: Domain,
                      mesh_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Global node-mesh shape for ``mesh_shape`` CELLS per axis: periodic
    axes have as many nodes as cells (the upper face wraps onto plane 0);
    open axes carry one extra clamp-edge node plane."""
    return tuple(
        m if p else m + 1 for m, p in zip(mesh_shape, domain.periodic)
    )


def _row_major_strides(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    strides = []
    acc = 1
    for m in reversed(shape):
        strides.append(acc)
        acc *= m
    return tuple(reversed(strides))


def _payload_route(device: torch.device, n: int, D: int, tile: int,
                   plain: bool) -> str:
    """How the scan deposit sorts its payload and feeds kernel 5:
    ``"rows"`` (``rowsort``: the payload as 16-byte rows moved with the
    keys, and kernel 5's fused route on those rows) on a CUDA device for D
    of 1 to 3, a tile the fused route takes and 1 to 2^31 - 1 rows; else
    ``"planar"`` (a stable ``torch.sort`` and a gather of the planar
    payload), which ``plain`` always takes."""
    if (plain or device.type != "cuda" or not 1 <= D <= rowsort.MAX_DIMS
            or not 1 <= n <= rowsort.MAX_ROWS
            or dfscan.cic_geometry(tile, D).route != "cic"):
        return "planar"
    return "rows"


def _sorted_per_segment_planar(key, rel_rows, mass, n_segments: int,
                               local_shape, tile: int,
                               channel_group: int = None,
                               plain: bool = False):
    """Scan-deposit core on the planar route: stable sort by segment key,
    double-float prefix of the corner-weight channels, differences at the
    segment bounds.

    ``key [N]`` int32 in ``[0, n_segments]`` (sentinel ``n_segments`` for
    invalid rows), ``rel_rows [D, N]`` block-local coordinates, ``mass
    [N]`` (already zero on invalid rows). Returns ``per_cell [2^D,
    n_segments]``. The sort is ``torch.sort`` and a gather of the planar
    payload; :func:`_segment_sums` does the rest."""
    n = key.shape[0]
    with span("dep:sort"):
        keys_sorted, order = torch.sort(key, stable=True)
        payload = torch.cat([rel_rows, mass[None, :]], dim=0)
        sorted_ = torch.index_select(payload, 1, order)
    return _segment_sums(keys_sorted, sorted_, False, n_segments,
                         local_shape, max(1, min(tile, n)), channel_group,
                         plain)


def _segment_sums(keys_sorted, sorted_, rows_route: bool, n_segments: int,
                  local_shape, K: int, channel_group: int = None,
                  plain: bool = False):
    """The scan deposit after its sort: ``keys_sorted [N]`` and the
    payload in that order, as rows ``[N, 4]`` of ``ops.rowsort``
    (``rows_route``: ``dfscan.cic_tile_prefix_rows``, one fused kernel 5
    launch a group on the card) or planar ``[D + 1, N]``
    (``dfscan.cic_tile_prefix``, its plain version on the CPU or when
    ``plain``); the double-float prefix of the corner-weight channels in
    tiles of ``K`` rows, the tiles' carries (``tilecarry.tile_carries``,
    its plain version when ``plain``) and the differences at the segment
    bounds. Returns
    ``per_cell [2^D, n_segments]``. ``channel_group`` processes the
    channels in groups of that many to bound the prefix temporaries; it
    changes no channel's arithmetic."""
    n = keys_sorted.shape[0]
    D = len(local_shape)
    nch = 1 << D
    n_pad = -(-n // K) * K
    with span("dep:bounds"):
        bounds = binning.bounds_dense(keys_sorted, n_segments + 1)
        t_idx = (bounds // K).long()
        has_local = (bounds % K > 0)[None, :]
        lb = (bounds - 1).clamp(0, n_pad - 1).long()
    cg = nch if not channel_group else max(1, min(channel_group, nch))
    if rows_route:
        def prefix(c0, g):
            return dfscan.cic_tile_prefix_rows(sorted_, local_shape, c0, g,
                                               K)
    else:
        planar = (dfscan.cic_tile_prefix_plain if plain
                  else dfscan.cic_tile_prefix)

        def prefix(c0, g):
            return planar(sorted_, local_shape, c0, g, K)
    carries = tilecarry.tile_carries_plain if plain else tilecarry.tile_carries

    def per_group(c0):
        g = min(cg, nch - c0)
        with span("dep:prefix"):
            # within-tile prefixes of the group's corner channels, hi rows
            # above lo rows: [2 g, n_pad]
            l_pack = prefix(c0, g)
            # the tiles' exclusive prefixes, hi rows above lo rows:
            # [2 g, T + 1]
            s_pack = carries(l_pack, K)
        with span("dep:place"):
            l_at = torch.where(
                has_local, torch.index_select(l_pack, 1, lb), 0.0
            )
            s_at = torch.index_select(s_pack, 1, t_idx)
            g_hi, g_lo = _df_add(s_at[:g], s_at[g:], l_at[:g], l_at[g:])
            # run sum over [bounds[c], bounds[c+1]): the hi difference
            # cancels the shared prefix, the lo difference restores what
            # hi rounded
            return ((g_hi[:, 1:] - g_hi[:, :-1])
                    + (g_lo[:, 1:] - g_lo[:, :-1]))

    if cg >= nch:
        return per_group(0)
    groups = [per_group(c0) for c0 in range(0, nch, cg)]
    with span("dep:place"):
        return torch.cat(groups, dim=0)


def _place_corners(total: torch.Tensor, per_cell: torch.Tensor,
                   block: Tuple[int, ...]) -> torch.Tensor:
    """Add corner channel ``k`` of ``per_cell [2^D, ..., *block]`` onto
    the +1-ghost ``total [..., *(block + 1)]`` at offset ``corner(k)``,
    in corner order (the reference's chain of padded adds)."""
    D = len(block)
    lead = (slice(None),) * (total.dim() - D)
    for k, corner in enumerate(itertools.product((0, 1), repeat=D)):
        idx = lead + tuple(slice(c, c + b) for c, b in zip(corner, block))
        total[idx] += per_cell[k]
    return total


def cic_deposit_vranks_planar(pos_rows, mass, valid, lo_local, inv_h,
                              vblock: Tuple[int, ...], tile: int = 256,
                              plain: bool = False):
    """Planar batched scan deposit of V slabs: ``pos_rows [D, V * n]``
    (vrank ``v`` owns columns ``[v*n, (v+1)*n)``), ``mass``/``valid``
    ``[V * n]``, ``lo_local [V, D]`` and ``inv_h [D]`` float32 tensors.
    Returns per-vrank ghost blocks ``[V, *(vblock + 1)]``."""
    D, m = pos_rows.shape
    V = lo_local.shape[0]
    n_cells = math.prod(vblock)
    if V * n_cells > 2**27:
        raise ValueError(
            f"cic_deposit_vranks_planar: V * prod(vblock) = {V} * "
            f"{n_cells} = {V * n_cells} exceeds the safe int32/memory "
            f"bound (2**27). Use a coarser deposit grid per vrank or "
            f"fewer vranks per device."
        )
    # above ~16M rows, process corner channels two at a time to bound the
    # double-float prefix temporaries, as the reference does
    cg = 2 if m > (1 << 24) else None
    K = max(1, min(tile, m))
    if _payload_route(pos_rows.device, m, D, K, plain) == "rows":
        # the keys are computed in the payload sort's pack
        with span("dep:sort"):
            keys_s, rows_s = rowsort.sort_keyed_rows(
                pos_rows, valid, mass, lo_local, inv_h, vblock)
        per_cell = _segment_sums(keys_s, rows_s, True, V * n_cells, vblock,
                                 K, cg, plain)
    else:
        with span("dep:keys"):
            key, rel_rows, mass_z = rowsort.slab_keys_plain(
                pos_rows, valid, mass, lo_local, inv_h, vblock)
        per_cell = _sorted_per_segment_planar(
            key, rel_rows, mass_z, V * n_cells, vblock, tile,
            channel_group=cg, plain=plain,
        )  # [2^D, V * n_cells]
    with span("dep:place"):
        per_cell = per_cell.reshape((per_cell.shape[0], V) + tuple(vblock))
        ghost = tuple(b + 1 for b in vblock)
        total = torch.zeros((V,) + ghost, dtype=mass.dtype,
                            device=mass.device)
        return _place_corners(total, per_cell, vblock)


def cic_deposit_device_planar(pos_rows, mass, valid, dev_lo, inv_h,
                              dev_block: Tuple[int, ...], tile: int = 256,
                              plain: bool = False):
    """Planar scan deposit keyed by DEVICE-local cell: the vrank core at
    ``V = 1``. ``pos_rows [D, n]``, ``mass``/``valid`` ``[n]``, ``dev_lo
    [D]``. Returns the +1-ghost device mesh ``[*(dev_block + 1)]``."""
    out = cic_deposit_vranks_planar(
        pos_rows, mass, valid, dev_lo[None, :], inv_h, dev_block,
        tile=tile, plain=plain,
    )
    return out[0]


def _device_keys_planar(pos_rows, valid, dev_lo, inv_h, dev_block):
    """Device-cell keys and block-local coordinates: ``(key [m], rel_rows
    [D, m])`` with sentinel ``n_cells`` on invalid columns."""
    D, m = pos_rows.shape
    n_cells = math.prod(dev_block)
    strides = _row_major_strides(dev_block)
    rel = []
    cell = torch.zeros((m,), dtype=_I32, device=pos_rows.device)
    for d in range(D):
        r = (pos_rows[d] - dev_lo[d]) * inv_h[d]
        r = torch.where(valid, r, 0.0)
        cell = cell + binning.base_cell(r, dev_block[d]) * strides[d]
        rel.append(r)
    key = torch.where(valid, cell, n_cells).to(_I32)
    return key, torch.stack(rel, dim=0)


def _corner_ghost(per_cell: torch.Tensor, dev_block) -> torch.Tensor:
    """Place ``[2^D, n_cells]`` corner channels onto the +1-ghost mesh."""
    per_cell = per_cell.reshape((per_cell.shape[0],) + tuple(dev_block))
    ghost = tuple(b + 1 for b in dev_block)
    total = torch.zeros(ghost, dtype=per_cell.dtype, device=per_cell.device)
    return _place_corners(total, per_cell, tuple(dev_block))


def _segsum(plain: bool):
    return segdep.segsum_sorted_plain if plain else segdep.segsum_sorted


def cic_deposit_device_mxu(pos_rows, mass, valid, dev_lo, inv_h,
                           dev_block: Tuple[int, ...],
                           plain: bool = False) -> torch.Tensor:
    """Throughput CIC deposit keyed by device cell: one stable payload
    sort, then the segmented-sum kernel 4. ``mass=None`` means unit mass
    and drops the mass row from the payload. float32 accumulation; the
    same contract as :func:`cic_deposit_device_planar` otherwise."""
    D = pos_rows.shape[0]
    n_cells = math.prod(dev_block)
    key, rel_rows = _device_keys_planar(
        pos_rows, valid, dev_lo, inv_h, dev_block
    )
    payload = rel_rows
    if mass is not None:
        payload = torch.cat(
            [rel_rows, torch.where(valid, mass, 0.0)[None, :]], dim=0
        )
    keys_s, order = torch.sort(key, stable=True)
    payload_s = torch.index_select(payload, 1, order)
    mass_s = payload_s[D] if mass is not None else None
    per_cell = _segsum(plain)(
        keys_s, payload_s[:D], mass_s, n_cells, dev_block
    )
    return _corner_ghost(per_cell, dev_block)


def cic_deposit_vranks_mxu(pos_rows, mass, valid, lo_local, inv_h,
                           vblock: Tuple[int, ...],
                           vgrid_shape: Tuple[int, ...],
                           plain: bool = False) -> torch.Tensor:
    """Slab-keyed throughput deposit: rows arrive slab-partitioned (slab
    ``v`` holds only vrank ``v``'s particles), so vrank-major keys
    ``v * C + local_cell`` sorted slab by slab (one batched ``[V, n]``
    sort) form the stream kernel 4 takes. Returns the +1-ghost DEVICE
    mesh ``[*(vblock * vgrid_shape + 1)]``."""
    key, rel, mass2, _ = _slab_keys_mxu(
        pos_rows, mass, valid, lo_local, inv_h, vblock
    )
    return _slab_deposit_from_keys(
        key, rel, mass2, vblock, vgrid_shape, plain=plain
    )


def _slab_keys_mxu(pos_rows, mass, valid, lo_local, inv_h, vblock):
    """One pass over the slab state: vrank-major keys ``[V, n]``,
    block-local rel rows, masked mass, and the residence predicate (every
    valid row inside its slab's block, up to the boundary tolerances
    below) that :func:`shard_deposit_device_mxu_fn` routes on.

    Tolerances: the migrate binning and this ``r`` use different
    arithmetic, so a legal boundary row can compute ``r == vblock``
    exactly or a few ulp below zero; admitting ``[-1e-4, vblock]`` keeps
    those on the slab path (placement error <= 1e-4 cell) while
    mis-slabbed rows, a full cell or more away, fail the guard."""
    D, m = pos_rows.shape
    V = lo_local.shape[0]
    n = m // V
    n_cells = math.prod(vblock)
    strides = _row_major_strides(vblock)
    valid2 = valid.reshape(V, n)
    rel = []
    cell = torch.zeros((V, n), dtype=_I32, device=pos_rows.device)
    in_block = torch.ones((), dtype=torch.bool, device=pos_rows.device)
    for d in range(D):
        r = (pos_rows[d].reshape(V, n) - lo_local[:, d, None]) * inv_h[d]
        # a Python float compares like its float32 rounding here: no
        # float32 lies between a constant and its nearest float32
        ok_d = (~valid2) | ((r >= -1e-4) & (r <= float(vblock[d])))
        in_block = in_block & ok_d.all()
        r = torch.where(valid2, r, 0.0)
        cell = cell + binning.base_cell(r, vblock[d]) * strides[d]
        rel.append(r)
    v_ids = torch.arange(V, dtype=_I32, device=pos_rows.device)[:, None]
    key = torch.where(valid2, v_ids * n_cells + cell, V * n_cells).to(_I32)
    mass2 = None if mass is None else torch.where(
        valid2, mass.reshape(V, n), 0.0
    )
    return key, rel, mass2, in_block


def _slab_deposit_from_keys(key, rel, mass2, vblock, vgrid_shape,
                            plain: bool = False) -> torch.Tensor:
    """Sort + kernel 4 + canvas remap half of the slab engine: a batched
    stable sort of each slab's keys, one gather of the payload rows, the
    segmented sums on the vrank-major ``[2^D, V * C]`` canvas, then the
    transpose to device row-major."""
    D = len(rel)
    V, n = key.shape
    m = V * n
    n_cells = math.prod(vblock)
    keys_s, order = torch.sort(key, dim=1, stable=True)
    rows = list(rel) + ([mass2] if mass2 is not None else [])
    payload = torch.stack(rows, dim=0).reshape(len(rows), m)
    col = order + torch.arange(V, device=key.device)[:, None] * n
    payload_s = torch.index_select(payload, 1, col.reshape(-1))
    mass_s = payload_s[D] if mass2 is not None else None
    per_cell = _segsum(plain)(
        keys_s.reshape(m), payload_s[:D], mass_s, V * n_cells, vblock
    )  # [2^D, V * n_cells], vrank-major columns
    nch = per_cell.shape[0]
    # [nch, Vx, Vy, Vz, bx, by, bz] -> [nch, Vx, bx, Vy, by, Vz, bz]
    per_cell = per_cell.reshape((nch,) + tuple(vgrid_shape) + tuple(vblock))
    axes_order = [0]
    for d in range(D):
        axes_order += [1 + d, 1 + D + d]
    per_cell = per_cell.permute(axes_order)
    dev_block = tuple(v * b for v, b in zip(vgrid_shape, vblock))
    per_cell = per_cell.reshape((nch, math.prod(dev_block)))
    return _corner_ghost(per_cell, dev_block)


def _corner_groups(n_rows: int, n_nodes: int, n_corners: int):
    """The order in which XLA's CPU compiler adds the corners of the
    reference's ``total + segment_sum(...)`` chain, as a list of
    ``(corners, into_total)``: ``K`` corners scattered as one update
    stream (the first group into zeros, later ones into the running
    total), one corner summed apart and added between two groups. XLA
    joins consecutive scatters while their update rows stay below the
    operand's nodes, so ``K`` is the largest count (at most ``n_corners``)
    with ``K * n_rows < n_nodes``, and 1 when no such count exists. Read
    off the compiled HLO of the reference's ``build_deposit``
    (``tests/test_torch_deposit.py`` reads it again)."""
    k = max(1, min(n_corners, -(-n_nodes // max(n_rows, 1)) - 1))
    groups = [(tuple(range(min(k, n_corners))), False)]
    c = k
    while c < n_corners:
        groups.append(((c,), False))
        c += 1
        if c < n_corners:
            groups.append((tuple(range(c, min(c + k, n_corners))), True))
            c += k
    return groups


def cic_deposit_vranks_segment(pos, mass, valid, lo_local, inv_h,
                               vblock: Tuple[int, ...]) -> torch.Tensor:
    """Scatter-add CIC deposit of V slabs (the reference's
    ``cic_deposit_local`` under ``vmap``, the ``"segment"`` method):
    ``pos [V, n, D]``, ``mass``/``valid`` ``[V, n]``, ``lo_local [V, D]``,
    ``inv_h [D]``; each row's coordinates local to its slab's block lie in
    ``[0, vblock)`` and the +1 ghost plane absorbs the upper-face spill.
    Returns per-vrank ghost blocks ``[V, *(vblock + 1)]``.

    Each corner's weights ``mass * ((w0 * w1) * w2)`` are added with
    ``index_add_`` in row order, and the corners are combined in the order
    XLA's CPU compiler gives the reference's ``total + segment_sum(...)``
    chain (:func:`_corner_groups`): with many rows a slab, corner 0's
    sums, plus corner 1's sums, corner 2 added straight into that total,
    plus corner 3's sums, and so on; with few rows, runs of corners
    scattered as one stream. On the CPU this is the reference's bits; on
    the card ``index_add_`` accumulates with atomics in no fixed order,
    so repeated runs may differ in the last bits (the reference has no
    deterministic variant on this path either)."""
    V, n, D = pos.shape
    ghost = tuple(b + 1 for b in vblock)
    n_nodes = math.prod(ghost)
    strides = _row_major_strides(ghost)
    rel = (pos - lo_local[:, None, :]) * inv_h
    # holes may hold any bytes: zero their coordinates too, or a NaN
    # position turns the masked weight into 0 * NaN = NaN
    rel = torch.where(valid[..., None], rel, 0.0)
    i0 = torch.stack(
        [binning.base_cell(rel[..., d], vblock[d]) for d in range(D)],
        dim=-1
    )
    frac = (rel - i0.to(_F32)).clamp(0.0, 1.0)
    w_valid = torch.where(valid, mass, 0.0).reshape(-1)
    # vrank v's nodes are [v * n_nodes, (v + 1) * n_nodes) of one flat
    # canvas, so one scatter serves every slab
    base = torch.arange(V, dtype=torch.int64, device=pos.device)[:, None]
    base = base * n_nodes
    corners = list(itertools.product((0, 1), repeat=D))

    def stream(k):
        corner = corners[k]
        w = None
        for d in range(D):
            t = frac[..., d] if corner[d] == 1 else 1.0 - frac[..., d]
            w = t if w is None else w * t
        idx = base
        for d in range(D):
            idx = idx + (i0[..., d] + corner[d]).to(torch.int64) * strides[d]
        return idx.reshape(-1), w_valid * w.reshape(-1)

    total = None
    for group, into_total in _corner_groups(n, n_nodes, len(corners)):
        parts = [stream(k) for k in group]
        idx = torch.cat([p[0] for p in parts])
        upd = torch.cat([p[1] for p in parts])
        if into_total:
            total.index_add_(0, idx, upd)
            continue
        part = torch.zeros((V * n_nodes,), dtype=_F32, device=pos.device)
        part.index_add_(0, idx, upd)
        total = part if total is None else total + part
    return total.reshape((V,) + ghost)


def cic_deposit_local(pos, mass, valid, lo_local, inv_h,
                      local_shape: Tuple[int, ...]) -> torch.Tensor:
    """Scatter-add CIC deposit of one block: ``pos [N, D]``, ``mass``/
    ``valid`` ``[N]``, ``lo_local``/``inv_h`` ``[D]``; returns the
    +1-ghost block ``[*(local_shape + 1)]``
    (:func:`cic_deposit_vranks_segment` of one slab)."""
    return cic_deposit_vranks_segment(
        pos[None], mass[None], valid[None], lo_local[None], inv_h,
        local_shape,
    )[0]


def cic_deposit_vranks_sorted(pos, mass, valid, lo_local, inv_h,
                              vblock: Tuple[int, ...], tile: int = 256,
                              plain: bool = False) -> torch.Tensor:
    """Double-float scan deposit of V row-major slabs (the reference's
    ``cic_deposit_vranks_sorted``): ``pos [V, n, D]``, ``mass``/``valid``
    ``[V, n]``, ``lo_local [V, D]``. The same keys, stable order, prefix
    and differences as the planar core (:func:`cic_deposit_vranks_planar`,
    kernel 5 on the card), which it runs on the transposed rows. Returns
    ``[V, *(vblock + 1)]``."""
    V, n, D = pos.shape
    rows = pos.permute(2, 0, 1).reshape(D, V * n)
    return cic_deposit_vranks_planar(
        rows, mass.reshape(-1), valid.reshape(-1), lo_local, inv_h, vblock,
        tile=tile, plain=plain,
    )


def cic_deposit_local_sorted(pos, mass, valid, lo_local, inv_h,
                             local_shape: Tuple[int, ...], tile: int = 256,
                             plain: bool = False) -> torch.Tensor:
    """The scan deposit of one row-major block (the contract of
    :func:`cic_deposit_local`): :func:`cic_deposit_vranks_sorted` of one
    slab."""
    return cic_deposit_vranks_sorted(
        pos[None], mass[None], valid[None], lo_local[None], inv_h,
        local_shape, tile=tile, plain=plain,
    )[0]


def _rank_of(dev_grid: ProcessGrid, mesh):
    """``(mesh, coords)``: a multi-device grid's mesh (default
    :func:`~..parallel.mesh.make_mesh`) and this rank's cell; one device
    needs no mesh and sits at cell 0."""
    if dev_grid.nranks == 1:
        return None, (0,) * dev_grid.ndim
    mesh = mesh_lib.mesh_for(dev_grid, mesh)
    return mesh, tuple(mesh.coords)


def _vrank_origins(domain: Domain, dev_grid: ProcessGrid,
                   vgrid: ProcessGrid, coords=None) -> np.ndarray:
    """float32 ``[V, D]`` block origins of the vranks of the device at
    cell ``coords`` (default 0), in the reference's op order: ``lo +
    (cell * vgrid.shape + vcell) * vwidth``."""
    if coords is None:
        coords = (0,) * dev_grid.ndim
    full_grid = ProcessGrid(
        tuple(d * v for d, v in zip(dev_grid.shape, vgrid.shape)),
        axis_names=dev_grid.axis_names,
    )
    vwidths = full_grid.cell_widths(domain)
    vcells = np.asarray(
        [vgrid.cell_of_rank(v) for v in range(vgrid.nranks)],
        dtype=np.float32,
    )
    return np.stack(
        [
            np.float32(domain.lo[a])
            + (np.float32(coords[a]) * np.float32(vgrid.shape[a])
               + vcells[:, a])
            * np.float32(vwidths[a])
            for a in range(domain.ndim)
        ],
        axis=1,
    ).astype(np.float32)


def shard_deposit_vranks_fn(domain: Domain, dev_grid: ProcessGrid,
                            vgrid: ProcessGrid, mesh_shape: Tuple[int, ...],
                            method: str = "scan", plain: bool = False,
                            mesh=None):
    """Per-device CIC deposit of row-major vrank slabs: ``fn(pos [V, n,
    D], mass [V, n], valid [V, n]) -> rho``. Each vrank deposits its slab
    onto its own +1-ghost block (``"segment"``: the scatter-add of
    :func:`cic_deposit_vranks_segment`; ``"scan"``: the double-float
    :func:`cic_deposit_vranks_sorted`, kernel 5), the V blocks are added
    onto the device's +1-ghost mesh in vrank order (each ghost face falls
    on the next vrank's interior), then the ghost fold (fully periodic
    domains) or the dense assembly. Rows must sit in their vrank's block,
    as the canonical vrank layout keeps them. With several devices this is
    one rank's part (``mesh``)."""
    mesh, coords = _rank_of(dev_grid, mesh)
    full_grid = ProcessGrid(
        tuple(d * v for d, v in zip(dev_grid.shape, vgrid.shape)),
        axis_names=dev_grid.axis_names,
    )
    _check_mesh_shape(domain, full_grid, mesh_shape)
    if method not in ("segment", "scan"):
        raise ValueError(f"method must be 'segment' or 'scan', got {method!r}")
    dev_block = tuple(m // g for m, g in zip(mesh_shape, dev_grid.shape))
    vblock = tuple(b // v for b, v in zip(dev_block, vgrid.shape))
    consts = OnDevice(
        _vrank_origins(domain, dev_grid, vgrid, coords),
        _device_consts(domain, dev_grid, mesh_shape)[1],
    )

    def fn(pos, mass, valid):
        lo_all, inv_h = consts.get(pos.device)
        if method == "scan":
            rho_v = cic_deposit_vranks_sorted(
                pos, mass, valid, lo_all, inv_h, vblock, plain=plain
            )
        else:
            rho_v = cic_deposit_vranks_segment(
                pos, mass, valid, lo_all, inv_h, vblock
            )
        total = torch.zeros(tuple(b + 1 for b in dev_block),
                            dtype=rho_v.dtype, device=rho_v.device)
        for v in range(vgrid.nranks):
            idx = tuple(
                slice(c * b, c * b + b + 1)
                for c, b in zip(vgrid.cell_of_rank(v), vblock)
            )
            total[idx] += rho_v[v]
        if all(domain.periodic):
            return fold_ghosts(total, dev_grid, mesh)
        return assemble_dense(total, dev_grid, domain, mesh)

    return fn


def _device_consts(domain: Domain, dev_grid: ProcessGrid, mesh_shape,
                   coords=None):
    """float32 ``inv_h [D]`` and the origin ``dev_lo [D]`` of the device
    at cell ``coords`` (default 0): ``lo + cell * width``, in float32 as
    the reference computes it."""
    if coords is None:
        coords = (0,) * dev_grid.ndim
    inv_h = np.asarray(
        [m / e for m, e in zip(mesh_shape, domain.extent)], np.float32
    )
    widths = dev_grid.cell_widths(domain)
    dev_lo = np.asarray(
        [np.float32(lo) + np.float32(c) * np.float32(w)
         for lo, c, w in zip(domain.lo, coords, widths)],
        np.float32,
    )
    return dev_lo, inv_h


def shard_deposit_device_planar_fn(domain: Domain, dev_grid: ProcessGrid,
                                   mesh_shape: Tuple[int, ...], core=None,
                                   plain: bool = False, mesh=None):
    """Per-device CIC deposit keyed by device-local cells: ``fn(pos_rows
    [D, m], mass [m], valid [m]) -> rho``. ``core`` selects the engine
    (default :func:`cic_deposit_device_planar`, the double-float scan),
    called as ``core(pos_rows, mass, valid, dev_lo, inv_h, dev_block)``;
    the ghost fold (fully periodic domains: the ``mesh_shape`` block) or
    the dense assembly (any open axis: the :func:`global_node_shape`
    mesh) is shared. With several devices this is one rank's part
    (``mesh``): its block of the ``mesh_shape`` mesh, or the whole dense
    mesh, the same on every rank."""
    mesh, coords = _rank_of(dev_grid, mesh)
    if core is None:
        def core(*args):
            return cic_deposit_device_planar(*args, plain=plain)
    _check_mesh_shape(domain, dev_grid, mesh_shape)
    dev_block = tuple(m // g for m, g in zip(mesh_shape, dev_grid.shape))
    consts = OnDevice(*_device_consts(domain, dev_grid, mesh_shape, coords))

    def fn(pos_rows, mass, valid):
        dev_lo, inv_h = consts.get(pos_rows.device)
        rho = core(pos_rows, mass, valid, dev_lo, inv_h, dev_block)
        with span("dep:place"):
            if all(domain.periodic):
                return fold_ghosts(rho, dev_grid, mesh)
            return assemble_dense(rho, dev_grid, domain, mesh)

    return fn


def shard_deposit_device_mxu_fn(domain: Domain, dev_grid: ProcessGrid,
                                mesh_shape: Tuple[int, ...],
                                vgrid: ProcessGrid = None,
                                plain: bool = False, mesh=None):
    """Per-device throughput deposit (``mass=None`` supported). With
    ``vgrid``, rows must arrive slab-ordered (slab ``v`` holding only
    vrank ``v``'s particles, the migrate loop's steady state) and the
    slab-keyed engine runs, guarded by a residence check; without it,
    the position-keyed flat engine, which assumes no row order."""
    if vgrid is None:
        def flat_core(*args):
            return cic_deposit_device_mxu(*args, plain=plain)

        return shard_deposit_device_planar_fn(
            domain, dev_grid, mesh_shape, core=flat_core, mesh=mesh
        )
    mesh, coords = _rank_of(dev_grid, mesh)
    full_grid = ProcessGrid(
        tuple(d * v for d, v in zip(dev_grid.shape, vgrid.shape)),
        axis_names=dev_grid.axis_names,
    )
    _check_mesh_shape(domain, full_grid, mesh_shape)
    lo_dev = OnDevice(_vrank_origins(domain, dev_grid, vgrid, coords))

    def slab_core(pos_rows, mass, valid, dev_lo, inv_h, dev_block):
        vblock = tuple(b // v for b, v in zip(dev_block, vgrid.shape))
        (lo_v,) = lo_dev.get(pos_rows.device)
        # RESIDENCE GUARD: slab keys are meaningful only while every valid
        # row sits inside its slab's block; a row a capacity backlog left
        # on the wrong slab would be clamped into a wrong cell SILENTLY.
        # The reference lax.cond-routes such calls to the flat engine;
        # eager PyTorch has no sync-free equivalent, so the predicate is
        # read on the host (one sync per call) and only one branch runs.
        key, rel, mass2, in_block = _slab_keys_mxu(
            pos_rows, mass, valid, lo_v, inv_h, vblock
        )
        if host_read(HOST_SYNCS, "residence_guard", in_block):
            return _slab_deposit_from_keys(
                key, rel, mass2, vblock, vgrid.shape, plain=plain
            )
        return cic_deposit_device_mxu(
            pos_rows, mass, valid, dev_lo, inv_h, dev_block, plain=plain
        )

    return shard_deposit_device_planar_fn(
        domain, dev_grid, mesh_shape, core=slab_core, mesh=mesh
    )


def fold_ghosts(rho_ghost: torch.Tensor, grid: ProcessGrid,
                mesh=None) -> torch.Tensor:
    """Fold each axis's upper ghost face onto the +1 neighbor's plane 0,
    in axis order (so edge and corner ghost mass propagates exactly): an
    axis of grid extent 1 folds onto itself (the periodic self-fold), any
    other moves the face to the next rank along it with one
    ``ppermute`` over ``mesh`` (default :func:`~..parallel.mesh.make_mesh`
    of ``grid``)."""
    mesh, _ = _rank_of(grid, mesh)
    for a in range(grid.ndim):
        m = rho_ghost.shape[a] - 1
        ghost = rho_ghost.narrow(a, m, 1)
        body = rho_ghost.narrow(a, 0, m)
        if grid.shape[a] > 1:
            ghost = col.ppermute(ghost, mesh,
                                 mesh_lib.axis_shift_perm(grid, a))
        first = body.narrow(a, 0, 1) + ghost
        rho_ghost = torch.cat([first, body.narrow(a, 1, m - 1)], dim=a)
    return rho_ghost


def assemble_dense(rho_ghost: torch.Tensor, grid: ProcessGrid,
                   domain: Domain, mesh=None) -> torch.Tensor:
    """Assemble the ranks' +1-ghost blocks into the global node mesh (the
    non-periodic alternative to :func:`fold_ghosts`): each rank writes
    its block into a zero canvas of ``cells + 1`` node planes per axis at
    its own offset, the canvases are summed over the ranks in rank order
    (the reference's ``psum``; on one device the block IS the canvas),
    and periodic axes of a mixed domain wrap their top plane onto plane
    0. Returns the :func:`global_node_shape` mesh, the same on every
    rank."""
    mesh, coords = _rank_of(grid, mesh)
    canvas = rho_ghost
    if mesh is not None:
        l = tuple(s - 1 for s in rho_ghost.shape)
        canvas = torch.zeros(tuple(g * la + 1 for g, la in zip(grid.shape, l)),
                             dtype=rho_ghost.dtype, device=rho_ghost.device)
        canvas[tuple(slice(c * la, c * la + la + 1)
                     for c, la in zip(coords, l))] = rho_ghost
        canvas = col.psum_ordered(canvas, mesh)
    for a in range(canvas.dim()):
        if domain.periodic[a]:
            m = canvas.shape[a] - 1
            top = canvas.narrow(a, m, 1)
            first = canvas.narrow(a, 0, 1) + top
            canvas = torch.cat([first, canvas.narrow(a, 1, m - 1)], dim=a)
    return canvas


def shard_deposit_fn_masked(domain: Domain, grid: ProcessGrid,
                            mesh_shape: Tuple[int, ...], method: str = "scan",
                            mesh=None, plain: bool = False):
    """One rank's deposit of row-major rows with an explicit mask (the
    flat migrate loop's live rows are a mask, not a prefix): ``fn(pos
    [N, D], mass [N], valid [N]) -> rho``, and the rank's
    ``local_shape``. ``"scan"`` is the double-float deposit (kernel 5 on
    the card), ``"segment"`` the scatter-add; then the ghost fold (fully
    periodic domains: this rank's ``local_shape`` block) or the dense
    assembly (the :func:`global_node_shape` mesh on every rank)."""
    if method not in ("segment", "scan"):
        raise ValueError(f"method must be 'segment' or 'scan', got {method!r}")
    _check_mesh_shape(domain, grid, mesh_shape)
    mesh, coords = _rank_of(grid, mesh)
    local_shape = tuple(m // g for m, g in zip(mesh_shape, grid.shape))
    consts = OnDevice(*_device_consts(domain, grid, mesh_shape, coords))

    def fn(pos, mass, valid):
        lo_local, inv_h = consts.get(pos.device)
        if method == "scan":
            rho = cic_deposit_local_sorted(pos, mass, valid, lo_local, inv_h,
                                           local_shape, plain=plain)
        else:
            rho = cic_deposit_local(pos, mass, valid, lo_local, inv_h,
                                    local_shape)
        if all(domain.periodic):
            return fold_ghosts(rho, grid, mesh)
        return assemble_dense(rho, grid, domain, mesh)

    return fn, local_shape


def shard_deposit_fn(domain: Domain, grid: ProcessGrid,
                     mesh_shape: Tuple[int, ...], method: str = "scan",
                     mesh=None, plain: bool = False):
    """:func:`shard_deposit_fn_masked` with a count prefix: ``fn(pos [N,
    D], mass [N], count) -> rho`` (rows below ``count`` are live)."""
    masked, local_shape = shard_deposit_fn_masked(
        domain, grid, mesh_shape, method=method, mesh=mesh, plain=plain)

    def fn(pos, mass, count):
        valid = (torch.arange(pos.shape[0], device=pos.device)
                 < count.reshape(()))
        return masked(pos, mass, valid)

    return fn, local_shape


def deposit_out_spec(domain: Domain, grid: ProcessGrid) -> Tuple[str, ...]:
    """How the reference shards the deposit's density (its ``shard_map``
    out_spec, as the tuple of mesh axes it is split over): a fully
    periodic domain splits axis ``a`` of the mesh over grid axis ``a``
    (each rank holds its ``local_shape`` block), a domain with an open
    axis replicates the :func:`global_node_shape` mesh (``()``: every
    rank holds all of it). :func:`shard_deposit_fn` returns exactly that
    shard on each rank."""
    return tuple(grid.axis_names) if all(domain.periodic) else ()


def build_deposit(mesh, domain: Domain, grid: ProcessGrid,
                  mesh_shape: Tuple[int, ...], method: str = "scan",
                  plain: bool = False):
    """The reference's global CIC deposit as each rank sees it: ``fn(pos
    [n, D], mass [n], count) -> rho``, this rank's shard of the density
    (:func:`deposit_out_spec`). ``method`` is ``"scan"`` (kernel 5 on the
    card) or ``"segment"``, the reference's; the port adds ``"mxu"``, the
    position-keyed segmented-sum deposit (kernel 4 on the card) that the
    flat migrate loop runs, ``mass=None`` meaning unit mass."""
    if method != "mxu":
        return shard_deposit_fn(domain, grid, mesh_shape, method=method,
                                mesh=mesh, plain=plain)[0]
    fn = shard_deposit_device_mxu_fn(domain, grid, mesh_shape, plain=plain,
                                     mesh=mesh)

    def call(pos, mass, count):
        valid = (torch.arange(pos.shape[0], device=pos.device)
                 < count.reshape(()))
        return fn(pos.T.contiguous(), mass, valid)

    return call
