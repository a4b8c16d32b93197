"""Periodic wrap, position -> cell -> destination binning, and the
destination sort (port of the JAX package's ``ops/binning.py``): the
migrate loop's planar binning and the canonical exchange's row-major,
planar and ``GridEdges`` routing.

Every float expression keeps the reference's op order on float32
constants computed the same way (numpy float32 arithmetic), because one
ulp is enough to re-home a particle. Two conventions are pinned here and
in the CUDA drift-bin kernel:

  * float -> int32 conversion SATURATES like XLA's: NaN -> 0, +inf and
    values >= 2^31 -> INT_MAX, -inf and values < -2^31 -> INT_MIN
    (:func:`floor_to_int32`). ``Tensor.to(torch.int32)`` alone gives
    INT_MIN for all of these, which after the cell clip would put a huge
    coordinate on an open axis into cell 0 instead of the last cell;
  * multiplications and additions are never fused (no FMA), matching
    the TPU. A jitted JAX function on the CPU does contract ``p + v*dt``,
    so CPU bit comparisons with the drift use a ``dt`` whose product is
    exact (a power of two, or 1.0 as the bench uses).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid


def _is_pow2(x: float) -> bool:
    """True for positive powers of two (reciprocal exactly representable)."""
    if x <= 0 or not math.isfinite(x):
        return False
    mant, _ = math.frexp(x)
    return mant == 0.5


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """0-d float32 constant on ``like``'s device (a Python float operand
    would be a weakly typed scalar; a tensor pins float32 arithmetic).
    Filled on the device: the value is float32-exact, so nothing rounds,
    and no host-to-device copy waits."""
    return torch.full((), float(np.float32(x)), dtype=torch.float32,
                      device=like.device)


def _i32_table(values, like: torch.Tensor) -> torch.Tensor:
    """A small int32 table on ``like``'s device, copied without making the
    host wait for the device."""
    return torch.tensor(values, dtype=torch.int32).to(like.device,
                                                      non_blocking=True)


def floor_to_int32(x: torch.Tensor) -> torch.Tensor:
    """``floor(x)`` as int32 with XLA's saturating conversion: NaN -> 0,
    values beyond the int32 range (and +-inf) clamp to its ends. The
    clamp bound 2^31 - 128 is the largest float32 below 2^31; anything
    the callers clip afterwards to a cell range sees the same cell."""
    f = torch.floor(x)
    f = torch.where(torch.isnan(f), torch.zeros_like(f), f)
    return f.clamp(-2147483648.0, 2147483520.0).to(torch.int32)


def base_cell(r: torch.Tensor, n: int) -> torch.Tensor:
    """``clip(int32(floor(r)), 0, n - 1)``, with XLA's saturating
    float-to-int32 conversion: the cell of a block-local coordinate on an
    axis of ``n`` cells (``csrc/base_cell.cuh`` on the card)."""
    return floor_to_int32(r).clamp(0, n - 1)


def _remainder(q: torch.Tensor, ext) -> torch.Tensor:
    """``jnp.remainder`` semantics: C ``fmod`` plus the sign fix (the
    result takes the divisor's sign). ``torch.remainder`` computes
    ``a - b * floor(a / b)`` instead, which differs in the last bits."""
    e = _f32(ext, q)
    r = torch.fmod(q, e)
    fix = (r != 0) & ((r < 0) != (e < 0))
    return torch.where(fix, r + e, r)


def remainder_fast(q: torch.Tensor, ext: float) -> torch.Tensor:
    """``remainder(q, ext)`` with the reciprocal-multiply path for
    power-of-two extents (exact there: ``1/ext``, the scale and the
    subtraction are all exact), folded into ``[0, ext)`` on every input
    exactly as the reference does; other extents take
    :func:`_remainder`."""
    if _is_pow2(float(ext)):
        inv = _f32(1.0 / ext, q)
        e = _f32(ext, q)
        r = q - torch.floor(q * inv) * e
        return torch.where((r < 0) | (r >= e), torch.zeros_like(r), r)
    return _remainder(q, ext)


def axis_consts(domain: Domain, grid_shape, d: int):
    """Per-axis float32 constants ``(lo, ext, hi, inv_ext, inv_w)``,
    computed with numpy float32 arithmetic so the bits match the
    reference's constant folding (``hi = lo + ext`` and ``inv_w = g / ext``
    are float32 operations; ``inv_ext`` is 0 for non-power-of-two
    extents, which take the fmod path)."""
    lo = np.float32(domain.lo[d])
    ext = np.float32(domain.extent[d])
    hi = np.float32(lo + ext)
    inv_ext = (
        np.float32(np.float32(1.0) / ext)
        if _is_pow2(float(domain.extent[d]))
        else np.float32(0)
    )
    inv_w = np.float32(np.float32(grid_shape[d]) / ext)
    return lo, ext, hi, inv_ext, inv_w


def _wrap_axis(p: torch.Tensor, domain: Domain, d: int) -> torch.Tensor:
    lo = _f32(domain.lo[d], p)
    w = remainder_fast(p - lo, domain.extent[d])
    if domain.lo[d] != 0.0:
        # XLA folds `0 + r` to `r`, which keeps an fmod result of -0.0
        # negative; the add (skipped at lo == 0) would make it +0.0
        w = lo + w
    hi = _f32(np.float32(domain.lo[d]) + np.float32(domain.extent[d]), p)
    return torch.where(w >= hi, lo, w)


def wrap_periodic_planar(pos: torch.Tensor, domain: Domain) -> torch.Tensor:
    """Wrap ``[..., D, n]`` float32 positions into ``[lo, hi)`` along the
    periodic axes; open axes pass through unchanged."""
    out = []
    for d in range(pos.shape[-2]):
        p = pos[..., d, :]
        out.append(_wrap_axis(p, domain, d) if domain.periodic[d] else p)
    return torch.stack(out, dim=-2)


def wrap_periodic(pos: torch.Tensor, domain: Domain) -> torch.Tensor:
    """Wrap row-major ``[..., D]`` float32 positions into ``[lo, hi)``
    along the periodic axes; open axes pass through unchanged (the cell
    clamp handles them). The reference's row-major arithmetic: when every
    periodic extent is a power of two, ``q - floor(q * (1/ext)) * ext``
    with only ``r < 0`` folded to 0; otherwise ``remainder`` on every
    axis; then ``lo + r``, and a result at ``hi`` folds back to ``lo``."""
    fast = all(
        _is_pow2(float(e))
        for e, p in zip(domain.extent, domain.periodic) if p
    )
    add_lo = any(v != 0.0 for v in domain.lo)  # XLA folds an all-zero add
    out = []
    for d in range(domain.ndim):
        p = pos[..., d]
        if not domain.periodic[d]:
            out.append(p)
            continue
        lo = _f32(domain.lo[d], p)
        q = p - lo
        if fast:
            e = _f32(domain.extent[d], p)
            r = q - torch.floor(q * _f32(1.0 / domain.extent[d], p)) * e
            r = torch.where(r < 0, torch.zeros_like(r), r)
        else:
            r = _remainder(q, domain.extent[d])
        w = lo + r if add_lo else r
        hi = _f32(np.float32(domain.lo[d]) + np.float32(domain.extent[d]), p)
        out.append(torch.where(w >= hi, lo, w))
    return torch.stack(out, dim=-1)


def _digitize_edges(p: torch.Tensor, axis_edges) -> torch.Tensor:
    """``#{k in 1..g-1 : p >= edges[k]}`` (``np.digitize`` on the inner
    edges), as a compare-sum against float32 edge values: NaN counts no
    edge and lands in cell 0."""
    c = torch.zeros(p.shape, dtype=torch.int32, device=p.device)
    for k in range(1, len(axis_edges) - 1):
        c = c + (p >= _f32(axis_edges[k], p)).to(torch.int32)
    return c


def _cell_uniform_axis(p: torch.Tensor, axis_edges) -> torch.Tensor:
    """Floor-multiply binning of one uniformly spaced edges axis:
    ``clip(floor((p - lo) * float32(g / (hi - lo))), 0, g - 1)``."""
    g = len(axis_edges) - 1
    lo = _f32(axis_edges[0], p)
    inv = _f32(g / (axis_edges[-1] - axis_edges[0]), p)
    return floor_to_int32((p - lo) * inv).clamp(0, g - 1)


def _cell_edges_axis(p: torch.Tensor, edges, a: int) -> torch.Tensor:
    """One axis of the ``edges`` binning: the floor-multiply for axes that
    :class:`~..domain.GridEdges` found uniform, the digitize otherwise."""
    if edges.uniform_axes[a]:
        return _cell_uniform_axis(p, edges.edges[a])
    return _digitize_edges(p, edges.edges[a])


def _cell_uniform(p: torch.Tensor, domain: Domain, grid: ProcessGrid,
                  d: int) -> torch.Tensor:
    """The canonical path's uniform cell of axis ``d``:
    ``clip(floor((p - lo) * float32(g / ext)), 0, g - 1)``. ``g / ext`` is
    a float64 quotient rounded once to float32, as the reference's
    canonical binning computes it; the migrate loop's :func:`axis_consts`
    divides in float32 instead, which can differ by an ulp."""
    lo = _f32(domain.lo[d], p)
    inv = _f32(grid.shape[d] / domain.extent[d], p)
    return floor_to_int32((p - lo) * inv).clamp(0, grid.shape[d] - 1)


def cell_of_position(pos: torch.Tensor, domain: Domain, grid: ProcessGrid,
                     edges=None) -> torch.Tensor:
    """Row-major ``[..., D]`` positions -> ``[..., D]`` int32 grid cells:
    uniform cells clamped into ``[0, shape - 1]``, or the digitize of
    ``edges`` (a :class:`~..domain.GridEdges`)."""
    cols = []
    for d in range(grid.ndim):
        p = pos[..., d]
        cols.append(_cell_uniform(p, domain, grid, d) if edges is None
                    else _cell_edges_axis(p, edges, d))
    return torch.stack(cols, dim=-1)


def rank_of_cell(cell: torch.Tensor, grid: ProcessGrid) -> torch.Tensor:
    """Flat row-major rank ``[...]`` of ``[..., D]`` cell coordinates."""
    return (cell * _i32_table(grid.strides, cell)).sum(dim=-1,
                                                       dtype=torch.int32)


def _assigned_rank(flat_cell: torch.Tensor, edges) -> torch.Tensor:
    """Fine-cell -> rank table lookup of assignment-aware edges."""
    return _i32_table(edges.assignment, flat_cell)[flat_cell.long()]


def rank_of_position(pos: torch.Tensor, domain: Domain, grid: ProcessGrid,
                     edges=None) -> torch.Tensor:
    """Wrap -> cell -> rank of row-major ``[..., D]`` positions; with
    assignment-aware ``edges`` the fine cell's rank comes from the
    assignment table."""
    cell = cell_of_position(wrap_periodic(pos, domain), domain, grid,
                            edges=edges)
    if edges is not None and edges.assignment is not None:
        flat = (cell * _i32_table(edges.cell_strides, cell)).sum(
            dim=-1, dtype=torch.int32)
        return _assigned_rank(flat, edges)
    return rank_of_cell(cell, grid)


def cell_of_position_planar(pos: torch.Tensor, domain: Domain,
                            grid: ProcessGrid, edges=None) -> torch.Tensor:
    """Planar twin of :func:`cell_of_position`: ``[..., D, n]`` positions
    -> ``[..., D, n]`` int32 cells."""
    out = []
    for d in range(pos.shape[-2]):
        p = pos[..., d, :]
        out.append(_cell_uniform(p, domain, grid, d) if edges is None
                   else _cell_edges_axis(p, edges, d))
    return torch.stack(out, dim=-2)


def rank_of_position_planar(pos: torch.Tensor, domain: Domain,
                            grid: ProcessGrid, edges=None) -> torch.Tensor:
    """Planar twin of :func:`rank_of_position`: ``[..., D, n]`` -> ``[...,
    n]`` int32 ranks."""
    cell = cell_of_position_planar(wrap_periodic_planar(pos, domain), domain,
                                   grid, edges=edges)
    assigned = edges is not None and edges.assignment is not None
    strides = edges.cell_strides if assigned else grid.strides
    rank = None
    for d in range(cell.shape[-2]):
        t = cell[..., d, :] * strides[d]
        rank = t if rank is None else rank + t
    return _assigned_rank(rank, edges) if assigned else rank


def dest_histogram(dest: torch.Tensor, nranks: int,
                   valid: torch.Tensor = None) -> torch.Tensor:
    """Per-destination counts ``[nranks]`` int32 of ``[N]`` ranks; the
    sentinel ``nranks`` (and any id outside ``[0, nranks]``, which the
    reference's ``segment_sum`` drops) counts nowhere."""
    keep = (dest >= 0) & (dest <= nranks)
    if valid is not None:
        keep = keep & valid
    out = torch.zeros((nranks + 1,), dtype=torch.int32, device=dest.device)
    out.scatter_add_(0, dest.clamp(0, nranks).long(), keep.to(torch.int32))
    return out[:nranks]


def dest_histogram_np(dest, nranks: int, valid=None) -> np.ndarray:
    """NumPy twin of :func:`dest_histogram` for the oracle backend."""
    weights = np.ones(dest.shape, dtype=np.int64)
    if valid is not None:
        weights = weights * valid.astype(np.int64)
    return np.bincount(dest, weights=weights, minlength=nranks + 1)[
        :nranks
    ].astype(np.int32)


def dest_key_planar(pos: torch.Tensor, alive: torch.Tensor, domain: Domain,
                    full_grid: ProcessGrid, V: int, R_total: int,
                    assignment: torch.Tensor = None,
                    me_dev: int = 0) -> torch.Tensor:
    """The single-device vrank engine's binning: ``[D, V*n]`` float32
    positions (already drift-wrapped) and ``[V*n]`` alive flags ->
    ``[V, n]`` int32 destination key. Periodic axes are wrapped once
    more (an identity for ``lo == 0``, replicated for bit equality),
    binned by floor-multiply + clip + stride; stayers and holes get the
    sentinel ``R_total``.

    With ``assignment`` (an int32 ``[n_cells]`` table on ``pos``'s
    device, cell -> global rank ``dev * V + v``) ``full_grid`` is the
    CELL grid: the strides accumulate the row-major cell id, and one
    gather from the table gives the rank, split as ``dev = g // V``,
    ``v = g - dev * V`` (a row stays when ``dev`` is this device,
    ``me_dev``, and ``v`` its vrank; the key is ``g`` itself)."""
    m = pos.shape[-1]
    n = m // V
    dv = torch.zeros((m,), dtype=torch.int32, device=pos.device)
    for d in range(domain.ndim):
        pd = pos[d]
        if domain.periodic[d]:
            pd = _wrap_axis(pd, domain, d)
        lo, _, _, _, inv_w = axis_consts(domain, full_grid.shape, d)
        cell = floor_to_int32((pd - _f32(lo, pd)) * _f32(inv_w, pd))
        cell = cell.clamp(0, full_grid.shape[d] - 1)
        dv = dv + cell * full_grid.strides[d]
    me = torch.arange(V, dtype=torch.int32, device=pos.device)[:, None]
    if assignment is None:
        dv = dv.reshape(V, n)
        stay = dv == me
    else:
        # every index is in range after the clip: a device gather, no
        # host lookup
        dv = assignment[dv].reshape(V, n)  # = dev * V + v
        g_dev = torch.div(dv, V, rounding_mode="floor")
        stay = (g_dev == me_dev) & (dv - g_dev * V == me)
    return torch.where(
        alive.reshape(V, n) & ~stay, dv, torch.full_like(dv, R_total)
    )


def dest_key_planar_ranks(pos: torch.Tensor, alive: torch.Tensor,
                          domain: Domain, dev_grid: ProcessGrid,
                          vgrid: ProcessGrid, me_dev: int) -> torch.Tensor:
    """The migrate engines' binning across ranks: ``[D, V*n]`` float32
    positions (drift-wrapped) of device ``me_dev``'s ``V`` vranks ->
    ``[V, n]`` int32 DEVICE-MAJOR key ``dev * V + v``, sentinel
    ``dev_grid.nranks * V`` on stayers and holes. The full grid is
    ``dev_grid.shape * vgrid.shape``; an axis's cell splits into the
    device ``cell // vs`` and the vrank ``cell % vs`` (kept as the cell
    itself on an axis with one device, as the reference does). With a
    one-vrank ``vgrid`` this is the flat engine's ``dest = rank of the
    cell``."""
    V = vgrid.nranks
    m = pos.shape[-1]
    n = m // V
    full = tuple(d * v for d, v in zip(dev_grid.shape, vgrid.shape))
    d_dev = torch.zeros((m,), dtype=torch.int32, device=pos.device)
    d_v = torch.zeros((m,), dtype=torch.int32, device=pos.device)
    for d in range(domain.ndim):
        pd = pos[d]
        if domain.periodic[d]:
            pd = _wrap_axis(pd, domain, d)
        lo, _, _, _, inv_w = axis_consts(domain, full, d)
        cell = floor_to_int32((pd - _f32(lo, pd)) * _f32(inv_w, pd))
        cell = cell.clamp(0, full[d] - 1)
        vs = vgrid.shape[d]
        if dev_grid.shape[d] == 1:
            d_v = d_v + cell * vgrid.strides[d]
        else:
            d_dev = d_dev + torch.div(cell, vs, rounding_mode="floor") * (
                dev_grid.strides[d])
            d_v = d_v + torch.remainder(cell, vs) * vgrid.strides[d]
    d_dev = d_dev.reshape(V, n)
    d_v = d_v.reshape(V, n)
    me_v = torch.arange(V, dtype=torch.int32, device=pos.device)[:, None]
    stay = (d_dev == me_dev) & (d_v == me_v)
    return torch.where(alive.reshape(V, n) & ~stay, d_dev * V + d_v,
                       torch.full_like(d_v, dev_grid.nranks * V))


def sorted_dest_counts_batched(dest: torch.Tensor, n_dest: int):
    """Stable sort of each ``[V, n]`` key row by destination, with the
    per-destination counts read off the sorted keys by binary search.

    Returns ``(order [V, n], counts [V, n_dest], bounds [V, n_dest + 1])``
    as int32; ``bounds`` are the segment starts in sorted space and the
    sentinel ``n_dest`` (stayers, holes) sorts to the tail uncounted.

    The reference's two-level leaver selection (chunk sorts plus one
    small candidate sort) is left out: only the leaver prefix of
    ``order`` (its first ``counts[v].sum()`` entries), the counts and
    the bounds are contractual there, and this flat packed sort
    reproduces all three bit for bit. Its tail is the sentinel-sorted
    stayers, which no consumer reads.
    """
    V, n = dest.shape
    dev = dest.device
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    b = max(1, (n - 1).bit_length())
    if n_dest + 1 <= (1 << (31 - b)):
        # packed single-operand sort: (dest << b) | iota is unique, so an
        # unstable one-word sort equals the stable (key, iota) sort
        packed = torch.sort((dest << b) | iota, dim=-1).values
        order = packed & ((1 << b) - 1)
        edges = torch.arange(n_dest + 1, dtype=torch.int32, device=dev) << b
    else:
        packed, idx = torch.sort(dest, dim=-1, stable=True)
        order = idx.to(torch.int32)
        edges = torch.arange(n_dest + 1, dtype=torch.int32, device=dev)
    bounds = torch.searchsorted(
        packed, edges.expand(V, -1).contiguous(), side="left"
    ).to(torch.int32)
    return order, bounds[:, 1:] - bounds[:, :-1], bounds


def bounds_dense(keys_sorted: torch.Tensor, n_edges: int,
                 stride: int = 1) -> torch.Tensor:
    """``searchsorted(keys_sorted, arange(n_edges) * stride, 'left')`` as
    int32: for each edge, the number of keys below it. Keys past the last
    edge (sentinels) fall in no bound. The reference builds this from two
    sorts because the TPU's searchsorted scatters; one
    ``torch.searchsorted`` gives the same integers."""
    if (n_edges - 1) * stride >= 2**31:
        raise ValueError(
            f"bounds_dense: edge grid (n_edges={n_edges}, stride={stride}) "
            f"exceeds int32"
        )
    edges = torch.arange(
        n_edges, dtype=torch.int32, device=keys_sorted.device
    ) * stride
    return torch.searchsorted(keys_sorted, edges, side="left").to(torch.int32)


def sorted_dest_counts(dest: torch.Tensor, n_dest: int):
    """One-row :func:`sorted_dest_counts_batched`: ``[N]`` keys ->
    ``(order [N], counts [n_dest], bounds [n_dest + 1])``."""
    order, counts, bounds = sorted_dest_counts_batched(dest[None], n_dest)
    return order[0], counts[0], bounds[0]


def sparse_select_params(n: int, block: int, *, chunk: int = 4096):
    """``(chunk, cap)`` for :func:`sorted_mover_block` from the row width
    and the mover-block width: ``chunk`` shrinks below ``n``; ``cap`` puts
    a uniformly spread mover population at the full ``block`` density ~4x
    under the per-chunk guard, rises to ``block`` when the block fits in
    half a chunk (the leaver-count check then subsumes the chunk guard),
    and stays at most ``chunk // 2``."""
    while chunk >= max(2, n) and chunk > 8:
        chunk //= 2
    exp = max(1, -(-block * chunk // max(1, n)))
    cap = 1 << (4 * exp - 1).bit_length()
    if block <= chunk // 2:
        cap = max(cap, 1 << max(0, block - 1).bit_length())
    cap = max(1, min(cap, chunk // 2))
    return chunk, cap


def sparse_select_feasible(n: int, n_dest: int, *, chunk: int = 4096,
                           cap: int = 512) -> bool:
    """True when :func:`sorted_mover_block` can be built for this shape:
    a power-of-two ``chunk``, packed keys within int32 at both levels,
    candidates fewer than the rows, and no ``MPI_GRID_SELECT=flat``
    override (read at each call, as the reference reads it at trace
    time). The per-step guard is the ``ok`` the builder returns."""
    bN = max(1, (n - 1).bit_length())
    bT = (chunk - 1).bit_length()
    nc = -(-n // chunk)
    return not (
        chunk <= 0
        or chunk & (chunk - 1)
        or n_dest + 1 > (1 << (31 - bN))
        or n_dest + 1 > (1 << (31 - bT))
        or nc * cap >= n
        or os.environ.get("MPI_GRID_SELECT") == "flat"
    )


def sorted_mover_block(dest: torch.Tensor, n_dest: int, block: int, *,
                       chunk: int = 4096, cap: int = 512):
    """Two-level leaver selection compacted to a dense ``[V, block]``
    mover block (the front end of the mover-sparse migrate engine).

    Each ``chunk``-wide piece of a ``[V, n]`` key row is sorted on the
    packed int32 key ``(dest << bT) | iota_t`` (unique within the chunk,
    so the unstable sort equals the stable one); its first ``cap``
    entries are the candidates, repacked as ``(dest << bN) | position``
    with dead candidates as ``n_dest << bN`` (zero position bits), and
    one ``[V, nc * cap]`` sort orders them. When no chunk holds more than
    ``cap`` leavers this is the stable (dest, position) order of the flat
    sort, bit for bit; counts and bounds are read off it by search.

    Returns ``(block_rows [V, block], counts [V, n_dest], bounds
    [V, n_dest + 1], ok)``: leaver rows zero-padded past the leaver
    count, and ``ok`` a 0-d bool tensor, True iff no chunk overflowed
    ``cap`` and every row's leavers fit in ``block`` (otherwise the other
    outputs are not contractual). Raises ``ValueError`` when
    :func:`sparse_select_feasible` is False."""
    V, n = dest.shape
    if not sparse_select_feasible(n, n_dest, chunk=chunk, cap=cap):
        raise ValueError(
            f"sorted_mover_block infeasible for n={n}, n_dest={n_dest}, "
            f"chunk={chunk}, cap={cap} (gate on sparse_select_feasible)"
        )
    dev = dest.device
    i32 = torch.int32
    bN = max(1, (n - 1).bit_length())
    bT = (chunk - 1).bit_length()
    nc = -(-n // chunk)
    npad = nc * chunk - n
    ch = dest.to(i32)
    if npad:
        ch = torch.cat(
            [ch, torch.full((V, npad), n_dest, dtype=i32, device=dev)], dim=1
        )
    ch = ch.reshape(V, nc, chunk)
    lc = (ch != n_dest).sum(dim=-1, dtype=i32)  # [V, nc]
    iota_t = torch.arange(chunk, dtype=i32, device=dev)
    # every shift stays int32 (the feasibility gate bounds it): an int64
    # key would double the bytes each sort moves
    packed1 = torch.sort((ch << bT) | iota_t, dim=-1).values
    cand = packed1[:, :, :cap]
    dest_c = cand >> bT
    pos_g = (
        torch.arange(nc, dtype=i32, device=dev)[None, :, None] * chunk
    ) | (cand & (chunk - 1))
    live = torch.arange(cap, dtype=i32, device=dev)[None, None, :] < lc[:, :, None]
    packed2 = torch.where(live, (dest_c << bN) | pos_g, n_dest << bN)
    packed2 = torch.sort(packed2.reshape(V, nc * cap), dim=-1).values
    order_c = packed2 & ((1 << bN) - 1)
    edges = torch.arange(n_dest + 1, dtype=i32, device=dev) << bN
    bounds = torch.searchsorted(
        packed2, edges.expand(V, -1).contiguous(), side="left"
    ).to(i32)
    counts = bounds[:, 1:] - bounds[:, :-1]
    if block <= nc * cap:
        block_rows = order_c[:, :block]
    else:
        block_rows = torch.zeros((V, block), dtype=i32, device=dev)
        block_rows[:, : nc * cap] = order_c
    leavers = counts.sum(dim=1, dtype=i32)
    ok = (lc.max() <= cap) & (leavers.max() <= block)
    return block_rows, counts, bounds, ok
