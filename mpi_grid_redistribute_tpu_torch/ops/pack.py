"""Sort-by-destination pack and receive-side compaction (port of the JAX
package's ``ops/pack.py``).

MPI's ``Alltoallv`` is variable-size; the canonical exchange makes it
static: every (source, destination) pair gets ``capacity`` slots, rows
are gathered into a ``[R, capacity, ...]`` send layout, unused slots are
zero, and overflow past a capacity is counted, never dropped silently.
The receive side compacts the pool into exact ``Alltoallv`` receive
order: source-major, stable within a source, a rank's own rows spliced
in at source position ``me``.

Every function here takes optional LEADING batch dimensions (the vrank
axis ``V`` of the one-device engines) in front of the reference's
shapes, so one call packs or compacts all virtual ranks at once; the
batch dimensions of all arguments match. The reference's payload-carrying
``lax.sort`` becomes one ``torch.sort`` of a unique key and one gather of
the payload: with unique keys the result does not depend on whether the
sort is stable.
"""

from __future__ import annotations

import torch


def _zero(a: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=a.dtype, device=a.device)


def _mask_rows(a: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero the rows of ``a`` where ``mask`` (``a``'s leading dims) is
    False."""
    extra = a.dim() - mask.dim()
    return torch.where(mask.reshape(mask.shape + (1,) * extra), a, _zero(a))


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``a [*B, n, ...]`` at ``idx [*B, k]`` (per batch entry) ->
    ``[*B, k, ...]``: one flat ``index_select``."""
    b = idx.dim() - 1
    batch = tuple(idx.shape[:b])
    n = a.shape[b]
    nb = 1
    for s in batch:
        nb *= s
    rest = tuple(a.shape[b + 1:])
    off = torch.arange(nb, device=idx.device, dtype=torch.int64) * n
    flat = (idx.reshape(nb, -1).long() + off[:, None]).reshape(-1)
    out = a.reshape((nb * n,) + rest).index_select(0, flat)
    return out.reshape(batch + (idx.shape[-1],) + rest)


def _take_cols(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Columns of planar ``values [*B, K, m]`` at ``idx [*B, k]`` ->
    ``[*B, K, k]``."""
    idx = idx.long().unsqueeze(-2).expand(
        idx.shape[:-1] + (values.shape[-2], idx.shape[-1])
    )
    return torch.gather(values, -1, idx)


def _take_rows(order: torch.Tensor, out_capacity: int) -> torch.Tensor:
    """The first ``out_capacity`` entries of ``order`` along its last dim,
    zero-padded when the pool is smaller than the output (the caller's
    validity mask zeroes those rows)."""
    take = order[..., :out_capacity]
    pad = out_capacity - take.shape[-1]
    if pad > 0:
        take = torch.cat(
            [take, torch.zeros(take.shape[:-1] + (pad,), dtype=take.dtype,
                               device=take.device)], dim=-1)
    return take


def pack_by_destination(dest: torch.Tensor, counts: torch.Tensor, arrays,
                        capacity: int, order: torch.Tensor = None):
    """Gather row-major arrays into a ``[*B, R, capacity, ...]`` send
    layout.

    ``dest [*B, n]``: destination per row, the sentinel ``R`` for rows
    that are not sent. ``counts [*B, R]``: the full (unclipped) counts,
    which locate each destination's segment in the sorted order; slots
    past ``min(counts[r], capacity)`` are zero, so overflow keeps the
    stable prefix. ``arrays``: a tuple of ``[*B, n, ...]``. ``order``: the
    stable by-destination permutation when the caller has it. Returns a
    tuple of ``[*B, R, capacity, ...]``."""
    R = counts.shape[-1]
    n = dest.shape[-1]
    if order is None:
        order = torch.sort(dest, dim=-1, stable=True).indices
    start = torch.cumsum(counts, dim=-1) - counts
    c_idx = torch.arange(capacity, dtype=torch.int32, device=dest.device)
    lead = tuple(counts.shape[:-1])
    flat_src = (start[..., :, None] + c_idx).reshape(lead + (R * capacity,))
    slot_valid = (
        c_idx < counts.clamp(max=capacity)[..., None]
    ).reshape(lead + (R * capacity,))
    gather_idx = torch.gather(order.long(), -1,
                              flat_src.clamp(max=n - 1).long())
    out = []
    for a in arrays:
        t = _mask_rows(_take(a, gather_idx), slot_valid)
        out.append(t.reshape(lead + (R, capacity) + tuple(a.shape[len(lead)
                                                                 + 1:])))
    return tuple(out)


def _stable_order(invalid: torch.Tensor, *subkeys: torch.Tensor):
    """Permutation (int64) along the last dim putting valid rows first,
    ordered by ``subkeys`` then by position (stable). With no subkeys
    and ``m <= 2^30`` rows it is one sort of the packed word ``invalid <<
    b | iota``, unique, so an unstable sort gives the stable order; with
    subkeys, stable sorts from the last key to the first."""
    m = invalid.shape[-1]
    iota = torch.arange(m, dtype=torch.int32, device=invalid.device)
    b = max(1, (m - 1).bit_length())
    if not subkeys and b <= 30:
        packed = torch.sort((invalid.to(torch.int32) << b) | iota,
                            dim=-1).values
        return (packed & ((1 << b) - 1)).long()
    order = iota.long().expand(invalid.shape)
    for key in reversed((invalid.to(torch.int32),) + subkeys):
        k = torch.gather(key, -1, order)
        order = torch.gather(order, -1,
                             torch.sort(k, dim=-1, stable=True).indices)
    return order


def _finish_compact(values, order, new_count_full, out_capacity: int):
    """Shared compaction tail: the first ``out_capacity`` rows of the
    ordered pool, the invalid tail zeroed; count and overflow."""
    dropped = (new_count_full - out_capacity).clamp(min=0)
    new_count = new_count_full.clamp(max=out_capacity)
    take = _take_rows(order, out_capacity)
    row_valid = torch.arange(
        out_capacity, dtype=torch.int32, device=order.device
    ) < new_count[..., None]
    out = tuple(_mask_rows(_take(a, take), row_valid) for a in values)
    return out, new_count.to(torch.int32), dropped.to(torch.int32)


def pool_source_keys(recv_counts: torch.Tensor, self_mask: torch.Tensor,
                     me, capacity: int):
    """Alltoallv-order keys ``(invalid, source_key)`` over a ``[*B, R *
    capacity]`` receive pool followed by ``n`` local rows: remote slot
    ``(s, c)`` carries source ``s`` (valid iff ``c < recv_counts[s]``), a
    local row carries source ``me`` (valid iff ``self_mask``). Sorting by
    (invalid, source, position) is MPI Alltoallv receive order with the
    rank's own rows spliced in at source ``me``; the row-major and planar
    compactions share these keys."""
    R = recv_counts.shape[-1]
    n = self_mask.shape[-1]
    dev = recv_counts.device
    lead = tuple(recv_counts.shape[:-1])
    c_idx = torch.arange(capacity, dtype=torch.int32, device=dev)
    valid_r = (c_idx < recv_counts[..., None]).reshape(lead + (R * capacity,))
    src_r = (torch.arange(R * capacity, dtype=torch.int32, device=dev)
             // capacity).expand(lead + (R * capacity,))
    if not isinstance(me, torch.Tensor):
        me = torch.full((), me, dtype=torch.int32, device=dev)
    src_s = me[..., None].expand(lead + (n,))
    invalid = ~torch.cat([valid_r, self_mask], dim=-1)
    source_key = torch.cat([src_r, src_s], dim=-1)
    return invalid, source_key


def compact_with_self(recv, recv_counts: torch.Tensor, local,
                      self_mask: torch.Tensor, me, out_capacity: int):
    """Merge row-major receives with the rows a rank keeps, in Alltoallv
    order. ``recv``: tuple of ``[*B, R, capacity, ...]`` (nothing is sent
    to self); ``recv_counts [*B, R]``; ``local``: tuple of the original
    ``[*B, n, ...]`` arrays; ``self_mask [*B, n]`` the rows kept; ``me``
    the rank (``[*B]``). Returns ``(tuple of [*B, out_capacity, ...],
    new_count [*B], dropped [*B])``."""
    first = recv[0]
    b = recv_counts.dim() - 1
    R, capacity = first.shape[b], first.shape[b + 1]
    invalid, source_key = pool_source_keys(recv_counts, self_mask, me,
                                           capacity)
    order = _stable_order(invalid, source_key)
    values = tuple(
        torch.cat([a.reshape(tuple(a.shape[:b]) + (R * capacity,)
                             + tuple(a.shape[b + 2:])), l], dim=b)
        for a, l in zip(recv, local)
    )
    new_full = recv_counts.sum(dim=-1, dtype=torch.int32) + self_mask.sum(
        dim=-1, dtype=torch.int32)
    return _finish_compact(values, order, new_full, out_capacity)


def compact_received(recv, recv_counts: torch.Tensor, out_capacity: int):
    """Compact a ``[*B, R, capacity, ...]`` receive layout into ``[*B,
    out_capacity, ...]``, valid rows in source-major stable order (MPI
    Alltoallv's receive order). Returns ``(tuple, new_count, dropped)``."""
    first = recv[0]
    b = recv_counts.dim() - 1
    R, capacity = first.shape[b], first.shape[b + 1]
    lead = tuple(recv_counts.shape[:-1])
    c_idx = torch.arange(capacity, dtype=torch.int32,
                         device=recv_counts.device)
    valid = (c_idx < recv_counts[..., None]).reshape(lead + (R * capacity,))
    order = _stable_order(~valid)
    values = tuple(
        a.reshape(lead + (R * capacity,) + tuple(a.shape[b + 2:]))
        for a in recv
    )
    return _finish_compact(values, order,
                           recv_counts.sum(dim=-1, dtype=torch.int32),
                           out_capacity)


def planar_compact_with_self(pool: torch.Tensor, recv_counts: torch.Tensor,
                             me, self_mask: torch.Tensor, local: torch.Tensor,
                             out_capacity: int):
    """Planar twin of :func:`compact_with_self`: ``[*B, K, R*C]`` receive
    pool and ``[*B, K, n]`` kept columns -> ``[*B, K, out_capacity]`` in
    Alltoallv receive order (the keys of :func:`pool_source_keys`).
    Returns ``(out, new_count, dropped)``; columns past ``new_count`` are
    zero."""
    R = recv_counts.shape[-1]
    C = pool.shape[-1] // R
    invalid, source_key = pool_source_keys(recv_counts, self_mask, me, C)
    values = torch.cat([pool, local], dim=-1)
    new_full = recv_counts.sum(dim=-1, dtype=torch.int32) + self_mask.sum(
        dim=-1, dtype=torch.int32)
    return planar_compact_keys(values, invalid, source_key, R, new_full,
                               out_capacity)


def planar_compact_keys(values: torch.Tensor, invalid: torch.Tensor,
                        source_key: torch.Tensor, n_sources: int,
                        new_full: torch.Tensor, out_capacity: int):
    """Compact the ``[*B, K, m]`` column pool ``values`` by Alltoallv-order
    keys: invalid columns take the sentinel source ``n_sources`` and sort
    last. When ``n_sources + 1 <= 2^(31 - bM)`` (``bM`` the bits of
    ``m - 1``) the key is the packed int32 word ``source << bM | iota``;
    otherwise one stable sort of the source key, which orders like the
    reference's two-key ``(source, iota)`` sort. Either way only the
    first ``out_capacity`` columns are gathered. ``new_full [*B]`` is the
    caller's valid total. Returns ``(out [*B, K, out_capacity],
    new_count, dropped)``."""
    source_key = torch.where(
        invalid, torch.full((), n_sources, dtype=torch.int32,
                            device=invalid.device), source_key.to(torch.int32))
    m = values.shape[-1]
    bM = max(1, (m - 1).bit_length())
    if n_sources + 1 <= (1 << (31 - bM)):
        iota = torch.arange(m, dtype=torch.int32, device=values.device)
        packed = torch.sort((source_key << bM) | iota, dim=-1).values
        order = packed & ((1 << bM) - 1)
    else:
        order = torch.sort(source_key, dim=-1, stable=True).indices
    payload = _take_cols(values, order[..., :out_capacity])
    pad = out_capacity - payload.shape[-1]
    if pad > 0:  # pool smaller than the output: the mask keeps it zero
        payload = torch.cat(
            [payload, torch.zeros(payload.shape[:-1] + (pad,),
                                  dtype=payload.dtype,
                                  device=payload.device)], dim=-1)
    dropped = (new_full - out_capacity).clamp(min=0)
    new_count = new_full.clamp(max=out_capacity)
    col_valid = torch.arange(
        out_capacity, dtype=torch.int32, device=values.device
    ) < new_count[..., None]
    out = torch.where(col_valid.unsqueeze(-2), payload, _zero(payload))
    return out, new_count.to(torch.int32), dropped.to(torch.int32)


def gather_plan_cols(fused: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather plan-addressed columns of a planar ``[K, W]`` matrix in one
    flat gather: ``idx [...]`` (flat column indices into ``W``, already
    clipped in range) -> ``[K, *idx.shape]``. Callers mask invalid slots
    themselves."""
    flat = torch.index_select(fused, 1, idx.reshape(-1))
    return flat.reshape((fused.shape[0],) + tuple(idx.shape))


def pack_cols(fused: torch.Tensor, order: torch.Tensor, bounds: torch.Tensor,
              send_counts: torch.Tensor, n_dest: int, capacity: int):
    """Gather the first ``send_counts[d]`` sorted columns of each
    destination segment of ``fused [*B, K, n]`` into a ``[*B, K, n_dest *
    C]`` send pool, zero in invalid slots (the planar twin of
    :func:`pack_by_destination`). ``order [*B, n]`` is the sort-by-
    destination permutation and ``bounds [*B, >= n_dest]`` its segment
    starts. Returns ``(send, gather_idx)``; ``gather_idx [*B, n_dest * C]``
    is the resident column feeding each send slot."""
    n = fused.shape[-1]
    C = capacity
    dev = fused.device
    slot = torch.arange(n_dest * C, dtype=torch.int32, device=dev)
    flat_c = slot % C
    flat_d = slot // C
    slot_valid = flat_c < send_counts.index_select(-1, flat_d)
    src = (bounds.index_select(-1, flat_d) + flat_c).clamp(max=n - 1)
    gather_idx = torch.gather(order.long(), -1, src.long())
    send = torch.where(slot_valid.unsqueeze(-2), _take_cols(fused, gather_idx),
                       _zero(fused))
    return send, gather_idx
