"""The canonical redistribute (port of the JAX package's
``parallel/exchange.py``): engine names and their resolution, the stats
record, the single-device vrank engines (planar ``[V, K, n]``, row-major,
and the count-driven sparse and neighbor twins) and the multi-rank ones,
one rank a process over a :class:`~.mesh.RankMesh` (the same four).

The pipeline per virtual rank: bin every row to its destination rank,
sort by destination (the rank's own rows stay local), pack the first
``capacity`` rows of each destination segment, exchange, and compact the
received pool plus the kept rows into MPI ``Alltoallv`` receive order.
On one device the V ranks are the leading batch dimension of every
tensor, and the wire is the transpose an all-to-all would perform; across
ranks it is the all-to-all (:mod:`.collectives`). The count-driven
engines decide their branch from a flag every rank agrees on (a MIN
across ranks), read on the host. The hierarchical two-level engine
splits the grid into pods (:class:`~.mesh.HierarchicalMesh`): the
pod-local stencil inside a pod, one condensed block a destination pod
across them, on one device (static gathers) and across ranks (sub-axis
collectives, one world call each). The two-phase surface
(:func:`resolve_two_phase`, :func:`start_exchange`,
:func:`finish_exchange`) splits a migrate step into its issue and its
landing for the pipelined service chunk.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch import _device
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops import binning, pack
from mpi_grid_redistribute_tpu_torch.parallel import collectives as col
from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib
from mpi_grid_redistribute_tpu_torch.telemetry.phases import traced_span

ENGINES = (
    "auto", "planar", "rowmajor", "sparse", "neighbor", "hierarchical"
)


def resolve_engine(
    engine: str,
    *,
    vranks: bool = False,
    n_devices: int = 1,
    planar_ok: bool = True,
    canonical: bool = False,
    n_pods: int = 1,
    recorder=None,
) -> str:
    """Resolve a user-facing engine name to a concrete engine, by the
    reference's one rule for both surfaces.

    Canonical exchange (``canonical=True``): ``"auto"`` picks
    ``"hierarchical"`` on a multi-pod multi-device mesh, ``"sparse"`` on
    other multi-device meshes, ``"planar"`` on one device and
    ``"rowmajor"`` when the payload is not planar-eligible (``planar_ok``
    False); explicit names are honoured, ``"hierarchical"`` degrading to
    ``"sparse"`` on a flat mesh.

    Migrate loop (``canonical=False``): ``"auto"``/``"sparse"`` give the
    mover-sparse engine exactly on a single-device vrank step (``vranks``
    and ``n_devices == 1``), ``"planar"`` otherwise (an explicit
    ``"sparse"`` across devices degrades: cross-device steps stay
    dense); the canonical-only names raise ``ValueError``.

    ``recorder`` (a :class:`~..telemetry.recorder.StepRecorder`) journals
    the decision as an ``engine_resolved`` event: the engine and the
    reason, the reference's words, degradations included."""
    if engine not in ENGINES:
        raise ValueError(
            f"engine must be one of {ENGINES}, got {engine!r}"
        )
    if canonical:
        if engine == "rowmajor":
            resolved, reason = "rowmajor", "explicit rowmajor"
        elif engine == "planar":
            resolved, reason = "planar", "explicit planar (dense pool)"
        elif engine == "neighbor":
            resolved, reason = "neighbor", "explicit neighbor stencil"
        elif engine == "sparse":
            resolved, reason = "sparse", "explicit count-driven sparse"
        elif engine == "hierarchical":
            resolved, reason = (
                ("hierarchical", "explicit hierarchical two-level wire")
                if n_pods > 1 else
                ("sparse", "hierarchical -> sparse: flat mesh (no dcn "
                           "domains)"))
        elif not planar_ok:
            resolved, reason = "rowmajor", "auto: payload not planar-eligible"
        elif n_devices > 1 and n_pods > 1:
            resolved, reason = (
                "hierarchical",
                "auto: multi-pod mesh -> hierarchical two-level wire")
        elif n_devices > 1:
            resolved, reason = (
                "sparse", "auto: multi-device -> count-driven wire")
        else:
            resolved, reason = (
                "planar", "auto: single device, no wire to shrink")
    else:
        if engine in ("rowmajor", "neighbor", "hierarchical"):
            raise ValueError(
                f"engine={engine!r} is a canonical-exchange engine; the "
                "migrate loop accepts 'auto', 'sparse' or 'planar'"
            )
        if engine in ("auto", "sparse") and vranks and n_devices == 1:
            resolved, reason = "sparse", "migrate: single-device vranks"
        elif engine == "sparse":
            resolved, reason = (
                "planar",
                "sparse -> planar: cross-device migrate steps stay dense")
        else:
            resolved, reason = "planar", "migrate: dense planar step"
    if recorder is not None:
        recorder.record("engine_resolved", requested=engine,
                        resolved=resolved, reason=reason,
                        canonical=bool(canonical))
    return resolved


class RedistributeStats(NamedTuple):
    """Per-call observability, as int32 tensors: ``send_counts [R, R]``
    indexed ``[source, dest]`` (self rows on the diagonal),
    ``recv_counts`` its transpose, the drop counters ``[R]``, and
    ``needed_capacity [R]``, each rank's largest unclipped remote
    per-destination count (the smallest ``capacity`` that would have sent
    everything). ``fallback`` ``[R]`` is 1 where a count-driven engine
    ran the dense width (``None`` from the dense engines);
    ``needed_cross [R]`` is the hierarchical engine's per-rank peak over
    destination pods of its unclipped cross-pod rows (the smallest
    ``cross_cap`` that would have carried them; ``None`` elsewhere);
    ``pipeline [R]`` is 1 where a step of the software-pipelined chunk
    (``service.pipeline``) ran with every mover granted, 0 where its flow
    control withheld some (``None`` from every other engine)."""

    send_counts: torch.Tensor
    recv_counts: torch.Tensor
    dropped_send: torch.Tensor
    dropped_recv: torch.Tensor
    needed_capacity: torch.Tensor
    fallback: torch.Tensor = None
    pipeline: torch.Tensor = None
    needed_cross: torch.Tensor = None


def _route(dest: torch.Tensor, count: torch.Tensor, V: int, capacity: int,
           me: torch.Tensor = None):
    """The shared routing prefix of every engine: ``dest [B, n]`` ranks of
    the ``B`` ranks ``me [B]`` (default: all ``V`` ranks of one device) ->
    ``(is_self, order, remote_counts, bounds, send_counts,
    dropped_send)``. Rows past ``count [B]`` and the rank's own rows take
    the sentinel ``V`` and are not sent."""
    n = dest.shape[1]
    dev = dest.device
    valid = torch.arange(n, dtype=torch.int32, device=dev) < count[:, None]
    if me is None:
        me = torch.arange(V, dtype=torch.int32, device=dev)
    me = me[:, None]
    sentinel = torch.full((), V, dtype=torch.int32, device=dev)
    dest = torch.where(valid, dest, sentinel)
    is_self = valid & (dest == me)
    dest_remote = torch.where(is_self, sentinel, dest)
    order, remote_counts, bounds = binning.sorted_dest_counts_batched(
        dest_remote, V
    )
    dropped_send = (remote_counts - capacity).clamp(min=0).sum(
        dim=1, dtype=torch.int32)
    send_counts = remote_counts.clamp(max=capacity)
    return is_self, order, remote_counts, bounds, send_counts, dropped_send


def _stats(send_counts, is_self, remote_counts, dropped_send, dropped_recv):
    self_diag = torch.diag(is_self.sum(dim=1, dtype=torch.int32))
    return RedistributeStats(
        send_counts=send_counts + self_diag,
        recv_counts=send_counts.T + self_diag,
        dropped_send=dropped_send,
        dropped_recv=dropped_recv,
        # remote_counts[v, v] is 0 (self rows carry the sentinel)
        needed_capacity=remote_counts.max(dim=1).values.to(torch.int32),
    )


# the signed integer of each element width: the row-major engine moves
# every array as these words (PyTorch's gathers do not take every dtype,
# uint32 for one), so no value is touched on the way
_WORD = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def vrank_redistribute_fn(domain: Domain, grid: ProcessGrid, capacity: int,
                          out_capacity: int, edges=None):
    """Row-major canonical exchange of R virtual ranks on one device.

    Returns ``fn(pos [V, n, D], count [V], *fields [V, n, ...]) ->
    (pos_out [V, out_capacity, D], count_out [V], *fields_out, stats)``:
    the same routing, stable pack, Alltoallv receive order and
    capacity/overflow accounting as the reference's engine, for fields of
    any dtype (the planar engine takes 32-bit ones only), each carried as
    integer words of its width. Batched over V; the wire is the
    ``[V_src, V_dst, C, ...]`` transpose."""
    V = grid.nranks

    def fn(pos, count, *fields):
        dest = binning.rank_of_position(pos, domain, grid, edges=edges)
        is_self, order, remote_counts, _, send_counts, dropped_send = _route(
            dest, count, V, capacity)
        arrays = (pos,) + tuple(fields)
        words = tuple(a.view(_WORD[a.element_size()]) for a in arrays)
        packed = pack.pack_by_destination(dest, remote_counts, words,
                                          capacity, order=order)
        recv = tuple(a.transpose(0, 1) for a in packed)
        me = torch.arange(V, dtype=torch.int32, device=pos.device)
        out, new_count, dropped_recv = pack.compact_with_self(
            recv, send_counts.T, words, is_self, me, out_capacity
        )
        out = tuple(o.view(a.dtype) for o, a in zip(out, arrays))
        stats = _stats(send_counts, is_self, remote_counts, dropped_send,
                       dropped_recv)
        return (out[0], new_count) + tuple(out[1:]) + (stats,)

    return fn


def vrank_redistribute_planar_fn(domain: Domain, grid: ProcessGrid,
                                 capacity: int, out_capacity: int,
                                 ndim: int = None, edges=None):
    """Planar canonical exchange of R virtual ranks on one device.

    Returns ``fn(fused [V, K, n], count [V]) -> (fused_out [V, K,
    out_capacity], count_out [V], stats)``: K planar rows, the ``D``
    position components first, then 32-bit fields, one row each; columns
    past ``count_out[v]`` are zero. ``fused`` may be float32 or int32, and
    the output matches it; the transport (pack gather, wire, compaction)
    runs on an int32 view, so every 32-bit pattern (denormals, NaN
    payloads, -0.0) arrives as it left. Same rows, order and accounting
    as :func:`vrank_redistribute_fn`; the wire is the ``[V_src, K, V_dst,
    C] -> [V_dst, K, V_src * C]`` transpose."""
    V = grid.nranks
    C = capacity
    D = domain.ndim if ndim is None else ndim

    def fn(fused, count):
        if fused.dim() != 3 or fused.shape[0] != V or fused.shape[1] < D:
            raise ValueError(
                f"fused must be [V={V}, K>={D}, n] (K rows: {D} position "
                f"components first, then 32-bit fields), got "
                f"{tuple(fused.shape)}"
            )
        if fused.dtype not in (torch.float32, torch.int32):
            raise TypeError(
                f"fused must be float32 or int32, got {fused.dtype}"
            )
        as_f32 = fused.dtype == torch.float32
        fi = fused.view(torch.int32) if as_f32 else fused
        pos_f = fi[:, :D, :].view(torch.float32)
        K = fused.shape[1]
        dest = binning.rank_of_position_planar(pos_f, domain, grid,
                                               edges=edges)
        is_self, order, remote_counts, bounds, send_counts, dropped_send = (
            _route(dest, count, V, C))
        packed, _ = pack.pack_cols(fi, order, bounds[:, :V], send_counts, V,
                                   C)  # [V_src, K, V_dst * C] int32
        recv = (packed.reshape(V, K, V, C).permute(2, 1, 0, 3)
                .reshape(V, K, V * C))
        me = torch.arange(V, dtype=torch.int32, device=fused.device)
        out, new_count, dropped_recv = pack.planar_compact_with_self(
            recv, send_counts.T, me, is_self, fi, out_capacity
        )
        if as_f32:
            out = out.view(torch.float32)
        stats = _stats(send_counts, is_self, remote_counts, dropped_send,
                       dropped_recv)
        return out, new_count, stats

    return fn


def build_redistribute_vranks(domain: Domain, grid: ProcessGrid,
                              capacity: int, out_capacity: int, edges=None):
    """:func:`vrank_redistribute_fn` (the reference jits and caches it;
    PyTorch runs eagerly, so this only builds the closure)."""
    return vrank_redistribute_fn(domain, grid, capacity, out_capacity, edges)


def build_redistribute_planar_vranks(domain: Domain, grid: ProcessGrid,
                                     capacity: int, out_capacity: int,
                                     ndim: int = None, edges=None):
    """:func:`vrank_redistribute_planar_fn`, as the reference's builder."""
    return vrank_redistribute_planar_fn(domain, grid, capacity, out_capacity,
                                        ndim, edges=edges)


# ---------------------------------------------------------------------------
# Count-driven engines on one device (vrank twins)
# ---------------------------------------------------------------------------

def _check_mover_cap(mover_cap, capacity):
    B = int(mover_cap)
    if not 1 <= B < int(capacity):
        raise ValueError(
            f"mover_cap must be in [1, capacity); got mover_cap={B}, "
            f"capacity={capacity} — at mover_cap >= capacity the "
            f"count-driven pool is no smaller than the dense one, build "
            f"the planar engine instead"
        )
    return B


def _planar_view(fused: torch.Tensor, D: int, lead: int):
    """Validate a planar state of ``lead + 2`` dims (``[..., K >= D, n]``,
    32-bit) and return ``(as_f32, int32 view, float32 position rows)``."""
    if fused.dim() != lead + 2 or fused.shape[-2] < D:
        want = "[V, K, n]" if lead else "[K, n] per rank"
        raise ValueError(
            f"fused must be {want} with K >= {D} (K rows: {D} position "
            f"components first, then 32-bit fields), got "
            f"{tuple(fused.shape)}"
        )
    if fused.dtype not in (torch.float32, torch.int32):
        raise TypeError(
            f"fused must be float32 or int32, got {fused.dtype}"
        )
    as_f32 = fused.dtype == torch.float32
    # viewed only when float32, a 4-byte dtype (gridlint G004)
    fi = fused.view(torch.int32) if as_f32 else fused  # gridlint: disable=G004
    return as_f32, fi, fi[..., :D, :].view(torch.float32)


def vrank_redistribute_sparse_fn(domain: Domain, grid: ProcessGrid,
                                 capacity: int, out_capacity: int,
                                 mover_cap: int, ndim: int = None,
                                 edges=None):
    """COUNT-DRIVEN canonical exchange of R virtual ranks on one device:
    the ``[V_src, K, V_dst, W]`` transpose shrinks from ``W = capacity``
    to ``W = mover_cap`` when every pair's movers fit the block, and runs
    at the dense width otherwise; the output is the same bits either way
    as :func:`vrank_redistribute_planar_fn`'s. ``stats.fallback`` is 1
    on every vrank when the dense width ran. The reference's branch is a
    ``lax.cond``; here its guard is read on the host (one sync a call).
    Signature as :func:`vrank_redistribute_planar_fn`."""
    V = grid.nranks
    C = capacity
    B = _check_mover_cap(mover_cap, capacity)
    D = domain.ndim if ndim is None else ndim

    def fn(fused, count):
        as_f32, fi, pos_f = _planar_view(fused, D, 1)
        K = fused.shape[1]
        dest = binning.rank_of_position_planar(pos_f, domain, grid,
                                               edges=edges)
        is_self, order, remote_counts, bounds, send_counts, dropped_send = (
            _route(dest, count, V, C))
        fast = bool(remote_counts.max() <= B)
        W = B if fast else C
        packed, _ = pack.pack_cols(fi, order, bounds[:, :V],
                                   send_counts.clamp(max=W), V, W)
        pool = (packed.reshape(V, K, V, W).permute(2, 1, 0, 3)
                .reshape(V, K, V * W))
        me = torch.arange(V, dtype=torch.int32, device=fused.device)
        out, new_count, dropped_recv = pack.planar_compact_with_self(
            pool, send_counts.T, me, is_self, fi, out_capacity)
        if as_f32:
            out = out.view(torch.float32)
        stats = _stats(send_counts, is_self, remote_counts, dropped_send,
                       dropped_recv)._replace(
            fallback=torch.full((V,), int(not fast), dtype=torch.int32,
                                device=fused.device))
        return out, new_count, stats

    return fn


def _neighbor_schedule(grid: ProcessGrid, periodic):
    """``(active offsets, perms, dst [R, n_act], src [R, n_act], member [R,
    R])`` of the Moore-stencil schedule; raises on a grid with no
    neighbor link."""
    periodic = tuple(bool(p) for p in periodic)
    _, dst_t, src_t, member = mesh_lib.neighbor_tables(grid, periodic)
    perms_all = mesh_lib.neighbor_perms(grid, periodic)
    active = tuple(o for o in range(dst_t.shape[1]) if perms_all[o])
    if not active:
        raise ValueError(
            f"neighbor engine needs a grid with at least one neighbor "
            f"link, got shape {grid.shape}"
        )
    return (active, tuple(perms_all[o] for o in active),
            dst_t[:, active], src_t[:, active], member)


def _stencil_plan(send_counts, bounds, order, d_o, B: int, n: int):
    """Per offset, the first ``min(send_counts[d], B)`` sorted columns of
    the destination ``d_o`` (``-1``: none): ``(plan [*, n_act * B]
    resident columns, slot_valid)``."""
    n_act = d_o.shape[-1]
    dev = send_counts.device
    d_safe = d_o.clamp(min=0).long()
    cnt = torch.where(d_o >= 0, torch.gather(send_counts.clamp(max=B), -1,
                                             d_safe), 0)
    base = torch.gather(bounds, -1, d_safe)
    c_idx = torch.arange(B, dtype=torch.int32, device=dev)
    lead = tuple(d_o.shape[:-1])
    slot_valid = (c_idx < cnt[..., None]).reshape(lead + (n_act * B,))
    src_cols = (base[..., None] + c_idx).clamp(max=n - 1).reshape(
        lead + (n_act * B,))
    plan = torch.gather(order.long(), -1, src_cols.long())
    return plan, slot_valid


def _stencil_keys(recv_counts, s_o, B: int, is_self, me):
    """Receive keys of the stencil pool: block ``o`` came from ``s_o[o]``
    (``-1``: nobody); returns ``(invalid, source_key)`` over the pool and
    the kept columns, the source-major order of the dense pool."""
    dev = recv_counts.device
    s_safe = s_o.clamp(min=0)
    rc = torch.where(s_o >= 0, torch.gather(recv_counts, -1, s_safe.long()),
                     0)
    c_idx = torch.arange(B, dtype=torch.int32, device=dev)
    lead = tuple(s_o.shape[:-1])
    n_act = s_o.shape[-1]
    valid_r = (c_idx < rc[..., None]).reshape(lead + (n_act * B,))
    n = is_self.shape[-1]
    invalid = ~torch.cat([valid_r, is_self], dim=-1)
    source_key = torch.cat([
        s_safe[..., None].expand(lead + (n_act, B)).reshape(
            lead + (n_act * B,)),
        me[..., None].expand(lead + (n,)),
    ], dim=-1).to(torch.int32)
    return invalid, source_key


def vrank_redistribute_neighbor_fn(domain: Domain, grid: ProcessGrid,
                                   capacity: int, out_capacity: int,
                                   mover_cap: int, ndim: int = None,
                                   edges=None):
    """NEIGHBOR-STENCIL canonical exchange of R virtual ranks on one
    device: the sharded engine's per-offset shifts become static
    cross-vrank block gathers through the same
    :func:`~.mesh.neighbor_tables`. A step whose movers all fit the block
    and stay within the 3x3x3 stencil runs the stencil; any other runs
    the dense width (``stats.fallback`` 1). Same bits as
    :func:`vrank_redistribute_planar_fn`."""
    V = grid.nranks
    C = capacity
    B = _check_mover_cap(mover_cap, capacity)
    D = domain.ndim if ndim is None else ndim
    _, _, dst_act, src_act, member = _neighbor_schedule(grid,
                                                        domain.periodic)
    n_act = dst_act.shape[1]
    tables = _device.OnDevice(dst_act.astype(np.int32),
                              src_act.astype(np.int32), member)

    def fn(fused, count):
        as_f32, fi, pos_f = _planar_view(fused, D, 1)
        K, n = fused.shape[1], fused.shape[2]
        dev = fused.device
        d_t, s_t, mem = tables.get(dev)
        dest = binning.rank_of_position_planar(pos_f, domain, grid,
                                               edges=edges)
        is_self, order, remote_counts, bounds, send_counts, dropped_send = (
            _route(dest, count, V, C))
        me = torch.arange(V, dtype=torch.int32, device=dev)
        ok = torch.where(mem, remote_counts <= B, remote_counts == 0).all()
        stencil = bool(ok)
        if stencil:
            plan, slot_valid = _stencil_plan(send_counts, bounds, order,
                                             d_t, B, n)
            send = pack._take_cols(fi, plan)
            send = torch.where(slot_valid[:, None, :], send,
                               torch.zeros((), dtype=send.dtype, device=dev))
            blocks = send.reshape(V, K, n_act, B)
            # block o at vrank v came from src_act[v, o]
            o_idx = torch.arange(n_act, device=dev)[None, :]
            recv = blocks[s_t.clamp(min=0).long(), :, o_idx, :]
            pool = recv.permute(0, 2, 1, 3).reshape(V, K, n_act * B)
            invalid, source_key = _stencil_keys(send_counts.T, s_t, B,
                                                is_self, me)
            new_full = (send_counts.T.sum(dim=1, dtype=torch.int32)
                        + is_self.sum(dim=1, dtype=torch.int32))
            out, new_count, dropped_recv = pack.planar_compact_keys(
                torch.cat([pool, fi], dim=2), invalid, source_key, V,
                new_full, out_capacity)
        else:
            packed, _ = pack.pack_cols(fi, order, bounds[:, :V],
                                       send_counts, V, C)
            pool = (packed.reshape(V, K, V, C).permute(2, 1, 0, 3)
                    .reshape(V, K, V * C))
            out, new_count, dropped_recv = pack.planar_compact_with_self(
                pool, send_counts.T, me, is_self, fi, out_capacity)
        if as_f32:
            out = out.view(torch.float32)
        stats = _stats(send_counts, is_self, remote_counts, dropped_send,
                       dropped_recv)._replace(
            fallback=torch.full((V,), int(not stencil), dtype=torch.int32,
                                device=dev))
        return out, new_count, stats

    return fn


# ---------------------------------------------------------------------------
# Multi-rank engines: one rank a process, over torch.distributed
# ---------------------------------------------------------------------------


def _count1(count: torch.Tensor) -> torch.Tensor:
    """A rank's count (a scalar or ``[1]``) as an int32 ``[1]`` tensor."""
    return count.reshape(1).to(torch.int32)


def _shard_stats(send_counts, recv_counts, is_self, me: int,
                 remote_counts, dropped_send, dropped_recv, fallback=None):
    """A rank's stats rows, as the reference's per-shard function returns
    them: ``send_counts``/``recv_counts`` ``[1, R]``, the rest ``[1]``."""
    R = send_counts.shape[0]
    self_count = is_self.sum(dtype=torch.int32)
    onehot = (torch.arange(R, dtype=torch.int32, device=is_self.device)
              == me).to(torch.int32) * self_count
    return RedistributeStats(
        send_counts=(send_counts + onehot)[None],
        recv_counts=(recv_counts + onehot)[None],
        dropped_send=dropped_send.reshape(1).to(torch.int32),
        dropped_recv=dropped_recv.reshape(1).to(torch.int32),
        needed_capacity=remote_counts.max().reshape(1).to(torch.int32),
        fallback=None if fallback is None else fallback.reshape(1),
    )


def gather_stats(stats: RedistributeStats, mesh) -> RedistributeStats:
    """Every rank's stats rows stacked in rank order: the reference's
    global stats (``[R, R]`` tables, ``[R]`` counters), the same on every
    rank."""
    def g(t):
        if t is None:
            return None
        return col.all_gather(t, mesh).reshape((mesh.size,)
                                               + tuple(t.shape[1:]))

    return RedistributeStats(*(g(t) for t in stats))


def _shard_route(fused, count, domain, grid, D, edges, mesh, C):
    """Routing prefix of the planar-family multi-rank engines (validate,
    int32 view, bin, stable by-destination order, capacity ``C``):
    ``(as_f32, fi, me [1], is_self [n], order [n], remote_counts [R],
    bounds [R + 1], send_counts [R], dropped_send)``."""
    as_f32, fi, pos_f = _planar_view(fused, D, 0)
    me = torch.full((1,), mesh.rank, dtype=torch.int32, device=fused.device)
    dest = binning.rank_of_position_planar(pos_f, domain, grid, edges=edges)
    is_self, order, remote_counts, bounds, send_counts, dropped_send = (
        _route(dest[None], _count1(count), grid.nranks, C, me=me))
    return (as_f32, fi, me, is_self[0], order[0], remote_counts[0],
            bounds[0], send_counts[0], dropped_send[0])


def _dense_pool_wire(fi, order, bounds, send_counts, R, C, mesh):
    """The dense ``[K, R*C]`` pool: pack and one tiled all-to-all."""
    with traced_span("rd:dense_wire"):
        packed, _ = pack.pack_cols(fi, order, bounds[:R], send_counts, R, C)
        return col.all_to_all(packed, mesh, dim=1)


# gridlint: fastpath-engine
def _sparse_wire(fi, order, bounds, send_counts, R, B, mesh):
    """The count-driven wire: pack ``[K, R*B]`` mover blocks through the
    by-destination order and one tiled all-to-all. O(movers) work only:
    no sort, no gather at an ``arange`` index (the gridlint G006 region;
    the selection sort runs before, in the routing prefix)."""
    with traced_span("rd:sparse_wire"):
        packed, _ = pack.pack_cols(fi, order, bounds[:R], send_counts, R, B)
        return col.all_to_all(packed, mesh, dim=1)


# gridlint: fastpath-engine
def _neighbor_wire(fi, plan, slot_valid, mesh, perms, n_act, B, axes=None):
    """The neighbor-stencil wire: one plan-indexed gather of every
    outgoing mover column, then one ``ppermute`` of a ``[K, B]`` block an
    active stencil offset, instead of the dense all-to-all. O(movers)
    work only (the gridlint G006 region). ``axes``: the sub-axes of a
    lifted permutation (the hierarchical engine's intra-pod stencil)."""
    K = fi.shape[0]
    with traced_span("rd:neighbor_wire"):
        send = torch.where(slot_valid[None, :], pack._take_cols(fi, plan),
                           torch.zeros((), dtype=fi.dtype, device=fi.device))
        send = send.reshape(K, n_act, B)
        return torch.cat([
            col.ppermute(send[:, o, :].contiguous(), mesh, perms[o],
                         axes=axes)
            for o in range(n_act)
        ], dim=1)


def shard_redistribute_planar_fn(domain: Domain, grid: ProcessGrid,
                                 capacity: int, out_capacity: int,
                                 ndim: int = None, edges=None, mesh=None):
    """PLANAR multi-rank canonical exchange, one rank's part (the
    reference's ``shard_map`` body): ``fn(fused [K, n], count) ->
    (fused_out [K, out_capacity], count_out [1], stats)`` with this
    rank's stats rows (``[1, R]`` tables, ``[1]`` counters; see
    :func:`gather_stats`). The same routing, pack and compaction as
    :func:`vrank_redistribute_planar_fn`; the transpose is a tiled
    all-to-all over ``mesh`` (default: :func:`~.mesh.make_mesh` of
    ``grid``), which must be the same on every rank."""
    R = grid.nranks
    C = capacity
    D = domain.ndim if ndim is None else ndim
    mesh = mesh_lib.mesh_for(grid, mesh)

    def fn(fused, count):
        (as_f32, fi, me, is_self, order, remote_counts, bounds, send_counts,
         dropped_send) = _shard_route(fused, count, domain, grid, D, edges,
                                      mesh, C)
        recv_counts = col.all_to_all(send_counts, mesh)
        pool = _dense_pool_wire(fi, order, bounds, send_counts, R, C, mesh)
        out, new_count, dropped_recv = pack.planar_compact_with_self(
            pool, recv_counts, me[0], is_self, fi, out_capacity)
        if as_f32:
            out = out.view(torch.float32)
        stats = _shard_stats(send_counts, recv_counts, is_self, mesh.rank,
                             remote_counts, dropped_send, dropped_recv)
        return out, new_count.reshape(1), stats

    return fn


def shard_redistribute_fn(domain: Domain, grid: ProcessGrid, capacity: int,
                          out_capacity: int, edges=None, mesh=None):
    """Row-major multi-rank canonical exchange, one rank's part:
    ``fn(pos [n, D], count, *fields [n, ...]) -> (pos_out [out_capacity,
    D], count_out [1], *fields_out, stats)`` (this rank's stats rows).
    Fields of any dtype ride as integer words of their width, one tiled
    all-to-all each."""
    R = grid.nranks
    mesh = mesh_lib.mesh_for(grid, mesh)

    def fn(pos, count, *fields):
        me = torch.full((1,), mesh.rank, dtype=torch.int32, device=pos.device)
        dest = binning.rank_of_position(pos, domain, grid, edges=edges)[None]
        is_self, order, remote_counts, _, send_counts, dropped_send = _route(
            dest, _count1(count), R, capacity, me=me)
        arrays = (pos,) + tuple(fields)
        words = tuple(a.view(_WORD[a.element_size()]) for a in arrays)
        packed = pack.pack_by_destination(
            dest, remote_counts, tuple(w[None] for w in words), capacity,
            order=order)  # [1, R, C, ...]
        recv_counts = col.all_to_all(send_counts[0], mesh)
        recv = tuple(col.all_to_all(a[0], mesh) for a in packed)
        out, new_count, dropped_recv = pack.compact_with_self(
            tuple(r[None] for r in recv), recv_counts[None],
            tuple(w[None] for w in words), is_self, me, out_capacity)
        out = tuple(o[0].view(a.dtype) for o, a in zip(out, arrays))
        stats = _shard_stats(send_counts[0], recv_counts, is_self[0],
                             mesh.rank, remote_counts[0], dropped_send[0],
                             dropped_recv[0])
        return (out[0], new_count.reshape(1)) + tuple(out[1:]) + (stats,)

    return fn


def shard_redistribute_sparse_fn(domain: Domain, grid: ProcessGrid,
                                 capacity: int, out_capacity: int,
                                 mover_cap: int, ndim: int = None,
                                 edges=None, mesh=None):
    """COUNT-DRIVEN multi-rank canonical exchange, one rank's part: the
    pool on the wire is ``[K, R * mover_cap]`` when every rank's movers
    fit the block, the dense ``[K, R * capacity]`` pool otherwise. Each
    rank's fit is reduced with a MIN across ranks before anyone branches,
    so every rank takes the same branch around its collectives (the
    reference's ``pmin`` and ``lax.cond``; the agreed flag is read on the
    host, one sync a call). Same bits as
    :func:`shard_redistribute_planar_fn` either way; ``stats.fallback`` is
    1 where the dense pool ran."""
    R = grid.nranks
    C = capacity
    B = _check_mover_cap(mover_cap, capacity)
    D = domain.ndim if ndim is None else ndim
    mesh = mesh_lib.mesh_for(grid, mesh)

    def fn(fused, count):
        (as_f32, fi, me, is_self, order, remote_counts, bounds, send_counts,
         dropped_send) = _shard_route(fused, count, domain, grid, D, edges,
                                      mesh, C)
        recv_counts = col.all_to_all(send_counts, mesh)
        ok = (remote_counts.max() <= B).to(torch.int32).reshape(1)
        fast = bool(col.pmin(ok, mesh)[0] == 1)
        if fast:
            pool = _sparse_wire(fi, order, bounds, send_counts.clamp(max=B),
                                R, B, mesh)
        else:
            pool = _dense_pool_wire(fi, order, bounds,
                                    send_counts.clamp(max=C), R, C, mesh)
        out, new_count, dropped_recv = pack.planar_compact_with_self(
            pool, recv_counts, me[0], is_self, fi, out_capacity)
        if as_f32:
            out = out.view(torch.float32)
        stats = _shard_stats(
            send_counts, recv_counts, is_self, mesh.rank, remote_counts,
            dropped_send, dropped_recv,
            fallback=torch.full((1,), int(not fast), dtype=torch.int32,
                                device=fused.device))
        return out, new_count.reshape(1), stats

    return fn


def shard_redistribute_neighbor_fn(domain: Domain, grid: ProcessGrid,
                                   capacity: int, out_capacity: int,
                                   mover_cap: int, ndim: int = None,
                                   edges=None, mesh=None):
    """NEIGHBOR-STENCIL multi-rank canonical exchange, one rank's part:
    one ``ppermute`` of a ``[K, mover_cap]`` block per active Moore-stencil
    offset (:func:`~.mesh.neighbor_perms`) instead of the dense
    all-to-all, when every rank's movers fit the block and stay inside
    the stencil (agreed by a MIN across ranks, as in
    :func:`shard_redistribute_sparse_fn`); otherwise the dense pool. Same
    bits as :func:`shard_redistribute_planar_fn`."""
    R = grid.nranks
    C = capacity
    B = _check_mover_cap(mover_cap, capacity)
    D = domain.ndim if ndim is None else ndim
    mesh = mesh_lib.mesh_for(grid, mesh)
    _, perms, dst_act, src_act, member = _neighbor_schedule(grid,
                                                            domain.periodic)
    n_act = dst_act.shape[1]
    me_np = mesh.rank
    tables = _device.OnDevice(dst_act[me_np].astype(np.int32),
                              src_act[me_np].astype(np.int32),
                              member[me_np])

    def fn(fused, count):
        (as_f32, fi, me, is_self, order, remote_counts, bounds, send_counts,
         dropped_send) = _shard_route(fused, count, domain, grid, D, edges,
                                      mesh, C)
        K, n = fi.shape
        dev = fused.device
        d_o, s_o, member_row = tables.get(dev)
        recv_counts = col.all_to_all(send_counts, mesh)
        ok = torch.where(member_row, remote_counts <= B,
                         remote_counts == 0).all().to(torch.int32).reshape(1)
        stencil = bool(col.pmin(ok, mesh)[0] == 1)
        if stencil:
            plan, slot_valid = _stencil_plan(send_counts, bounds, order, d_o,
                                             B, n)
            pool = _neighbor_wire(fi, plan, slot_valid, mesh, perms, n_act,
                                  B)
            invalid, source_key = _stencil_keys(recv_counts, s_o, B, is_self,
                                                me[0])
            new_full = (recv_counts.sum(dtype=torch.int32)
                        + is_self.sum(dtype=torch.int32))
            out, new_count, dropped_recv = pack.planar_compact_keys(
                torch.cat([pool, fi], dim=1), invalid, source_key, R,
                new_full, out_capacity)
        else:
            pool = _dense_pool_wire(fi, order, bounds, send_counts, R, C,
                                    mesh)
            out, new_count, dropped_recv = pack.planar_compact_with_self(
                pool, recv_counts, me[0], is_self, fi, out_capacity)
        if as_f32:
            out = out.view(torch.float32)
        stats = _shard_stats(
            send_counts, recv_counts, is_self, mesh.rank, remote_counts,
            dropped_send, dropped_recv,
            fallback=torch.full((1,), int(not stencil), dtype=torch.int32,
                                device=dev))
        return out, new_count.reshape(1), stats

    return fn


def _with_global_stats(fn, mesh):
    def call(*args):
        out = fn(*args)
        return out[:-1] + (gather_stats(out[-1], mesh),)

    return call


def shard_redistribute_planar_sharded(mesh, domain: Domain,
                                      grid: ProcessGrid, capacity: int,
                                      out_capacity: int, ndim: int = None,
                                      edges=None):
    """The reference's global planar exchange, as each rank sees it. Its
    global ``[K, R * n]`` state is lane-sharded with rank ``r`` owning
    columns ``[r * n, (r + 1) * n)``; run as one process a rank, that
    shard IS what rank ``r`` holds, so this is
    :func:`shard_redistribute_planar_fn` itself, with the stats gathered
    to the global ``[R, R]``/``[R]`` tables (:func:`gather_stats`):
    ``fn(fused [K, n], count) -> (fused_out [K, out_capacity], count_out
    [1], stats)``."""
    mesh = mesh_lib.mesh_for(grid, mesh)
    return _with_global_stats(shard_redistribute_planar_fn(
        domain, grid, capacity, out_capacity, ndim, edges=edges, mesh=mesh),
        mesh)


_COUNT_DRIVEN_SHARD_FNS = {
    "sparse": shard_redistribute_sparse_fn,
    "neighbor": shard_redistribute_neighbor_fn,
}
_COUNT_DRIVEN_VRANK_FNS = {
    "sparse": vrank_redistribute_sparse_fn,
    "neighbor": vrank_redistribute_neighbor_fn,
}
COUNT_DRIVEN_ENGINES = tuple(_COUNT_DRIVEN_SHARD_FNS)


def shard_redistribute_count_driven_sharded(mesh, domain: Domain,
                                            grid: ProcessGrid, capacity: int,
                                            out_capacity: int, mover_cap: int,
                                            ndim: int = None, edges=None,
                                            engine: str = "sparse"):
    """The count-driven exchange (``engine`` ``"sparse"`` or
    ``"neighbor"``) as each rank sees the reference's global one: the
    per-rank function with global stats, as
    :func:`shard_redistribute_planar_sharded`; the stats carry
    ``fallback``."""
    mesh = mesh_lib.mesh_for(grid, mesh)
    return _with_global_stats(_COUNT_DRIVEN_SHARD_FNS[engine](
        domain, grid, capacity, out_capacity, mover_cap, ndim, edges=edges,
        mesh=mesh), mesh)


def build_redistribute_count_driven_vranks(domain: Domain, grid: ProcessGrid,
                                           capacity: int, out_capacity: int,
                                           mover_cap: int, ndim: int = None,
                                           edges=None,
                                           engine: str = "sparse"):
    """The count-driven vrank twins ([V, K, n] planar)."""
    return _COUNT_DRIVEN_VRANK_FNS[engine](
        domain, grid, capacity, out_capacity, mover_cap, ndim, edges=edges)


def build_redistribute(mesh, domain: Domain, grid: ProcessGrid,
                       capacity: int, out_capacity: int, n_fields: int = None,
                       edges=None):
    """The reference's global row-major exchange as each rank sees it:
    :func:`shard_redistribute_fn` with global stats. ``n_fields`` is
    accepted for the reference's signature (a rank takes any number)."""
    mesh = mesh_lib.mesh_for(grid, mesh)
    return _with_global_stats(shard_redistribute_fn(
        domain, grid, capacity, out_capacity, edges, mesh=mesh), mesh)


# ---------------------------------------------------------------------------
# The hierarchical two-level engine (pods of ranks: ICI inside, DCN across)
# ---------------------------------------------------------------------------


def _check_cross_cap(cross_cap):
    B2 = int(cross_cap)
    if B2 < 1:
        raise ValueError(
            f"cross_cap must be >= 1, got {B2} — it is the per-(pod,pod) "
            f"condensed DCN block width of the hierarchical engine"
        )
    return B2


def _check_hier(hier, grid: ProcessGrid):
    if hier.grid != grid:
        raise ValueError(
            f"hierarchical mesh wraps grid {hier.grid.shape}, engine "
            f"built for {grid.shape}"
        )
    if hier.n_pods < 2:
        raise ValueError(
            "hierarchical engine needs a multi-pod mesh (n_pods >= 2); "
            "resolve_engine degrades flat meshes to the sparse engine"
        )


def _int_matvec(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``x @ m`` over the last axis of ``x`` for small integer tables (CUDA
    has no integer matmul): exact in int64, returned as int32."""
    return (x.long().unsqueeze(-1) * m.long()).sum(dim=-2).to(torch.int32)


class _HierTables(NamedTuple):
    """The static tables of the two-level schedule, as NumPy arrays:
    the pod-local Moore stencil (active offsets, their perms, ``dst``/
    ``src`` ``[L, n_act]`` local ids, ``member [L, L]``), the segment
    prefix matrix ``M [R, R]`` (``d' < d`` and the same pod) and the pod
    one-hot ``[R, n_pods]``."""

    n_act: int
    perms: tuple
    dst: np.ndarray
    src: np.ndarray
    member: np.ndarray
    prefix_m: np.ndarray
    pod_onehot: np.ndarray


def _hier_tables(hier, periodic) -> _HierTables:
    periodic_local = hier.local_periodic(tuple(periodic))
    _, dst_t, src_t, member = mesh_lib.neighbor_tables(hier.local_grid,
                                                       periodic_local)
    perms_all = mesh_lib.neighbor_perms(hier.local_grid, periodic_local)
    active = tuple(o for o in range(dst_t.shape[1]) if perms_all[o])
    R = hier.grid.nranks
    same = hier.pod_of[:, None] == hier.pod_of[None, :]
    prefix_m = ((np.arange(R)[:, None] < np.arange(R)[None, :])
                & same).astype(np.int32)
    onehot = (hier.pod_of[:, None]
              == np.arange(hier.n_pods)[None, :]).astype(np.int32)
    L = hier.pod_size
    return _HierTables(
        len(active), tuple(perms_all[o] for o in active),
        dst_t[:, active].reshape(L, len(active)).astype(np.int32),
        src_t[:, active].reshape(L, len(active)).astype(np.int32),
        member, prefix_m, onehot)


def _cross_effective(sc, cross, prefix_m, onehot, B2: int):
    """The cross clip: each rank's cross rows condensed per destination
    pod into one ``B2``-column block, destination-ascending segments at
    the prefix-summed offsets; what does not fit is clipped. Returns
    ``(prefix, eff, needed_cross)``: the segment offsets and sends ``[...,
    R]``, and the per-rank peak over destination pods of the unclipped
    cross total."""
    sc_cross = torch.where(cross, sc, torch.zeros_like(sc))
    prefix = _int_matvec(sc_cross, prefix_m)
    eff = torch.where(cross, torch.minimum((B2 - prefix).clamp(min=0), sc),
                      sc).to(torch.int32)
    needed_cross = _int_matvec(sc_cross, onehot).max(dim=-1).values
    return prefix, eff, needed_cross


def _condense_block(fi, order, bounds, prefix, eff, to_q, B2: int, n: int):
    """One rank's condensed block for one destination pod (``to_q [..., R]``
    marks its ranks): slot ``j`` holds the row of the destination whose
    segment ``[prefix, prefix + eff)`` covers ``j``, zero past them.
    Batched over the leading dims of ``fi [..., K, n]``."""
    dev = fi.device
    j = torch.arange(B2, dtype=torch.int32, device=dev)[:, None]
    hit = (to_q.unsqueeze(-2) & (j >= prefix.unsqueeze(-2))
           & (j < (prefix + eff).unsqueeze(-2)))           # [..., B2, R]
    R = prefix.shape[-1]
    src_col = torch.where(
        hit, bounds[..., :R].unsqueeze(-2) + j - prefix.unsqueeze(-2),
        torch.zeros((), dtype=torch.int32, device=dev)).sum(
            dim=-1, dtype=torch.int32)
    slot_valid = hit.any(dim=-1)
    plan = torch.gather(order.long(), -1, src_col.clamp(max=n - 1).long())
    blk = pack._take_cols(fi, plan)
    return torch.where(slot_valid.unsqueeze(-2), blk, pack._zero(blk))


def _blocks(L: int, W: int, device):
    """``(m [L * W], j [L * W])``: the block and the slot within it of
    each column of ``L`` blocks of ``W`` columns (computed on the device;
    ``repeat_interleave`` would read its size on the host)."""
    col_idx = torch.arange(L * W, dtype=torch.int64, device=device)
    return col_idx // W, (col_idx % W).to(torch.int32)


def _fan_out(mirror, cnt_loc, L: int, B2: int):
    """Cut an arrived block ``[..., K, B2]`` into its ``L`` per-local-
    destination segments (lengths ``cnt_loc [..., L]``, in order), each
    at the front of its own ``B2`` columns: ``[..., K, L * B2]``."""
    m_idx, jj = _blocks(L, B2, mirror.device)
    start = torch.cumsum(cnt_loc, dim=-1, dtype=torch.int32) - cnt_loc
    fan_valid = jj < cnt_loc[..., m_idx]
    fan_col = (start[..., m_idx] + jj).clamp(max=B2 - 1)
    fan = pack._take_cols(mirror, fan_col.long())
    return torch.where(fan_valid.unsqueeze(-2), fan, pack._zero(fan))


def _pod_gather(blocks, rows, slot, L: int, W: int):
    """The intra-pod all-to-all of the vrank twin as one gather: vrank
    ``v`` receives, from each rank ``rows[v, s]`` of its pod, that rank's
    block ``slot[v]`` of ``W`` columns: ``blocks [V, K, L * W] -> [V, K,
    L * W]`` (source-major, the tiled all-to-all's order)."""
    V, K = blocks.shape[0], blocks.shape[1]
    b4 = blocks.reshape(V, K, L, W)
    out = b4[rows, :, slot[:, None], :]                  # [V, L, K, W]
    return out.permute(0, 2, 1, 3).reshape(V, K, L * W)


def vrank_redistribute_hierarchical_fn(domain: Domain, grid: ProcessGrid,
                                       hier, capacity: int,
                                       out_capacity: int, mover_cap: int,
                                       cross_cap: int, ndim: int = None,
                                       edges=None):
    """HIERARCHICAL two-level canonical exchange of R virtual ranks on one
    device, over the pods of ``hier`` (a
    :class:`~.mesh.HierarchicalMesh`): rows that stay inside their pod
    take the pod-local Moore stencil (``mover_cap`` columns an offset;
    the dense intra-pod pool when any same-pod mover does not fit, a
    flag over all vranks read on the host), rows that cross pods are
    condensed into one ``cross_cap``-column block per destination pod,
    moved one pod distance at a time and fanned out to their ranks
    inside the pod. Cross rows past ``cross_cap`` are clipped and
    counted (``dropped_send``, ``stats.needed_cross``), never densified.
    The hops of the wire are static gathers through the tables the
    multi-rank engine ships. Same bits as
    :func:`vrank_redistribute_planar_fn` on every step that clips
    nothing. Signature as :func:`vrank_redistribute_planar_fn`."""
    V = grid.nranks
    C = capacity
    B = _check_mover_cap(mover_cap, capacity)
    B2 = _check_cross_cap(cross_cap)
    D = domain.ndim if ndim is None else ndim
    _check_hier(hier, grid)
    n_pods, L = hier.n_pods, hier.pod_size
    t = _hier_tables(hier, domain.periodic)
    n_act = t.n_act
    pod_of, local_of, rank_table = hier.pod_of, hier.local_of, hier.rank_table
    # the pod-local stencil lifted to global ranks, per vrank (-1: none)
    dst_loc, src_loc = t.dst[local_of], t.src[local_of]      # [V, n_act]
    lift = lambda loc: np.where(
        loc >= 0, rank_table[pod_of[:, None], np.where(loc >= 0, loc, 0)],
        -1).astype(np.int32)
    dst_glob, src_glob = lift(dst_loc), lift(src_loc)
    same = pod_of[:, None] == pod_of[None, :]
    member = same & t.member[local_of[:, None], local_of[None, :]]
    # per pod distance d: the destination-pod masks [V, V], the vrank
    # whose block arrives at each vrank (pod - d, same slot), the
    # destination pod's ranks and the source pod's ranks [V, L]; all
    # small: the per-column tables are made on the device from them
    deltas = range(1, n_pods)
    to_q = np.stack([pod_of[None, :] == ((pod_of + d) % n_pods)[:, None]
                     for d in deltas])
    mirror_src = np.stack([rank_table[(pod_of - d) % n_pods, local_of]
                           for d in deltas]).astype(np.int64)
    dst_pod_ranks = np.stack([rank_table[(pod_of + d) % n_pods]
                              for d in deltas]).astype(np.int64)
    src_pod_ranks = np.stack([rank_table[(pod_of - d) % n_pods]
                              for d in deltas]).astype(np.int64)
    tables = _device.OnDevice(
        dst_glob, src_glob, member, same, t.prefix_m, t.pod_onehot, to_q,
        mirror_src, dst_pod_ranks, src_pod_ranks,
        rank_table[pod_of].astype(np.int64), local_of.astype(np.int64))

    def fn(fused, count):
        as_f32, fi, pos_f = _planar_view(fused, D, 1)
        K, n = fused.shape[1], fused.shape[2]
        dev = fused.device
        (d_glob, s_glob, member_t, same_t, prefix_m, onehot, to_q_t,
         mirror_t, dpr_t, spr_t, pod_ranks, slot) = tables.get(dev)
        dest = binning.rank_of_position_planar(pos_f, domain, grid,
                                               edges=edges)
        is_self, order, remote_counts, bounds, sc, _ = _route(dest, count,
                                                              V, C)
        prefix, eff, needed_cross = _cross_effective(sc, ~same_t, prefix_m,
                                                     onehot, B2)
        dropped_send = (remote_counts - eff).sum(dim=1, dtype=torch.int32)
        recv_counts = eff.T
        m_idx, jj = _blocks(L, B2, dev)
        cross_pools, cross_keys, cross_valid = [], [], []
        for i in range(n_pods - 1):
            blk = _condense_block(fi, order, bounds, prefix, eff, to_q_t[i],
                                  B2, n)                     # [V, K, B2]
            # the DCN hop: vrank v's block came from (pod - delta, slot)
            mirror = blk[mirror_t[i]]
            cnt_loc = torch.gather(eff, 1, dpr_t[i])[mirror_t[i]]  # [V, L]
            fan = _fan_out(mirror, cnt_loc, L, B2)           # [V, K, L*B2]
            # the intra-pod fanout hop
            cross_pools.append(_pod_gather(fan, pod_ranks, slot, L, B2))
            keys = spr_t[i][:, m_idx]                        # [V, L*B2]
            cross_keys.append(keys.to(torch.int32))
            cross_valid.append(jj < torch.gather(recv_counts, 1, keys))
        stencil = bool(torch.where(same_t, torch.where(
            member_t, remote_counts <= B, remote_counts == 0),
            True).all())
        if stencil:
            if n_act:
                plan, slot_valid = _stencil_plan(sc, bounds, order, d_glob,
                                                 B, n)
                send = pack._take_cols(fi, plan)
                send = torch.where(slot_valid[:, None, :], send,
                                   pack._zero(send))
                blocks = send.reshape(V, K, n_act, B)
                o_idx = torch.arange(n_act, device=dev)[None, :]
                recv = blocks[s_glob.clamp(min=0).long(), :, o_idx, :]
                pool = recv.permute(0, 2, 1, 3).reshape(V, K, n_act * B)
            else:  # one-rank pods: nothing stays in a pod but its rank
                pool = fi.new_zeros((V, K, 0))
            invalid, srckeys = _stencil_keys(
                recv_counts, s_glob, B, is_self[:, :0],
                torch.zeros((V,), dtype=torch.int32, device=dev))
            valid_r = ~invalid
        else:
            m_all, cc = _blocks(L, C, dev)
            dloc = pod_ranks[:, m_all]                       # [V, L*C]
            cnt_all = torch.gather(torch.where(same_t, sc, 0), 1, dloc)
            src_cols = (torch.gather(bounds, 1, dloc) + cc).clamp(max=n - 1)
            plan = torch.gather(order.long(), 1, src_cols.long())
            packed = pack._take_cols(fi, plan)
            packed = torch.where((cc < cnt_all)[:, None, :], packed,
                                 pack._zero(packed))
            pool = _pod_gather(packed, pod_ranks, slot, L, C)
            valid_r = cc < torch.gather(recv_counts, 1, dloc)
            srckeys = dloc.to(torch.int32)
        me = torch.arange(V, dtype=torch.int32, device=dev)
        invalid = ~torch.cat([valid_r] + cross_valid + [is_self], dim=1)
        source_key = torch.cat(
            [srckeys] + cross_keys + [me[:, None].expand(V, n)],
            dim=1).to(torch.int32)
        new_full = (recv_counts.sum(dim=1, dtype=torch.int32)
                    + is_self.sum(dim=1, dtype=torch.int32))
        out, new_count, dropped_recv = pack.planar_compact_keys(
            torch.cat([pool] + cross_pools + [fi], dim=2), invalid,
            source_key, V, new_full, out_capacity)
        if as_f32:
            out = out.view(torch.float32)
        stats = _stats(eff, is_self, remote_counts, dropped_send,
                       dropped_recv)._replace(
            fallback=torch.full((V,), int(not stencil), dtype=torch.int32,
                                device=dev),
            needed_cross=needed_cross)
        return out, new_count, stats

    return fn


@functools.lru_cache(maxsize=64)
def build_redistribute_hierarchical_vranks(domain: Domain, grid: ProcessGrid,
                                           hier, capacity: int,
                                           out_capacity: int, mover_cap: int,
                                           cross_cap: int, ndim: int = None,
                                           edges=None):
    """:func:`vrank_redistribute_hierarchical_fn` under the reference's
    name, made once for each set of arguments."""
    return vrank_redistribute_hierarchical_fn(
        domain, grid, hier, capacity, out_capacity, mover_cap, cross_cap,
        ndim, edges=edges)


def _dense_intra_wire(fi, plan, slot_valid, mesh, group, axes):
    """The hierarchical engine's dense intra-pod pool: a ``[K, L * C]``
    per-local-destination pack and one all-to-all inside the pod only
    (no byte leaves the pod; ``axes`` the pod's ici axes)."""
    packed = torch.where(slot_valid[None, :], pack.gather_plan_cols(fi, plan),
                         torch.zeros((), dtype=fi.dtype, device=fi.device))
    return col.all_to_all(packed, mesh, dim=1, group=group, axes=axes)


def _hier_cross_stage(fi, order, bounds, prefix, eff, recv_counts, hier,
                      mesh, B2: int, n: int, pod_of_t, rank_table_t):
    """The staged cross-pod schedule of one rank. For each pod distance
    ``delta`` in ``1..n_pods-1``: condense every row bound for pod
    ``(pme + delta) % n_pods`` into one ``[K, B2]`` block
    (destination-ascending segments at the prefix-summed offsets); move
    every pod's block, and its per-local-destination segment lengths,
    ``delta`` pods forward with one ``ppermute`` between the ranks of the
    same pod-local slot (the only payload that leaves a pod); then fan
    the arrived block out to its final ranks with one all-to-all inside
    the pod. Returns per-delta lists ``(pools [K, L * B2], source-rank
    keys, valid)`` for the shared compaction."""
    L, n_pods = hier.pod_size, hier.n_pods
    me = mesh.rank
    pme = int(hier.pod_of[me])
    m_idx, jj = _blocks(L, B2, fi.device)
    ici = hier.ici_group(me)
    pools, keys, valids = [], [], []
    for delta in range(1, n_pods):
        q_dst = (pme + delta) % n_pods
        blk = _condense_block(fi, order, bounds, prefix, eff,
                              pod_of_t == q_dst, B2, n)      # [K, B2]
        eff_loc = eff[rank_table_t[q_dst]]                   # [L]
        perm = col.lift_perm([(p, (p + delta) % n_pods)
                              for p in range(n_pods)], hier.dcn_groups())
        mirror = col.ppermute(blk, mesh, perm, axes=hier.dcn_axes)
        cnt_loc = col.ppermute(eff_loc, mesh, perm, axes=hier.dcn_axes)
        fan = _fan_out(mirror, cnt_loc, L, B2)               # [K, L*B2]
        pools.append(col.all_to_all(fan, mesh, dim=1, group=ici,
                                    axes=hier.ici_axes))
        # chunk s, slot j arrived from (pod pme - delta, local s)
        src_ranks = rank_table_t[(pme - delta) % n_pods][m_idx]
        keys.append(src_ranks.to(torch.int32))
        valids.append(jj < recv_counts[src_ranks])
    return pools, keys, valids


def shard_redistribute_hierarchical_fn(domain: Domain, grid: ProcessGrid,
                                       hier, capacity: int,
                                       out_capacity: int, mover_cap: int,
                                       cross_cap: int, ndim: int = None,
                                       edges=None, mesh=None):
    """HIERARCHICAL two-level multi-rank canonical exchange, one rank's
    part, over the pods of ``hier`` (a :class:`~.mesh.HierarchicalMesh`
    of ``grid``; ``mesh`` is the flat :class:`~.mesh.RankMesh`, whose
    rank order the pods keep):

      * intra-pod rows take the pod-local Moore stencil, one
        ``ppermute`` of a ``[K, mover_cap]`` block an active offset
        between ranks of one pod; when any same-pod mover of any rank
        does not fit (a MIN across ranks, read on the host), the dense
        intra-pod pool instead, one all-to-all inside each pod;
      * cross-pod rows take :func:`_hier_cross_stage` (``cross_cap``
        columns a destination pod; the excess is clipped and counted in
        ``dropped_send`` and ``stats.needed_cross``, never densified).

    Both feed the compaction with per-source keys, so the output is the
    bits of :func:`shard_redistribute_planar_fn` on every step that clips
    nothing. ``fn(fused [K, n], count) -> (fused_out [K, out_capacity],
    count_out [1], stats)`` with this rank's stats rows, ``fallback``
    (the intra stage) and ``needed_cross`` among them."""
    R = grid.nranks
    C = capacity
    B = _check_mover_cap(mover_cap, capacity)
    B2 = _check_cross_cap(cross_cap)
    D = domain.ndim if ndim is None else ndim
    _check_hier(hier, grid)
    mesh = mesh_lib.mesh_for(grid, mesh)
    L = hier.pod_size
    t = _hier_tables(hier, domain.periodic)
    me = mesh.rank
    pme, lme = int(hier.pod_of[me]), int(hier.local_of[me])
    ici_groups = hier.ici_groups()
    perms = tuple(col.lift_perm(p, ici_groups) for p in t.perms)
    # this rank's stencil rows, lifted to global ranks (-1: none)
    d_o, s_o = t.dst[lme], t.src[lme]
    glob = lambda loc: np.where(loc >= 0, hier.rank_table[pme, np.where(
        loc >= 0, loc, 0)], -1).astype(np.int32)
    same = hier.pod_of == pme
    member_row = t.member[lme][hier.local_of] & same
    tables = _device.OnDevice(
        glob(d_o), glob(s_o), member_row, same, t.prefix_m, t.pod_onehot,
        hier.pod_of.astype(np.int64), hier.rank_table.astype(np.int64))

    def fn(fused, count):
        (as_f32, fi, me_t, is_self, order, remote_counts, bounds, sc,
         _) = _shard_route(fused, count, domain, grid, D, edges, mesh, C)
        K, n = fi.shape
        dev = fused.device
        (d_glob, s_glob, member_t, same_t, prefix_m, onehot, pod_of_t,
         rank_table_t) = tables.get(dev)
        prefix, eff, needed_cross = _cross_effective(sc, ~same_t, prefix_m,
                                                     onehot, B2)
        dropped_send = (remote_counts - eff).sum(dtype=torch.int32)
        recv_counts = col.all_to_all(eff, mesh)
        cross_pools, cross_keys, cross_valid = _hier_cross_stage(
            fi, order, bounds, prefix, eff, recv_counts, hier, mesh, B2, n,
            pod_of_t, rank_table_t)
        ok = torch.where(same_t, torch.where(
            member_t, remote_counts <= B, remote_counts == 0),
            True).all().to(torch.int32).reshape(1)
        stencil = bool(col.pmin(ok, mesh)[0] == 1)
        if stencil:
            if t.n_act:
                plan, slot_valid = _stencil_plan(sc, bounds, order, d_glob,
                                                 B, n)
                pool = _neighbor_wire(fi, plan, slot_valid, mesh, perms,
                                      t.n_act, B, axes=hier.ici_axes)
            else:  # one-rank pods: nothing stays in a pod but its rank
                pool = fi.new_zeros((K, 0))
            invalid, srckeys = _stencil_keys(recv_counts, s_glob, B,
                                             is_self[:0], me_t[0])
            valid_r = ~invalid
        else:
            m_all, cc = _blocks(L, C, dev)
            d_all_t = rank_table_t[pme][m_all]               # [L * C]
            cnt_all = torch.where(same_t, sc, 0)[d_all_t]
            src_cols = (bounds[d_all_t] + cc).clamp(max=n - 1)
            pool = _dense_intra_wire(fi, order[src_cols.long()].long(),
                                     cc < cnt_all, mesh,
                                     hier.ici_group(me), hier.ici_axes)
            valid_r = cc < recv_counts[d_all_t]
            srckeys = d_all_t.to(torch.int32)
        invalid = ~torch.cat([valid_r] + cross_valid + [is_self])
        source_key = torch.cat(
            [srckeys] + cross_keys + [me_t.expand(n)]).to(torch.int32)
        new_full = (recv_counts.sum(dtype=torch.int32)
                    + is_self.sum(dtype=torch.int32))
        out, new_count, dropped_recv = pack.planar_compact_keys(
            torch.cat([pool] + cross_pools + [fi], dim=1), invalid,
            source_key, R, new_full, out_capacity)
        if as_f32:
            out = out.view(torch.float32)
        stats = _shard_stats(
            eff, recv_counts, is_self, me, remote_counts, dropped_send,
            dropped_recv,
            fallback=torch.full((1,), int(not stencil), dtype=torch.int32,
                                device=dev))._replace(
            needed_cross=needed_cross.reshape(1))
        return out, new_count.reshape(1), stats

    return fn


def shard_redistribute_hierarchical_sharded(mesh, domain: Domain,
                                            grid: ProcessGrid, hier,
                                            capacity: int, out_capacity: int,
                                            mover_cap: int, cross_cap: int,
                                            ndim: int = None, edges=None):
    """The reference's global hierarchical exchange as each rank sees it
    (its expanded mesh keeps the grid's rank order, so the layout is
    :func:`shard_redistribute_planar_sharded`'s): the per-rank function
    with the stats gathered, ``fallback`` and ``needed_cross`` among
    them."""
    mesh = mesh_lib.mesh_for(grid, mesh)
    return _with_global_stats(shard_redistribute_hierarchical_fn(
        domain, grid, hier, capacity, out_capacity, mover_cap, cross_cap,
        ndim, edges=edges, mesh=mesh), mesh)


@functools.lru_cache(maxsize=64)
def build_redistribute_hierarchical(mesh, domain: Domain, grid: ProcessGrid,
                                    hier, capacity: int, out_capacity: int,
                                    mover_cap: int, cross_cap: int,
                                    ndim: int = None, edges=None):
    """:func:`shard_redistribute_hierarchical_sharded`, built once for
    each set of arguments (the reference caches its jit the same way),
    so a caller that runs it every step uploads its tables once."""
    return shard_redistribute_hierarchical_sharded(
        mesh, domain, grid, hier, capacity, out_capacity, mover_cap,
        cross_cap, ndim, edges=edges)


# ---------------------------------------------------------------------------
# The two-phase (issue / finish) exchange: the pipelined service chunk's
# dispatch point
# ---------------------------------------------------------------------------


class TwoPhaseExchange(NamedTuple):
    """The resolution of the two-phase exchange: ``armed`` is the
    build-time verdict (the pipelined schedule is feasible, and
    ``bundle`` is the engine: a :class:`~.migrate.VrankTwoPhase` on one
    device, or anything with ``issue``/``complete``, such as the split
    :func:`~.migrate.shard_migrate_fused_fn`); when it is False
    ``bundle`` is None, the caller builds the sequential body, and
    ``reason`` says why. Journaled as ``engine_resolved``, like
    :func:`resolve_engine`'s decisions."""

    engine: str
    armed: bool
    reason: str
    bundle: object = None


def resolve_two_phase(
    engine: str,
    *,
    chunk: int,
    planar_ok: bool = True,
    ragged: bool = False,
    vranks: bool = False,
    n_devices: int = 1,
    n_pods: int = 1,
    build=None,
    recorder=None,
) -> TwoPhaseExchange:
    """Whether the software-pipelined two-phase schedule may arm, by the
    reference's rule: at least two steps a chunk (an exchange in flight
    across a step boundary), a planar-eligible payload (``planar_ok``),
    a rectangular receive side (``not ragged``: ``out_capacity ==
    n_local``), one device (vranks, or ``n_devices == 1``) and one pod.
    Any miss degrades to the sequential body when the chunk is built;
    steps whose flow control withholds movers are the chunk's own
    business (``stats.pipeline``).

    ``build`` is a zero-argument callable making the engine, called only
    when armed; ``recorder`` journals ``engine_resolved`` with
    ``requested=engine``, ``resolved`` ``"pipeline"`` or
    ``"sequential"`` and one of six ``"pipeline: ..."`` reasons."""
    if engine not in ENGINES:
        raise ValueError(
            f"engine must be one of {ENGINES}, got {engine!r}"
        )
    if chunk < 2:
        armed, reason = False, "pipeline: chunk < 2 — sequential body"
    elif not planar_ok:
        armed, reason = (
            False,
            "pipeline: payload not planar-eligible — sequential body")
    elif ragged:
        armed, reason = (
            False,
            "pipeline: ragged receive capacity — sequential body")
    elif not (vranks or n_devices == 1):
        armed, reason = (
            False,
            "pipeline: multi-device topology — sequential body")
    elif n_pods > 1:
        armed, reason = (
            False,
            "pipeline: hierarchical multi-pod topology — sequential "
            "body")
    else:
        armed, reason = True, "pipeline: armed (vranks planar two-phase)"
    if recorder is not None:
        recorder.record("engine_resolved", requested=engine,
                        resolved="pipeline" if armed else "sequential",
                        reason=reason, canonical=False)
    bundle = build() if (armed and build is not None) else None
    return TwoPhaseExchange(engine, armed, reason, bundle)


def _two_phase_impl(handle):
    impl = handle.bundle if isinstance(handle, TwoPhaseExchange) else handle
    if impl is None:
        raise TypeError(
            "two-phase exchange is not armed (degraded resolution: "
            f"{getattr(handle, 'reason', 'no bundle')!r}) — build the "
            "sequential body instead"
        )
    return impl


def start_exchange(handle, *args):
    """Phase 1: issue the routing plan (and put the payload in flight),
    through a :class:`TwoPhaseExchange` or any engine with ``issue``.
    It reads nothing the landing writes, so a pipelined caller may issue
    step k+1 before step k lands."""
    return _two_phase_impl(handle).issue(*args)


def finish_exchange(handle, *args):
    """Phase 2: land an issued exchange, through the engine's
    ``complete`` (the flat migrate engine) or ``land`` (the vrank
    two-phase engine)."""
    impl = _two_phase_impl(handle)
    finish = getattr(impl, "complete", None)
    if finish is None:
        finish = impl.land
    return finish(*args)
