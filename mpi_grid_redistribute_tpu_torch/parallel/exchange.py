"""The canonical redistribute on one device (port of the JAX package's
``parallel/exchange.py``): engine names and their resolution, the stats
record, and the two single-device vrank engines that ``"auto"`` picks
there, the planar ``[V, K, n]`` engine and the row-major one.

The pipeline per virtual rank: bin every row to its destination rank,
sort by destination (the rank's own rows stay local), pack the first
``capacity`` rows of each destination segment, exchange, and compact the
received pool plus the kept rows into MPI ``Alltoallv`` receive order.
The V ranks are the leading batch dimension of every tensor, and the
wire is the transpose an all-to-all would perform. The multi-device,
count-driven and hierarchical engines are not ported (``ROADMAP.md`` A5,
A9).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops import binning, pack

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
    and ``n_devices == 1``), ``"planar"`` otherwise; the canonical-only
    names raise ``ValueError``.

    ``recorder`` (the reference journals the decision) raises
    ``NotImplementedError``: the telemetry plane is not ported yet."""
    if engine not in ENGINES:
        raise ValueError(
            f"engine must be one of {ENGINES}, got {engine!r}"
        )
    if recorder is not None:
        raise NotImplementedError(
            "resolve_engine(recorder=...): engine journaling belongs to the "
            "telemetry plane, which is not ported yet (ROADMAP.md A11)"
        )
    if canonical:
        if engine in ("rowmajor", "planar", "neighbor", "sparse"):
            return engine
        if engine == "hierarchical":
            return "hierarchical" if n_pods > 1 else "sparse"
        if not planar_ok:
            return "rowmajor"
        if n_devices > 1 and n_pods > 1:
            return "hierarchical"
        if n_devices > 1:
            return "sparse"
        return "planar"
    if engine in ("rowmajor", "neighbor", "hierarchical"):
        raise ValueError(
            f"engine={engine!r} is a canonical-exchange engine; the "
            "migrate loop accepts 'auto', 'sparse' or 'planar'"
        )
    if engine in ("auto", "sparse") and vranks and n_devices == 1:
        return "sparse"
    return "planar"


class RedistributeStats(NamedTuple):
    """Per-call observability, as int32 tensors: ``send_counts [R, R]``
    indexed ``[source, dest]`` (self rows on the diagonal),
    ``recv_counts`` its transpose, the drop counters ``[R]``, and
    ``needed_capacity [R]``, each rank's largest unclipped remote
    per-destination count (the smallest ``capacity`` that would have sent
    everything). ``fallback``, ``pipeline`` and ``needed_cross`` belong to
    engines not ported yet and stay ``None``."""

    send_counts: torch.Tensor
    recv_counts: torch.Tensor
    dropped_send: torch.Tensor
    dropped_recv: torch.Tensor
    needed_capacity: torch.Tensor
    fallback: torch.Tensor = None
    pipeline: torch.Tensor = None
    needed_cross: torch.Tensor = None


def _route(dest: torch.Tensor, count: torch.Tensor, V: int, capacity: int):
    """The shared routing prefix of both engines: ``dest [V, n]`` ranks ->
    ``(is_self, order, remote_counts, bounds, send_counts,
    dropped_send)``. Rows past ``count`` and the rank's own rows take the
    sentinel ``V`` and are not sent."""
    n = dest.shape[1]
    dev = dest.device
    valid = torch.arange(n, dtype=torch.int32, device=dev) < count[:, None]
    me = torch.arange(V, dtype=torch.int32, device=dev)[:, None]
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
