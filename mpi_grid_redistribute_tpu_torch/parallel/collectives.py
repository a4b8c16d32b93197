"""The collectives the multi-rank engines run, over a :class:`RankMesh`:
the counterparts of ``lax.all_to_all`` (tiled), ``lax.all_gather``,
``lax.psum``/``pmin``, ``lax.ppermute`` and ``lax.axis_index``.

Every one is built from the four operations both gloo and NCCL take:
``all_to_all_single`` (with split sizes), list-form ``all_gather``,
``all_reduce`` and ``broadcast``. ``ppermute`` is an ``all_to_all_single``
whose splits are zero to every rank but the partner. A float sum across
ranks (:func:`psum_ordered`) gathers and adds in rank order, so its bits do
not depend on the backend's reduction tree; integer sums and all traffic
are exact either way. A mesh without a process group (one rank, no
``torch.distributed``) makes every collective the identity; with a group,
every call goes through the backend, at world size 1 too. Each call is
a ``coll:<name>`` span (``telemetry.phases.span``: a profiler range while
a profiler records), so a trace shows the time a rank spends in its
collectives, and reports its payload (the caller's tensor, once a
call, under the reference's primitive name) to
``utils.costcount.count_collective`` with the mesh axes the call is
declared over: every axis of the mesh, or the ``axes`` a sub-axis caller
names (the reference's ``ici_axes``/``dcn_axes`` of a
:class:`~.mesh.HierarchicalMesh`).

Collectives over a SUBSET of the mesh axes (the reference's
``lax.all_to_all(x, ici_axes)``, ``lax.ppermute(x, dcn_axes, perm)``, which
run independently for each value of the other axes) are one world call
each, not a call on a subgroup: :func:`all_to_all` takes ``group``, the
caller's own group of mesh ranks in group order, and sends nothing to
any rank outside it (zero split sizes, as :func:`ppermute` does); a
sub-axis ``ppermute`` is the world permutation :func:`lift_perm` builds
from the per-group one. Every rank makes the same calls in the same
order, no process group is created, and gloo and NCCL take it alike.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mpi_grid_redistribute_tpu_torch.parallel.mesh import RankMesh
from mpi_grid_redistribute_tpu_torch.telemetry.phases import span
from mpi_grid_redistribute_tpu_torch.utils.costcount import count_collective


# dtypes every backend moves as they are; any other travels as its bytes
# (gloo refuses int16, for one), which moves the same bits
_WIRE_DTYPES = (torch.float32, torch.float64, torch.float16, torch.int8,
                torch.uint8, torch.int32, torch.int64)


def _wire(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x if x.dtype in _WIRE_DTYPES else x.view(torch.uint8)


def _local(mesh: RankMesh) -> bool:
    return mesh.backend is None


def _group_axes(mesh: RankMesh, ranks: Sequence[int]) -> Tuple[str, ...]:
    """The grid axes along which the ranks of a group differ (the axes of
    a sub-axis call whose caller names none)."""
    cells = [np.unravel_index(int(r), mesh.shape) for r in ranks]
    return tuple(name for a, name in enumerate(mesh.axis_names)
                 if len({c[a] for c in cells}) > 1)


def lift_perm(perm: Sequence[Tuple[int, int]], groups
              ) -> Tuple[Tuple[int, int], ...]:
    """A permutation over the members of a sub-axis group (``(src, dst)``
    positions within a group), run in every group at once, as the world
    permutation of mesh ranks :func:`ppermute` takes. ``groups`` lists
    each group's mesh ranks in group order."""
    return tuple((int(g[s]), int(g[d])) for g in groups for s, d in perm)


def axis_index(mesh: RankMesh) -> int:
    """This rank's row-major index over all the mesh axes."""
    return mesh.rank


def all_to_all(x: torch.Tensor, mesh: RankMesh, dim: int = 0,
               group: Sequence[int] = None,
               axes: Sequence[str] = None) -> torch.Tensor:
    """Tiled all-to-all along ``dim``: the ``G`` equal chunks of ``x``
    along ``dim`` go to the ranks of ``group`` in order (default: all
    ``R`` mesh ranks), and the result holds the chunks received,
    source-major, along the same ``dim`` (``lax.all_to_all(x, axes, dim,
    dim, tiled=True)``; with ``group`` the caller's group of a sub-axis
    all-to-all, ascending mesh ranks that hold the caller, the same list
    on every rank of it). ``axes`` names the sub-axes a ``group`` call
    is declared over (default: the axes its ranks differ along)."""
    ranks = range(mesh.size) if group is None else [int(g) for g in group]
    G = len(ranks)
    if x.shape[dim] % G:
        raise ValueError(
            f"all_to_all: dim {dim} of {tuple(x.shape)} is not divisible "
            f"by {G} ranks"
        )
    if group is not None and (mesh.rank not in ranks
                              or list(ranks) != sorted(set(ranks))):
        # the world call lays chunks out in mesh-rank order, so the
        # group's order must be it
        raise ValueError(
            f"all_to_all: group {ranks} must hold rank {mesh.rank} and be "
            f"ascending")
    if _local(mesh):
        return x.clone()
    if group is None:
        count_collective("all_to_all", x, mesh.axis_names)
    else:
        count_collective("all_to_all", x, tuple(
            _group_axes(mesh, ranks) if axes is None else axes), world=False)
    c = x.shape[dim] // G
    lead, tail = tuple(x.shape[:dim]), tuple(x.shape[dim + 1:])
    # [lead, G, c, tail] -> [G, lead, c, tail]: chunk g contiguous
    send = x.reshape(lead + (G, c) + tail).movedim(len(lead), 0).contiguous()
    wire = _wire(send)
    recv = torch.empty_like(wire)
    with span("coll:all_to_all"):
        if group is None:
            dist.all_to_all_single(recv, wire, group=mesh.group)
        else:
            # one world call: zero splits to every rank outside the group
            chunk = wire.numel() // G
            splits = [0] * mesh.size
            for r in ranks:
                splits[r] = chunk
            dist.all_to_all_single(
                recv.reshape(-1), wire.reshape(-1),
                output_split_sizes=splits, input_split_sizes=splits,
                group=mesh.group)
    recv = recv.view(x.dtype).reshape(send.shape)
    return recv.movedim(0, len(lead)).reshape(x.shape)


def all_gather(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """``[R, *x.shape]``: every rank's ``x`` stacked in rank order."""
    if _local(mesh):
        return x[None].clone()
    count_collective("all_gather", x, mesh.axis_names)
    wire = _wire(x.reshape((1,) + tuple(x.shape)))
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    with span("coll:all_gather"):
        dist.all_gather(parts, wire, group=mesh.group)
    return torch.cat(parts).view(x.dtype).reshape((mesh.size,)
                                                   + tuple(x.shape))


def _all_reduce(x: torch.Tensor, mesh: RankMesh, op, name: str
                ) -> torch.Tensor:
    out = x.clone()
    if not _local(mesh):
        count_collective(name, x, mesh.axis_names)
        with span("coll:all_reduce"):
            dist.all_reduce(out, op=op, group=mesh.group)
    return out


def psum(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """Sum over ranks of an INTEGER tensor (exact in any order)."""
    if x.is_floating_point():
        raise TypeError(
            "psum takes integer tensors; a float sum across ranks is "
            "psum_ordered (rank order, backend-independent bits)"
        )
    return _all_reduce(x, mesh, dist.ReduceOp.SUM, "psum")


def psum_ordered(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """Sum over ranks added in rank order, ``((x_0 + x_1) + x_2) + ...``,
    identical on every rank (the order XLA's CPU all-reduce uses on the
    reference's virtual-device mesh)."""
    parts = all_gather(x, mesh)
    out = parts[0].clone()
    for r in range(1, mesh.size):
        out = out + parts[r]
    return out


def pmin(x: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    return _all_reduce(x, mesh, dist.ReduceOp.MIN, "pmin")


def broadcast(x: torch.Tensor, mesh: RankMesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (``src`` is a mesh rank)."""
    out = x.clone().contiguous()
    if not _local(mesh):
        count_collective("broadcast", x, mesh.axis_names)
        with span("coll:broadcast"):
            dist.broadcast(out, src=_global_rank(mesh, src),
                           group=mesh.group)
    return out


def _global_rank(mesh: RankMesh, r: int) -> int:
    return r if mesh.group is None else dist.get_global_rank(mesh.group, r)


def ppermute(x: torch.Tensor, mesh: RankMesh,
             perm: Sequence[Tuple[int, int]],
             axes: Sequence[str] = None) -> torch.Tensor:
    """``lax.ppermute``: for each ``(src, dst)`` in ``perm`` (an injective
    map of mesh ranks), ``src``'s ``x`` arrives at ``dst``; a rank no pair
    targets gets zeros. One ``all_to_all_single`` whose splits are zero to
    every rank but the partner. ``axes`` names the sub-axes of a
    :func:`lift_perm` permutation (default: every mesh axis)."""
    me = mesh.rank
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if _local(mesh):
        return x.clone() if src else torch.zeros_like(x)
    if axes is None:
        count_collective("ppermute", x, mesh.axis_names)
    else:
        count_collective("ppermute", x, tuple(axes), world=False)
    wire = _wire(x.reshape(-1))
    numel = wire.numel()
    in_splits = [numel if r in dst else 0 for r in range(mesh.size)]
    out_splits = [numel if r in src else 0 for r in range(mesh.size)]
    recv = torch.empty((sum(out_splits),), dtype=wire.dtype, device=x.device)
    with span("coll:ppermute"):
        dist.all_to_all_single(
            recv, wire.repeat(len(dst)),
            output_split_sizes=out_splits, input_split_sizes=in_splits,
            group=mesh.group,
        )
    if not src:
        return torch.zeros_like(x)
    return recv.view(x.dtype).reshape(x.shape)
