"""The rank mesh over ``torch.distributed`` (port of the JAX package's
``parallel/mesh.py``).

The reference lays its devices out as a ``jax.sharding.Mesh`` shaped like
the process grid, so grid rank ``r`` is device ``r`` and a collective over
the flattened mesh axes runs in row-major rank order. Here every rank is a
process: :func:`make_mesh` reads the caller's rank in a process group and
returns a :class:`RankMesh`, whose ``rank`` is the grid rank (row-major over
``grid.shape``, the order of ``lax.axis_index(axis_names)``) and whose
``coords`` are its cell. The pure NumPy helpers (shape factoring, shrink
ladder, Moore-stencil tables) are copied as they are.

The two-level view (:class:`HierarchicalMesh`, ``dcn_shape``) splits each
grid axis into pods; its tables say which pod and which pod-local slot a
rank holds, and its sub-axis groups are lists of mesh ranks
(:meth:`HierarchicalMesh.ici_groups`, :meth:`HierarchicalMesh.dcn_groups`)
for the sub-axis collectives of :mod:`.collectives`. The ranks keep their
grid order: placing pods on nodes is the launcher's job.
"""

from __future__ import annotations

import datetime
import functools
import itertools
import math
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid


class RankMesh(NamedTuple):
    """This process's place in a grid of ranks: the process ``group``
    (``None`` is the default group, or no group at all for a one-rank
    mesh without ``torch.distributed``), the grid's ``shape`` and
    ``axis_names``, ``size`` ranks, this process's grid ``rank`` and its
    cell ``coords``, and the ``backend`` of the group (``None`` without
    one)."""

    group: object
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    size: int
    rank: int
    coords: Tuple[int, ...]
    backend: Optional[str]


def make_mesh(grid: ProcessGrid, group=None) -> RankMesh:
    """The :class:`RankMesh` of ``grid`` over ``group`` (default: the
    default process group). The group must hold exactly ``grid.nranks``
    ranks; a rank's index in the group is its grid rank. A one-rank grid
    needs no ``torch.distributed`` at all."""
    need = grid.nranks
    if not dist.is_available() or not dist.is_initialized():
        if group is not None or need != 1:
            raise ValueError(
                f"grid {grid.shape} needs {need} ranks: initialize "
                f"torch.distributed first (initialize_distributed)"
            )
        return RankMesh(None, grid.shape, grid.axis_names, 1, 0,
                        (0,) * grid.ndim, None)
    size = dist.get_world_size(group)
    if size != need:
        raise ValueError(
            f"grid {grid.shape} needs {need} ranks, the process group has "
            f"{size}"
        )
    rank = dist.get_rank(group)
    return RankMesh(group, grid.shape, grid.axis_names, size, rank,
                    grid.cell_of_rank(rank), dist.get_backend(group))


def mesh_for(grid: ProcessGrid, mesh=None) -> RankMesh:
    """``mesh`` checked against ``grid``, or :func:`make_mesh` of
    ``grid`` when it is ``None``: what every multi-rank builder takes."""
    if mesh is None:
        return make_mesh(grid)
    validate_mesh_for_grid(mesh, grid)
    return mesh


def _validate_dcn_shape(
    grid: ProcessGrid, dcn_shape: Optional[Sequence[int]]
) -> Tuple[int, ...]:
    """Per-axis pod counts: one a grid axis, each >= 1 and dividing the
    grid's extent. ``None`` means all ones (a flat mesh)."""
    if dcn_shape is None:
        dcn_shape = (1,) * grid.ndim
    dcn_shape = tuple(int(d) for d in dcn_shape)
    if len(dcn_shape) != grid.ndim:
        raise ValueError(
            f"dcn_shape must have {grid.ndim} axes, got {dcn_shape}"
        )
    for a, (g, d) in enumerate(zip(grid.shape, dcn_shape)):
        if d < 1:
            raise ValueError(
                f"axis {a}: dcn factor must be >= 1, got {d}"
            )
        if g % d:
            raise ValueError(
                f"axis {a}: grid extent {g} not divisible by dcn {d}"
            )
    return dcn_shape


def make_hybrid_mesh(grid: ProcessGrid, dcn_shape=None, group=None
                     ) -> RankMesh:
    """The mesh of a job whose grid spans several nodes (``dcn_shape[a]``
    pods along grid axis ``a``): ``dcn_shape`` is validated and the mesh
    is :func:`make_mesh`'s, because a rank's grid rank does not depend on
    where it runs. Putting the ranks of one pod on one node (so its
    traffic stays on NVLink) is the launcher's job: start ranks
    ``rank_table[p]`` of :class:`HierarchicalMesh` on node ``p``."""
    _validate_dcn_shape(grid, dcn_shape)
    return make_mesh(grid, group)


class HierarchicalMesh:
    """Two-level view of a process grid: ``dcn_shape[a]`` splits grid axis
    ``a`` into ``d_a`` pods of ``g_a // d_a`` ranks.

    A rank's cell is ``pod_a * ici_a + local_a`` on each axis, so the
    row-major index over the interleaved ``(dcn_a, ici_a)`` axes is the
    grid rank: the ranks keep their order, a collective over every axis
    is the flat mesh's, the pod id is the row-major index over the dcn
    digits and the pod-local rank the row-major index over the ici
    digits.

    Tables (NumPy, int32): ``pod_of [R]`` and ``local_of [R]``, the pod
    and pod-local index of each grid rank; ``rank_table [n_pods,
    pod_size]``, the grid rank of slot ``l`` of pod ``p`` (ascending in
    ``l``, and in rank); ``local_grid``, the pod's :class:`ProcessGrid`
    (the intra-pod stencil's)."""

    def __init__(self, grid: ProcessGrid,
                 dcn_shape: Optional[Sequence[int]] = None):
        self.grid = grid
        self.dcn_shape = _validate_dcn_shape(grid, dcn_shape)
        self.ici_shape = tuple(
            g // d for g, d in zip(grid.shape, self.dcn_shape)
        )
        self.n_pods = math.prod(self.dcn_shape)
        self.pod_size = math.prod(self.ici_shape)
        # the reference's expanded axis names: a ``dcn_<name>`` axis in
        # front of each split grid axis; a sub-axis collective is declared
        # over ``ici_axes`` (inside a pod) or ``dcn_axes`` (across pods)
        names, dcn_axes = [], []
        for name, d in zip(grid.axis_names, self.dcn_shape):
            if d > 1:
                names.append("dcn_" + name)
                dcn_axes.append("dcn_" + name)
            names.append(name)
        self.axis_names = tuple(names)
        self.dcn_axes = tuple(dcn_axes)
        self.ici_axes = tuple(grid.axis_names)
        self.local_grid = ProcessGrid(self.ici_shape)
        R = grid.nranks
        pod_of = np.zeros(R, dtype=np.int32)
        local_of = np.zeros(R, dtype=np.int32)
        rank_table = np.zeros((self.n_pods, self.pod_size), dtype=np.int32)
        for r in range(R):
            cell = grid.cell_of_rank(r)
            p = 0
            l = 0
            for a in range(grid.ndim):
                p = p * self.dcn_shape[a] + cell[a] // self.ici_shape[a]
                l = l * self.ici_shape[a] + cell[a] % self.ici_shape[a]
            pod_of[r] = p
            local_of[r] = l
            rank_table[p, l] = r
        self.pod_of = pod_of
        self.local_of = local_of
        self.rank_table = rank_table

    def local_periodic(self, periodic: Sequence[bool]) -> Tuple[bool, ...]:
        """Periodicity of the pod-local grid: a periodic axis wraps inside
        the pod only when the pod spans it (``d_a == 1``); a split axis
        wraps across pods, which the cross stage carries."""
        return tuple(
            bool(p) and d == 1 for p, d in zip(periodic, self.dcn_shape)
        )

    def ici_group(self, rank: int) -> Tuple[int, ...]:
        """The mesh ranks of ``rank``'s pod, in pod-local order (the
        group of a collective over the ici axes)."""
        return tuple(int(r) for r in self.rank_table[self.pod_of[rank]])

    def ici_groups(self) -> Tuple[Tuple[int, ...], ...]:
        """Every pod's ranks, in pod order."""
        return tuple(tuple(int(r) for r in row) for row in self.rank_table)

    def dcn_groups(self) -> Tuple[Tuple[int, ...], ...]:
        """For each pod-local slot, the ranks holding it in every pod, in
        pod order (the groups of a collective over the dcn axes)."""
        return tuple(tuple(int(r) for r in col) for col in
                     self.rank_table.T)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, HierarchicalMesh)
            and self.grid == other.grid
            and self.dcn_shape == other.dcn_shape
        )

    def __hash__(self) -> int:
        return hash((HierarchicalMesh, self.grid, self.dcn_shape))

    def __repr__(self) -> str:
        return (
            f"HierarchicalMesh(grid={self.grid.shape}, "
            f"dcn={self.dcn_shape})"
        )


def near_cubic_shape(n: int, ndim: int = 3) -> Tuple[int, ...]:
    """Factor ``n`` ranks into an ``ndim``-axis grid as close to cubic as
    possible (largest prime factors spread round-robin)."""
    if n < 1:
        raise ValueError("need at least one rank")
    factors = []
    m = n
    d = 2
    while d * d <= m:
        while m % d == 0:
            factors.append(d)
            m //= d
        d += 1
    if m > 1:
        factors.append(m)
    shape = [1] * ndim
    for f in sorted(factors, reverse=True):
        shape[int(np.argmin(shape))] *= f
    return tuple(sorted(shape, reverse=True))


def shrink_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    """One elastic-restart shrink step: halve the largest axis (largest
    extent, lowest axis index on ties, ``extent // 2``). A shape that
    cannot shrink (all axes 1) is returned unchanged."""
    shape = tuple(int(x) for x in shape)
    if any(x < 1 for x in shape):
        raise ValueError(f"grid shape must be positive, got {shape}")
    if all(x == 1 for x in shape):
        return shape
    axis = max(range(len(shape)), key=lambda a: (shape[a], -a))
    return shape[:axis] + (max(1, shape[axis] // 2),) + shape[axis + 1:]


def shrink_to_fit(shape: Sequence[int], max_devices: int) -> Tuple[int, ...]:
    """Fewest :func:`shrink_shape` steps that fit ``shape`` onto
    ``max_devices`` ranks; raises when ``max_devices < 1``."""
    if max_devices < 1:
        raise ValueError(
            f"cannot fit a grid onto {max_devices} devices"
        )
    shape = tuple(int(x) for x in shape)
    while math.prod(shape) > max_devices:
        smaller = shrink_shape(shape)
        if smaller == shape:  # unreachable: prod((1,..)) == 1 <= max
            break
        shape = smaller
    return shape


def initialize_distributed(backend: str = "gloo", *, init_method=None,
                           world_size: int = None, rank: int = None,
                           timeout: float = 120.0, **kwargs) -> None:
    """Multi-process bring-up: ``torch.distributed.init_process_group``
    with a finite ``timeout`` in seconds (a rank that never arrives at a
    collective fails the others after it instead of hanging them for
    gloo's default half hour). ``init_method``, ``world_size`` and
    ``rank`` are passed through (``None``: the ``env://`` variables).
    ``backend="nccl"`` puts one rank on each GPU, so it refuses a world
    larger than the visible cards: several ranks sharing one card run
    over ``"gloo"``, asked for by name. Nothing chooses a backend on the
    caller's behalf."""
    if backend == "nccl":
        if world_size is None:
            world_size = int(os.environ.get("WORLD_SIZE", "1"))
        n_cards = torch.cuda.device_count()
        if world_size > n_cards:
            raise ValueError(
                f"backend='nccl' runs one rank per GPU: world size "
                f"{world_size} > {n_cards} visible GPUs; use "
                f"backend='gloo' for ranks sharing a card"
            )
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=float(timeout)),
        **kwargs,
    )


def rank_device(device: str, local_rank: int) -> torch.device:
    """A rank's device: ``"cuda"`` means ``cuda:{local_rank %
    device_count}`` (ranks share cards round-robin), anything else is
    taken as given."""
    if str(device) == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("device='cuda' but no CUDA device is visible")
        return torch.device("cuda", local_rank % n)
    return torch.device(device)


def axis_shift_perm(grid: ProcessGrid, a: int, dirn: int = 1):
    """``lax.ppermute(x, axis_names[a], [(i, (i + dirn) % g)])`` as the
    world permutation of grid ranks: each rank sends to its neighbour
    ``dirn`` steps along axis ``a`` (wrapping), for every value of the
    other axes."""
    perm = []
    for r in range(grid.nranks):
        c = list(grid.cell_of_rank(r))
        c[a] = (c[a] + dirn) % grid.shape[a]
        perm.append((r, grid.rank_of_cell(tuple(c))))
    return tuple(perm)


def stencil_offsets(ndim: int) -> Tuple[Tuple[int, ...], ...]:
    """The nonzero offsets of the 3^ndim Moore stencil, in
    ``itertools.product`` order (26 in 3D): the neighbor engine's block
    order."""
    return tuple(
        off
        for off in itertools.product((-1, 0, 1), repeat=ndim)
        if any(off)
    )


@functools.lru_cache(maxsize=64)
def neighbor_tables(
    grid: ProcessGrid, periodic: Tuple[bool, ...]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Static Moore-stencil routing tables for ``grid``: ``(offsets [n_off,
    ndim], dst [R, n_off], src [R, n_off], member [R, R])``. ``dst[r, o]``
    is rank ``r``'s offset-``o`` neighbor (periodic wrap per axis), ``-1``
    when the offset leaves an open grid, wraps onto ``r`` or repeats an
    earlier offset's destination (so every per-offset permutation is
    injective); ``src`` is its receive-side mirror; ``member[r, d]`` says
    ``d`` is within ``r``'s stencil (``d == r`` included)."""
    offs = stencil_offsets(grid.ndim)
    n_off = len(offs)
    R = grid.nranks
    dst = np.full((R, n_off), -1, dtype=np.int32)
    member = np.zeros((R, R), dtype=bool)
    for r in range(R):
        member[r, r] = True
        cell = grid.cell_of_rank(r)
        seen = set()
        for o, off in enumerate(offs):
            c = []
            ok = True
            for a in range(grid.ndim):
                x = cell[a] + off[a]
                g = grid.shape[a]
                if periodic[a]:
                    x %= g
                elif not 0 <= x < g:
                    ok = False
                    break
                c.append(x)
            if not ok:
                continue
            d = grid.rank_of_cell(tuple(c))
            if d == r or d in seen:
                continue
            seen.add(d)
            dst[r, o] = d
            member[r, d] = True
    src = np.full((R, n_off), -1, dtype=np.int32)
    for o in range(n_off):
        for r in range(R):
            d = dst[r, o]
            if d >= 0:
                src[d, o] = r
    return np.asarray(offs, dtype=np.int32), dst, src, member


def neighbor_perms(
    grid: ProcessGrid, periodic: Tuple[bool, ...]
) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """Per-offset ``(source, dest)`` permutations over the row-major rank
    space: ``perms[o] = ((r, dst[r, o]), ...)`` over ranks with a valid
    offset-``o`` neighbor."""
    _, dst, _, _ = neighbor_tables(grid, tuple(periodic))
    return tuple(
        tuple(
            (int(r), int(dst[r, o]))
            for r in range(grid.nranks)
            if dst[r, o] >= 0
        )
        for o in range(dst.shape[1])
    )


def validate_mesh_for_grid(mesh: RankMesh, grid: ProcessGrid) -> None:
    if tuple(mesh.axis_names) != tuple(grid.axis_names):
        raise ValueError(
            f"mesh axes {mesh.axis_names} != grid axes {grid.axis_names}"
        )
    if tuple(mesh.shape) != grid.shape:
        raise ValueError(
            f"mesh shape {tuple(mesh.shape)} != grid shape {grid.shape}"
        )
