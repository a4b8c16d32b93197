"""Domain and process-grid specifications (PyTorch port).

The port's own copy of :class:`Domain`, :class:`ProcessGrid` and
:class:`GridEdges` from the JAX package's ``domain.py``: pure static
metadata (frozen, hashable dataclasses), so the port never imports the
JAX package. Same conventions:

  * the domain is an axis-aligned box ``[lo, hi)`` in ``ndim`` dimensions;
  * the process grid has one axis per domain axis (undecomposed axes use
    extent 1);
  * ranks are numbered row-major over grid cells (C order).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np


def _as_float_tuple(x, ndim: int, name: str) -> Tuple[float, ...]:
    if isinstance(x, (int, float)):
        return (float(x),) * ndim
    t = tuple(float(v) for v in x)
    if len(t) != ndim:
        raise ValueError(f"{name} must have length {ndim}, got {len(t)}")
    return t


@dataclasses.dataclass(frozen=True)
class Domain:
    """Axis-aligned global simulation box ``[lo, hi)``.

    Scalar ``lo``/``hi`` default to a 3D cube; pass ``ndim=`` for other
    dimensionalities, or give per-axis sequences.
    """

    lo: Tuple[float, ...]
    hi: Tuple[float, ...]
    periodic: Tuple[bool, ...]

    def __init__(self, lo, hi, periodic=False, ndim=None):
        if ndim is None:
            if isinstance(lo, (int, float)) and isinstance(hi, (int, float)):
                ndim = 3
            else:
                ndim = len(lo) if not isinstance(lo, (int, float)) else len(hi)
        object.__setattr__(self, "lo", _as_float_tuple(lo, ndim, "lo"))
        object.__setattr__(self, "hi", _as_float_tuple(hi, ndim, "hi"))
        if isinstance(periodic, bool):
            per = (periodic,) * ndim
        else:
            per = tuple(bool(p) for p in periodic)
            if len(per) != ndim:
                raise ValueError(f"periodic must have length {ndim}")
        object.__setattr__(self, "periodic", per)
        for axis in range(ndim):
            if not self.hi[axis] > self.lo[axis]:
                raise ValueError(
                    f"domain axis {axis}: hi ({self.hi[axis]}) must exceed "
                    f"lo ({self.lo[axis]})"
                )

    @property
    def ndim(self) -> int:
        return len(self.lo)

    @property
    def extent(self) -> Tuple[float, ...]:
        return tuple(h - l for l, h in zip(self.lo, self.hi))


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    """Cartesian decomposition of the domain into one cell per rank.

    ``shape[axis]`` ranks along each axis; rank ids are row-major flat cell
    indices (cell ``(i, j, k)`` of grid ``(gx, gy, gz)`` is rank
    ``(i * gy + j) * gz + k``). ``axis_names`` label the grid axes.
    """

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str] = None):
        shape = tuple(int(s) for s in shape)
        if not shape or any(s < 1 for s in shape):
            raise ValueError(f"grid shape must be positive, got {shape}")
        if axis_names is None:
            default = ("x", "y", "z", "w", "v", "u")
            if len(shape) > len(default):
                raise ValueError("provide axis_names for >6D grids")
            axis_names = default[: len(shape)]
        axis_names = tuple(str(a) for a in axis_names)
        if len(axis_names) != len(shape):
            raise ValueError("axis_names must match grid shape length")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis_names must be unique, got {axis_names}")
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "axis_names", axis_names)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nranks(self) -> int:
        return math.prod(self.shape)

    @property
    def strides(self) -> Tuple[int, ...]:
        """Row-major strides: flat rank = sum(cell[i] * strides[i])."""
        strides = []
        acc = 1
        for s in reversed(self.shape):
            strides.append(acc)
            acc *= s
        return tuple(reversed(strides))

    def rank_of_cell(self, cell: Sequence[int]) -> int:
        if len(cell) != self.ndim:
            raise ValueError(f"cell must have {self.ndim} coordinates")
        rank = 0
        for c, s, g in zip(cell, self.strides, self.shape):
            if not 0 <= c < g:
                raise ValueError(f"cell {tuple(cell)} outside grid {self.shape}")
            rank += int(c) * s
        return rank

    def cell_of_rank(self, rank: int) -> Tuple[int, ...]:
        if not 0 <= rank < self.nranks:
            raise ValueError(f"rank {rank} outside grid of {self.nranks}")
        cell = []
        for s in self.strides:
            cell.append(rank // s)
            rank = rank % s
        return tuple(cell)

    def neighbor_rank(self, rank: int, axis: int, step: int,
                      periodic: bool) -> int:
        """Rank of the neighbor ``step`` cells along ``axis``; -1 if off-grid
        and not periodic."""
        cell = list(self.cell_of_rank(rank))
        c = cell[axis] + step
        g = self.shape[axis]
        if periodic:
            c %= g
        elif not 0 <= c < g:
            return -1
        cell[axis] = c
        return self.rank_of_cell(cell)

    def validate_against(self, domain: Domain) -> None:
        if self.ndim != domain.ndim:
            raise ValueError(
                f"grid ndim {self.ndim} != domain ndim {domain.ndim}; pad the "
                f"grid shape with 1s for undecomposed axes, or pass "
                f"Domain(lo, hi, ndim={self.ndim}) — scalar bounds default "
                f"to a 3D domain"
            )

    def cell_widths(self, domain: Domain) -> Tuple[float, ...]:
        self.validate_against(domain)
        return tuple(e / s for e, s in zip(domain.extent, self.shape))

    def subdomain_of_rank(self, rank: int, domain: Domain):
        """(lo, hi) bounds of this rank's owned subvolume."""
        cell = self.cell_of_rank(rank)
        w = self.cell_widths(domain)
        lo = tuple(domain.lo[a] + cell[a] * w[a] for a in range(self.ndim))
        hi = tuple(domain.lo[a] + (cell[a] + 1) * w[a] for a in range(self.ndim))
        return lo, hi


@dataclasses.dataclass(frozen=True)
class GridEdges:
    """Non-uniform per-axis subdomain boundaries.

    ``edges[axis]`` is a strictly increasing tuple of floats spanning
    exactly ``[domain.lo[axis], domain.hi[axis]]``; cell ``k`` on that
    axis owns ``[edges[k], edges[k+1])``. Without ``assignment`` there
    are ``shape[axis] + 1`` boundaries and grid cell == rank. With
    ``assignment`` the edges define a finer cell grid (``len(edges[a]) -
    1`` cells per axis) and ``assignment`` maps each row-major flat fine
    cell to its owning rank, so a rank's territory is a set of fine cells.

    Frozen and hashable (tuples only). ``uniform_axes`` (derived, outside
    eq/hash) flags the axes that reproduce ``np.linspace`` exactly: those
    bin by the uniform floor-multiply instead of the per-edge digitize.
    """

    edges: Tuple[Tuple[float, ...], ...]
    assignment: Optional[Tuple[int, ...]] = None

    def __init__(
        self,
        edges: Sequence[Sequence[float]],
        assignment: Optional[Sequence[int]] = None,
    ):
        object.__setattr__(
            self,
            "edges",
            tuple(tuple(float(v) for v in ax) for ax in edges),
        )
        for a, ax in enumerate(self.edges):
            if len(ax) < 2:
                raise ValueError(
                    f"edges axis {a}: need >= 2 boundaries, got {len(ax)}"
                )
            # `not (a < b)` so NaN boundaries fail too
            if any(not (ax[i] < ax[i + 1]) for i in range(len(ax) - 1)):
                raise ValueError(
                    f"edges axis {a} must be strictly increasing and "
                    f"NaN-free, got {ax}"
                )
        if assignment is not None:
            assignment = tuple(int(r) for r in assignment)
            n_cells = math.prod(self.cells_shape)
            if len(assignment) != n_cells:
                raise ValueError(
                    f"assignment has {len(assignment)} entries for "
                    f"{n_cells} cells (edges define {self.cells_shape})"
                )
            if any(r < 0 for r in assignment):
                raise ValueError("assignment ranks must be >= 0")
        object.__setattr__(self, "assignment", assignment)
        object.__setattr__(
            self,
            "uniform_axes",
            tuple(
                np.array_equal(
                    np.asarray(ax, dtype=np.float64),
                    np.linspace(ax[0], ax[-1], len(ax)),
                )
                for ax in self.edges
            ),
        )

    @property
    def ndim(self) -> int:
        return len(self.edges)

    @property
    def cells_shape(self) -> Tuple[int, ...]:
        """Per-axis cell counts these edges define (``len(edges[a]) - 1``)."""
        return tuple(len(ax) - 1 for ax in self.edges)

    @property
    def cell_strides(self) -> Tuple[int, ...]:
        """Row-major strides over :attr:`cells_shape` (the flat fine-cell
        id indexes :attr:`assignment`)."""
        strides = []
        acc = 1
        for s in reversed(self.cells_shape):
            strides.append(acc)
            acc *= s
        return tuple(reversed(strides))

    def validate_against(self, domain: Domain, grid: ProcessGrid) -> None:
        grid.validate_against(domain)
        if self.ndim != grid.ndim:
            raise ValueError(
                f"edges ndim {self.ndim} != grid ndim {grid.ndim}"
            )
        for a, ax in enumerate(self.edges):
            if self.assignment is None and len(ax) != grid.shape[a] + 1:
                raise ValueError(
                    f"edges axis {a}: {len(ax)} boundaries for "
                    f"{grid.shape[a]} cells (need shape+1, or pass an "
                    f"assignment for finer-than-grid cells)"
                )
            if ax[0] != domain.lo[a] or ax[-1] != domain.hi[a]:
                raise ValueError(
                    f"edges axis {a} must span [{domain.lo[a]}, "
                    f"{domain.hi[a]}] exactly, got [{ax[0]}, {ax[-1]}]"
                )
        if self.assignment is not None and max(self.assignment) >= grid.nranks:
            raise ValueError(
                f"assignment references rank {max(self.assignment)} but "
                f"grid {grid.shape} has only {grid.nranks} ranks"
            )

    def subdomain_of_rank(self, rank: int, grid: ProcessGrid):
        """(lo, hi) bounds of ``rank``'s box; undefined (raises) with an
        ``assignment``, where a rank owns a set of fine cells."""
        if self.assignment is not None:
            raise ValueError(
                "subdomain_of_rank is undefined for assignment-aware "
                "edges: a rank owns a set of fine cells, not one box — "
                "enumerate cells via rank_cells_of instead"
            )
        cell = grid.cell_of_rank(rank)
        lo = tuple(self.edges[a][cell[a]] for a in range(self.ndim))
        hi = tuple(self.edges[a][cell[a] + 1] for a in range(self.ndim))
        return lo, hi

    def rank_cells_of(self, rank: int) -> Tuple[int, ...]:
        """Flat fine-cell ids owned by ``rank`` under :attr:`assignment`."""
        if self.assignment is None:
            raise ValueError(
                "rank_cells_of needs assignment-aware edges; identity "
                "edges map grid cell == rank (use grid.cell_of_rank)"
            )
        return tuple(c for c, r in enumerate(self.assignment) if r == rank)

    @staticmethod
    def balanced_for(domain: Domain, grid: ProcessGrid,
                     positions) -> "GridEdges":
        """Edges placing ~equal row counts per slab along each axis: per-axis
        quantiles of host sample positions ``[N, ndim]``, after the
        periodic wrap (open axes clamp into ``[lo, hi]``), snapped to the
        domain bounds at the ends and pushed apart where they collide."""
        grid.validate_against(domain)
        shp = np.shape(positions)
        if len(shp) != 2 or shp[1] != grid.ndim:
            raise ValueError(
                f"positions must be [N, {grid.ndim}], got {shp}"
            )
        pos = np.array(positions, dtype=np.float64)
        for a in range(grid.ndim):
            lo, ext = domain.lo[a], domain.extent[a]
            if domain.periodic[a]:
                pos[:, a] = lo + np.remainder(pos[:, a] - lo, ext)
            else:
                pos[:, a] = np.clip(pos[:, a], lo, lo + ext)
        axes_edges = []
        for a in range(grid.ndim):
            g = grid.shape[a]
            qs = np.quantile(pos[:, a], np.linspace(0.0, 1.0, g + 1))
            qs[0], qs[-1] = domain.lo[a], domain.hi[a]
            for i in range(1, g + 1):
                if qs[i] <= qs[i - 1]:
                    qs[i] = np.nextafter(qs[i - 1], np.inf)
            qs[-1] = domain.hi[a]
            for i in range(g - 1, 0, -1):
                if qs[i] >= qs[i + 1]:
                    qs[i] = np.nextafter(qs[i + 1], -np.inf)
            if any(qs[i] <= qs[i - 1] for i in range(1, g + 1)):
                raise ValueError(
                    f"axis {a}: cannot place {g} non-empty slabs in "
                    f"[{domain.lo[a]}, {domain.hi[a]}]"
                )
            axes_edges.append(tuple(float(v) for v in qs))
        return GridEdges(axes_edges)
