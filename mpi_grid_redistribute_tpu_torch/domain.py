"""Domain and process-grid specifications (PyTorch port).

The port's own copy of :class:`Domain` and :class:`ProcessGrid` from the
JAX package's ``domain.py``: pure static metadata (frozen, hashable
dataclasses), so the port never imports the JAX package. Same
conventions:

  * the domain is an axis-aligned box ``[lo, hi)`` in ``ndim`` dimensions;
  * the process grid has one axis per domain axis (undecomposed axes use
    extent 1);
  * ranks are numbered row-major over grid cells (C order).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple


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
