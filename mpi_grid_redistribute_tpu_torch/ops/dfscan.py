"""Within-tile double-float prefix sum for the scan deposit (kernel 5).

Replaces the TPU kernel ``mpi_grid_redistribute_tpu/ops/pallas_dfscan.py``
(``tile_df_cumsum_rows``) with the hand-written CUDA kernel
``csrc/dfscan.cu``: for ``x [rows, tile]`` float32, the inclusive prefix
of every row carried as an unevaluated ``(hi, lo)`` float pair (TwoSum
arithmetic), by the Hillis-Steele doubling loop of the reference's
``deposit._df_cumsum``. The op ORDER is the contract: the scan deposit's
accuracy and its bit equality with the JAX package rest on it.

Bound: device memory bandwidth. The reference's loop makes ~6 full
passes over the tensor per doubling step; the kernel reads the tensor
once and writes hi and lo once (12 bytes per element). Up to a tile of
1024 it keeps the whole loop in registers, a warp per row (or several
rows per warp when the tile is 16 or less) exchanging values by
shuffles; above that, a block per row holds the row's (hi, lo) in shared
memory, double-buffered, up to the 14,528 elements one block's 227 KB
hold. :func:`geometry` chooses the route by that shape rule, and sends a
larger tile to the plain version.

The double-float arithmetic itself (:func:`_two_sum`, :func:`_df_add`,
:func:`_df_cumsum`) lives here as the kernel's plain version;
``ops.deposit`` uses it for the level-2 scan over tile totals, which
stays plain PyTorch as it stays XLA in the reference.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from mpi_grid_redistribute_tpu_torch.ops import _build
from mpi_grid_redistribute_tpu_torch.utils.costcount import kernel_scope

MAX_TILE = 1024  # DFSCAN_MAX_TILE in csrc/dfscan.cu: the register route
# DFSCAN_MAX_BLOCK_TILE: the block route's two (hi, lo) buffers, 16 bytes
# an element, in one block's 232,448 bytes of shared memory
MAX_BLOCK_TILE = 232448 // 16

KERNEL = _build.register(_build.Kernel(
    "tile_df_cumsum_rows", "dfscan.cu", "dfscan_launch",
    [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
))


class Geometry(NamedTuple):
    """How a row of ``tile`` elements is scanned on the card. ``route``:
    ``"warp"`` (the register route, ``regs`` elements a lane and
    ``rows_per_warp`` rows a warp), ``"block"`` (a block per row in
    shared memory; ``regs = rows_per_warp = 0``) or ``"plain"`` (the
    plain version: the row does not fit one block's shared memory)."""

    route: str
    regs: int
    rows_per_warp: int


def geometry(tile: int) -> Geometry:
    """The shape rule of kernel 5. Tiles 1..:data:`MAX_TILE` take the
    register route: each lane holds ``regs = ceil(tile / 32)`` elements
    of its row; a warp holds ``32 // tile`` rows when ``tile < 32`` (lane
    ``l`` is column ``l % tile`` of row ``l // tile``) and one row
    otherwise. Tiles up to :data:`MAX_BLOCK_TILE` take the block route;
    larger ones the plain version. Never decided by a build or launch
    failure."""
    if tile < 1:
        raise ValueError(f"tile_df_cumsum_rows: tile {tile} < 1")
    if tile <= MAX_TILE:
        return Geometry("warp", -(-tile // 32), max(1, 32 // tile))
    if tile <= MAX_BLOCK_TILE:
        return Geometry("block", 0, 0)
    return Geometry("plain", 0, 0)


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """Error-free float add (Knuth TwoSum): a + b == s + e exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _df_add(a_hi, a_lo, b_hi, b_lo):
    """Double-float add: (a_hi + a_lo) + (b_hi + b_lo) as a (hi, lo)
    pair, in the reference's operation order."""
    s, e = _two_sum(a_hi, b_hi)
    e = e + (a_lo + b_lo)
    hi = s + e
    lo = e - (hi - s)
    return hi, lo


def _df_cumsum(x: torch.Tensor, axis: int, x_lo: torch.Tensor = None):
    """Inclusive double-float prefix sum along ``axis`` by log-depth
    doubling (Hillis-Steele): ``ceil(log2(n))`` shifted :func:`_df_add`
    steps with zeros shifted in. ``x_lo`` carries inputs already split
    into (hi, lo) pairs (the tile-totals level). Returns ``(hi, lo)``."""
    n = x.shape[axis]
    hi = x
    lo = torch.zeros_like(x) if x_lo is None else x_lo
    shift = 1
    while shift < n:
        zshape = list(x.shape)
        zshape[axis] = shift
        z = torch.zeros(zshape, dtype=x.dtype, device=x.device)
        hi_s = torch.cat([z, hi.narrow(axis, 0, n - shift)], dim=axis)
        lo_s = torch.cat([z, lo.narrow(axis, 0, n - shift)], dim=axis)
        hi, lo = _df_add(hi, lo, hi_s, lo_s)
        shift *= 2
    return hi, lo


def kernel_cost(x, _out=None):
    """``(bytes, flops)`` of one call, the count ``telemetry.roofline``
    and the bound in ``chip_smoke.py`` share: ``x`` read once, ``hi`` and
    ``lo`` written once; ``ceil(log2(tile))`` double-float adds an
    element, 11 adds or subtracts each, each taking an FMA's issue slot
    (2 flops)."""
    rows, tile = x.shape
    n = rows * tile
    return 12 * n, 2 * 11 * (tile - 1).bit_length() * n


@kernel_scope("tile_df_cumsum_rows", kernel_cost)
def tile_df_cumsum_rows_plain(x: torch.Tensor):
    """Plain PyTorch version: ``_df_cumsum(x, axis=1)``."""
    return _df_cumsum(x, axis=1)


def launch_functions(x):
    """``[(function, threads a block, dynamic shared bytes)]`` of the
    launch :func:`geometry` picks for ``x`` (``analysis.kernelcheck``'s
    K003); empty on the plain route."""
    tile = x.shape[1]
    geo = geometry(tile)
    if geo.route == "warp":
        return [(f"dfscan_kernel<{geo.regs}>", 8 * 32, 0)]
    if geo.route == "block":
        return [("dfscan_block_kernel", 1024, 16 * tile)]
    return []


def _into_pair(_out, pair):
    if _out is None:
        return pair
    return tuple(_build.into(o, t, "tile_df_cumsum_rows")
                 for o, t in zip(_out, pair))


@kernel_scope("tile_df_cumsum_rows", kernel_cost)
def tile_df_cumsum_rows(x: torch.Tensor, _out=None):
    """Inclusive double-float prefix along axis 1 of ``x [rows, tile]``
    float32 -> ``(hi, lo)``, each ``[rows, tile]``. CPU tensors run
    :func:`tile_df_cumsum_rows_plain`; CUDA tensors launch the kernel on
    the route :func:`geometry` gives (the plain version for a tile above
    :data:`MAX_BLOCK_TILE`), and raise on what it cannot take. ``_out``
    (internal) is the ``(hi, lo)`` pair written to."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(
            f"tile_df_cumsum_rows takes float32 [rows, tile], got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if x.device.type == "cpu":
        return _into_pair(_out, tile_df_cumsum_rows_plain(x))
    if x.device.type != "cuda":
        raise ValueError(f"tile_df_cumsum_rows: unsupported device {x.device}")
    rows, tile = x.shape
    geo = geometry(tile)
    if not x.is_contiguous():
        raise ValueError("tile_df_cumsum_rows: x must be contiguous")
    if geo.route == "plain":
        return _into_pair(_out, tile_df_cumsum_rows_plain(x))
    hi, lo = (_build.out_tensor(o, x.shape, x.dtype, x, "tile_df_cumsum_rows")
              for o in (_out or (None, None)))
    if rows == 0:
        return hi, lo
    KERNEL.launch(
        x.data_ptr(), hi.data_ptr(), lo.data_ptr(), rows, tile, geo.regs,
        geo.rows_per_warp, _build.stream_ptr(x),
    )
    return hi, lo
