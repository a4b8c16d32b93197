"""Within-tile double-float prefix sum for the scan deposit (kernel 5).

Replaces the TPU kernel ``mpi_grid_redistribute_tpu/ops/pallas_dfscan.py``
(``tile_df_cumsum_rows``) with the hand-written CUDA kernel
``csrc/dfscan.cu``: for ``x [rows, tile]`` float32, the inclusive prefix
of every row carried as an unevaluated ``(hi, lo)`` float pair (TwoSum
arithmetic), by the Hillis-Steele doubling loop of the reference's
``deposit._df_cumsum``. The op ORDER is the contract: the scan deposit's
accuracy and its bit equality with the JAX package rest on it.

Bound: device memory bandwidth. The reference's loop makes ~6 full
passes over the tensor per doubling step; the kernel keeps the whole
loop in shared memory and reads the tensor once and writes hi and lo
once (12 bytes per element).

The double-float arithmetic itself (:func:`_two_sum`, :func:`_df_add`,
:func:`_df_cumsum`) lives here as the kernel's plain version;
``ops.deposit`` uses it for the level-2 scan over tile totals, which
stays plain PyTorch as it stays XLA in the reference.
"""

from __future__ import annotations

import ctypes

import torch

from mpi_grid_redistribute_tpu_torch.ops import _build

MAX_TILE = 1024  # DFSCAN_MAX_TILE in csrc/dfscan.cu

KERNEL = _build.register(_build.Kernel(
    "tile_df_cumsum_rows", "dfscan.cu", "dfscan_launch",
    [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ],
))


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


def tile_df_cumsum_rows_plain(x: torch.Tensor):
    """Plain PyTorch version: ``_df_cumsum(x, axis=1)``."""
    return _df_cumsum(x, axis=1)


def tile_df_cumsum_rows(x: torch.Tensor):
    """Inclusive double-float prefix along axis 1 of ``x [rows, tile]``
    float32 -> ``(hi, lo)``, each ``[rows, tile]``. CPU tensors run
    :func:`tile_df_cumsum_rows_plain`; CUDA tensors launch the kernel,
    which takes any ``tile`` from 1 to 1024 and raises on anything else
    it cannot take."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(
            f"tile_df_cumsum_rows takes float32 [rows, tile], got {x.dtype} "
            f"{tuple(x.shape)}"
        )
    if x.device.type == "cpu":
        return tile_df_cumsum_rows_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"tile_df_cumsum_rows: unsupported device {x.device}")
    rows, tile = x.shape
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(
            f"tile_df_cumsum_rows: tile {tile} outside the kernel's "
            f"1..{MAX_TILE}"
        )
    if not x.is_contiguous():
        raise ValueError("tile_df_cumsum_rows: x must be contiguous")
    hi = torch.empty_like(x)
    lo = torch.empty_like(x)
    if rows == 0:
        return hi, lo
    KERNEL.launch(
        x.data_ptr(), hi.data_ptr(), lo.data_ptr(), rows, tile,
        _build.stream_ptr(x),
    )
    return hi, lo
