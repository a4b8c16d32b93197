"""Row scatter (kernel 6).

Replaces the TPU kernel ``mpi_grid_redistribute_tpu/ops/pallas_scatter.py``
(``_scatter_sorted``, entry ``scatter_rows``) with the hand-written CUDA
kernel ``csrc/scatter.cu``: ``flat[targets[j]] = rows[j]`` on a row-major
``[n_rows, K]`` array, in place, dropping every target outside
``[0, n_rows)``. In-range targets must be unique (the migrate engine's
landing plan guarantees it; see ``parallel.migrate._land_scatter``).

The TPU kernel sorts the arrivals and streams the whole destination
through VMEM because it cannot store a row at a dynamic address; here a
warp per 32 arrivals loads their targets once and writes their rows
straight to place, touching only the arrivals' rows (a warp whose targets
are all dropped stops there). Bound: device memory bandwidth on the
scattered row writes. The kernel's index math is 32-bit where the words
fit an int32 and 64-bit otherwise, chosen here (:func:`index_bits`).

Words move as raw integers of the element's size on both versions, so
any bit pattern survives. The reference's XLA fallback (taken off its
kernel's shapes) wraps a negative target instead of dropping it
(ROADMAP.md C3); this port drops negatives at every shape, the kernel's
contract.
"""

from __future__ import annotations

import ctypes

import torch

from mpi_grid_redistribute_tpu_torch.ops import _build
from mpi_grid_redistribute_tpu_torch.utils import costcount
from mpi_grid_redistribute_tpu_torch.utils.costcount import kernel_scope

KERNEL = _build.register(_build.Kernel(
    "scatter_rows", "scatter.cu", "scatter_launch",
    [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
))

# integer dtype of each word size the kernel moves
_WORDS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

_I32_MAX = 2**31 - 1


def index_bits(n_rows: int, p: int, k: int) -> int:
    """Width of the kernel's index math: 32 when every word offset of
    ``flat`` (``n_rows * k``) and of ``rows`` (``p * k``) fits in an
    int32, else 64."""
    return 32 if max(n_rows, p) * k <= _I32_MAX else 64


def kernel_cost(flat, targets, rows):
    """``(bytes, flops)`` of one call, the count ``telemetry.roofline``
    and the bound in ``chip_smoke.py`` share: the ``P`` targets read, and
    each in-range row read once and written once (a dropped row is never
    needed); no flops. The in-range count is read off the device."""
    K = flat.shape[1]
    P = targets.shape[0]
    n_ok = costcount.in_range(targets, flat.shape[0])
    return 4 * P + 2 * flat.element_size() * K * n_ok, 0


# the C type of each word size and index width (csrc/scatter.cu's names)
_C_WORDS = {1: "uint8_t", 2: "uint16_t", 4: "uint32_t",
            8: "unsigned long long"}
_C_INDEX = {32: "uint32_t", 64: "unsigned long long"}


def launch_functions(flat, targets, rows):
    """``[(function, threads a block, dynamic shared bytes)]`` of the
    launch at these shapes (``analysis.kernelcheck``'s K003): the
    instance of the word size, of ``K`` (compiled in for 1..8) and of the
    index width :func:`index_bits` picks."""
    n_rows, K = flat.shape
    bits = index_bits(n_rows, targets.shape[0], K)
    kt = K if 1 <= K <= 8 else 0
    return [(f"scatter_rows_kernel<{_C_WORDS[flat.element_size()]},{kt},"
             f"{_C_INDEX[bits]}>", 8 * 32, 0)]


@kernel_scope("scatter_rows", kernel_cost)
def scatter_rows_plain(flat: torch.Tensor, targets: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``flat[t[ok]] = rows[ok]`` with ``ok = (t >=
    0) & (t < n_rows)``, on integer views of the words, in place."""
    ok = (targets >= 0) & (targets < flat.shape[0])
    word = _WORDS[flat.element_size()]
    flat.view(word)[targets[ok].long()] = rows.view(word)[ok]
    return flat


@kernel_scope("scatter_rows", kernel_cost)
def scatter_rows(flat: torch.Tensor, targets: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """``flat[targets] = rows`` with targets outside ``[0, n_rows)``
    dropped, in place on ``flat`` (returned). ``flat`` is a contiguous
    ``[n_rows, K]`` tensor of 1-, 2-, 4- or 8-byte elements, ``targets``
    int32 ``[P]``, ``rows`` ``[P, K]`` of ``flat``'s dtype, all on one
    device; ``n_rows < 2**31``; ``P == 0`` is a no-op.

    CPU tensors run :func:`scatter_rows_plain`; CUDA tensors launch the
    kernel."""
    if flat.dim() != 2 or flat.element_size() not in _WORDS:
        raise TypeError(
            f"scatter_rows: flat must be [n_rows, K] of 1/2/4/8-byte "
            f"elements, got {flat.dtype} {tuple(flat.shape)}"
        )
    n_rows, K = flat.shape
    p = targets.shape[0] if targets.dim() == 1 else -1
    if (
        targets.dtype != torch.int32
        or targets.dim() != 1
        or rows.dtype != flat.dtype
        or tuple(rows.shape) != (p, K)
    ):
        raise TypeError(
            f"scatter_rows: need int32 targets [P] and rows [P, {K}] of "
            f"{flat.dtype}, got {targets.dtype} {tuple(targets.shape)} and "
            f"{rows.dtype} {tuple(rows.shape)}"
        )
    if not (flat.device == targets.device == rows.device):
        raise ValueError("scatter_rows: tensors on different devices")
    if n_rows >= 2**31:
        raise ValueError(f"scatter_rows: n_rows={n_rows} exceeds int32 targets")
    if flat.device.type == "cpu":
        return scatter_rows_plain(flat, targets, rows)
    if flat.device.type != "cuda":
        raise ValueError(f"scatter_rows: unsupported device {flat.device}")
    if not (flat.is_contiguous() and targets.is_contiguous()
            and rows.is_contiguous()):
        raise ValueError("scatter_rows: tensors must be contiguous")
    if p == 0 or n_rows == 0 or K == 0:
        return flat
    KERNEL.launch(
        flat.data_ptr(), targets.data_ptr(), rows.data_ptr(), n_rows, p, K,
        flat.element_size(), index_bits(n_rows, p, K),
        _build.stream_ptr(flat),
    )
    return flat
