"""Landing column scatter (kernel 2).

Replaces the TPU kernels ``mpi_grid_redistribute_tpu/ops/pallas_overlay.py``
(``_overlay_sorted`` and ``_overlay_sorted_i8``, entry
``overlay_scatter_planar``) with the hand-written CUDA kernel
``csrc/overlay.cu``: ``flat[:, targets] = cols`` on planar ``[K, m]``
int32 or float32 state, in place, dropping targets outside ``[0, m)``.
In-range targets must be unique (the migrate engine guarantees it; see
``parallel.migrate._land_scatter``).

The TPU's sort, byte-plane split and one-hot matrix products exist only
because the TPU places single elements badly. On Hopper one thread per
update writes its K words to its column directly, touching P columns
instead of all m. Bound: device memory bandwidth on the scattered writes
(a lone 4-byte store costs a 32-byte sector).

Words move as raw 32-bit patterns on both versions (float32 state is
viewed as int32), so NaN payloads survive exactly.
"""

from __future__ import annotations

import ctypes
import os

import torch

from mpi_grid_redistribute_tpu_torch.ops import _build
from mpi_grid_redistribute_tpu_torch.utils import costcount
from mpi_grid_redistribute_tpu_torch.utils.costcount import kernel_scope

ENCODINGS = ("half", "quarter", "int8")

KERNEL = _build.register(_build.Kernel(
    "overlay_scatter_planar", "overlay.cu", "overlay_launch",
    [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ],
))


def kernel_cost(flat, targets, cols, encoding=None):
    """``(bytes, flops)`` of one call, the count ``telemetry.roofline``
    and the bound in ``chip_smoke.py`` share: the ``P`` targets read, and
    the ``K`` words of each in-range target's column read and written (a
    dropped column is never read); no flops. The in-range count is read
    off the device."""
    K = flat.shape[0]
    P = targets.shape[0]
    n_ok = costcount.in_range(targets, flat.shape[1])
    return 4 * P + 2 * flat.element_size() * K * n_ok, 0


def launch_functions(flat, targets, cols):
    """``[(function, threads a block, dynamic shared bytes)]`` of the
    launch (``analysis.kernelcheck``'s K003)."""
    return [("overlay_kernel", 256, 0)]


@kernel_scope("overlay_scatter_planar", kernel_cost)
def overlay_scatter_planar_plain(flat: torch.Tensor, targets: torch.Tensor,
                                 cols: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``flat[:, t[ok]] = cols[:, ok]`` on the
    int32 view, in place."""
    m = flat.shape[1]
    ok = (targets >= 0) & (targets < m)
    f32 = flat.dtype == torch.float32
    # viewed only when float32, a 4-byte dtype (gridlint G004)
    fi = flat.view(torch.int32) if f32 else flat  # gridlint: disable=G004
    ci = cols.view(torch.int32) if f32 else cols  # gridlint: disable=G004
    # the CPU stand-in of the launch, which reads nothing back (G003)
    fi[:, targets[ok].long()] = ci[:, ok]  # gridlint: disable=G003
    return flat


def _raise_on_duplicate_targets(targets: torch.Tensor, m: int) -> None:
    # a debug check, on only under MPI_GRID_OVERLAY_DEBUG=1 (G003)
    t = targets[(targets >= 0) & (targets < m)]  # gridlint: disable=G003
    dup = t.numel() - torch.unique(t).numel()  # gridlint: disable=G003
    if dup > 0:
        raise ValueError(
            f"overlay_scatter_planar: {dup} duplicate in-range target(s). "
            "Every in-range target must be unique: the landing has one "
            "writer per column — see parallel.migrate._land_scatter for "
            "where the engine establishes this invariant."
        )


@kernel_scope("overlay_scatter_planar", kernel_cost)
def overlay_scatter_planar(flat: torch.Tensor, targets: torch.Tensor,
                           cols: torch.Tensor,
                           encoding=None) -> torch.Tensor:
    """``flat[:, targets] = cols`` with out-of-range targets dropped, in
    place on ``flat`` (returned). ``flat`` is int32 or float32 ``[K, m]``,
    ``targets`` int32 ``[P]``, ``cols`` ``[K, P]`` of ``flat``'s dtype.

    ``encoding`` keeps the reference's argument and its validation
    (default: env ``MPI_GRID_OVERLAY_ENC`` or ``"int8"``; an unknown name
    raises); it selects nothing here, as the kernel moves whole words.
    With env ``MPI_GRID_OVERLAY_DEBUG=1`` it checks on the host, with a
    device sync, that in-range targets are unique.

    CPU tensors run :func:`overlay_scatter_planar_plain`; CUDA tensors
    launch the kernel."""
    if encoding is None:
        encoding = os.environ.get("MPI_GRID_OVERLAY_ENC", "int8")
    if encoding not in ENCODINGS:
        raise ValueError(
            f"overlay encoding must be 'half', 'quarter' or 'int8', got "
            f"{encoding!r} (check MPI_GRID_OVERLAY_ENC)"
        )
    if flat.dim() != 2 or flat.dtype not in (torch.int32, torch.float32):
        raise TypeError(
            f"overlay_scatter_planar: flat must be int32/float32 [K, m], "
            f"got {flat.dtype} {tuple(flat.shape)}"
        )
    K, m = flat.shape
    p = targets.shape[0]
    if (
        targets.dtype != torch.int32
        or targets.dim() != 1
        or cols.dtype != flat.dtype
        or tuple(cols.shape) != (K, p)
    ):
        raise TypeError(
            f"overlay_scatter_planar: need int32 targets [P] and cols "
            f"[{K}, P] of {flat.dtype}, got {targets.dtype} "
            f"{tuple(targets.shape)} and {cols.dtype} {tuple(cols.shape)}"
        )
    if not (flat.device == targets.device == cols.device):
        raise ValueError("overlay_scatter_planar: tensors on different devices")
    if os.environ.get("MPI_GRID_OVERLAY_DEBUG") == "1" and p > 1:
        _raise_on_duplicate_targets(targets, m)
    if flat.device.type == "cpu":
        return overlay_scatter_planar_plain(flat, targets, cols)
    if flat.device.type != "cuda":
        raise ValueError(
            f"overlay_scatter_planar: unsupported device {flat.device}"
        )
    if not (flat.is_contiguous() and targets.is_contiguous()
            and cols.is_contiguous()):
        raise ValueError("overlay_scatter_planar: tensors must be contiguous")
    if m >= 2**31:
        raise ValueError(f"overlay_scatter_planar: m={m} exceeds int32 targets")
    if p == 0:
        return flat
    KERNEL.launch(
        flat.data_ptr(), targets.data_ptr(), cols.data_ptr(), m, p, K,
        _build.stream_ptr(flat),
    )
    return flat
