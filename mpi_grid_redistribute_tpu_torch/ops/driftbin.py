"""Fused drift + periodic wrap + destination binning (kernel 1).

Replaces the TPU kernel ``mpi_grid_redistribute_tpu/ops/pallas_driftbin.py``
(``_driftbin_call``, entry ``drift_wrap_bin``) with the hand-written CUDA
kernel ``csrc/driftbin.cu``. One streaming pass over the planar int32
state ``[K, V * n]``: drift the float32 view of the position rows, wrap
the periodic axes, bin into the full vrank grid, and write the position
rows in place together with the ``[V, n]`` destination key.

Bound: device memory bandwidth — per column it reads ``2D + 1`` words and
writes ``D + 1`` (44 B at D = 3). The kernel makes exactly that one pass
with coalesced accesses, and updates in place so the velocity and alive
rows are never copied.

:func:`drift_wrap_bin_plain` is the same function in plain PyTorch,
following the reference twin's op order (``drift_wrap_bin_xla``); the
wrapper runs it only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops import _build, binning
from mpi_grid_redistribute_tpu_torch.utils.costcount import kernel_scope

MAX_D = 8  # DRIFTBIN_MAX_D in csrc/driftbin.cu

KERNEL = _build.register(_build.Kernel(
    "drift_wrap_bin", "driftbin.cu", "driftbin_launch",
    [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ],
))


def drift_wrap(flat: torch.Tensor, dt: float, domain: Domain) -> torch.Tensor:
    """Drift + wrap the position rows of the planar int32 state ``flat``
    in place and return their float32 view: ``p = pf + vf * dt`` as two
    separate ops (never a fused multiply-add, which would change the last
    bit), then the periodic wrap."""
    D = domain.ndim
    pf = flat[:D].view(torch.float32)
    vf = flat[D : 2 * D].view(torch.float32)
    p = pf + vf * binning._f32(dt, pf)
    p = binning.wrap_periodic_planar(p, domain)
    flat[:D] = p.view(torch.int32)
    return p


def kernel_cost(flat, dt, domain, full_grid, V, R_total, _out=None):
    """``(bytes, flops)`` of one call, the count ``telemetry.roofline``
    and the bound in ``chip_smoke.py`` share: the ``2D + 1`` position,
    velocity and alive rows read and the ``D`` position rows and the key
    written, 4-byte words; per column and axis the drift, the wrap twice
    (mul, add, sub, mul, floor, mul, compare/select, add) and the bin's
    sub, mul, floor, clip and mul-add: ``22 D`` flops."""
    D = domain.ndim
    m = flat.shape[1]
    return m * 4 * ((2 * D + 1) + (D + 1)), m * D * (2 * 8 + 6)


@kernel_scope("drift_wrap_bin", kernel_cost)
def drift_wrap_bin_plain(flat: torch.Tensor, dt: float, domain: Domain,
                         full_grid: ProcessGrid, V: int, R_total: int):
    """Plain PyTorch version: drift + wrap the position rows of ``flat``
    in place (:func:`drift_wrap`), then bin. Returns ``(flat, dest_key
    [V, n])``."""
    p = drift_wrap(flat, dt, domain)
    key = binning.dest_key_planar(
        p, flat[-1] > 0, domain, full_grid, V, R_total
    )
    return flat, key


def _check(flat: torch.Tensor, domain: Domain, full_grid: ProcessGrid,
           V: int) -> None:
    D = domain.ndim
    if flat.dtype != torch.int32 or flat.dim() != 2:
        raise TypeError(
            f"drift_wrap_bin takes planar int32 [K, V*n] state, got "
            f"{flat.dtype} {tuple(flat.shape)}"
        )
    if not flat.is_contiguous():
        raise ValueError("drift_wrap_bin: state must be contiguous")
    if flat.shape[0] < 2 * D + 1 or flat.shape[1] % V or flat.shape[1] == 0:
        raise ValueError(
            f"drift_wrap_bin: need K >= 2D+1 rows and V | m columns, got "
            f"{tuple(flat.shape)} with D={D}, V={V}"
        )
    if not 1 <= D <= MAX_D or full_grid.ndim != D:
        raise ValueError(
            f"drift_wrap_bin: domain ndim {D} (grid ndim {full_grid.ndim}) "
            f"outside the kernel's 1..{MAX_D}"
        )


def launch_functions(flat, V):
    """``[(function, threads a block, dynamic shared bytes)]`` of the
    launch at these shapes (``analysis.kernelcheck``'s K003)."""
    return [("driftbin_kernel", 256, 0)]


@kernel_scope("drift_wrap_bin", kernel_cost)
def drift_wrap_bin(flat: torch.Tensor, dt: float, domain: Domain,
                   full_grid: ProcessGrid, V: int, R_total: int,
                   _out: torch.Tensor = None):
    """Fused drift + wrap + bin: ``[K, V*n]`` int32 planar state, updated
    in place -> ``(flat, dest_key [V, n])``. CPU tensors run
    :func:`drift_wrap_bin_plain`; CUDA tensors launch the kernel.
    ``_out`` (internal) is the tensor the key is written to."""
    _check(flat, domain, full_grid, V)
    if flat.device.type == "cpu":
        flat, key = drift_wrap_bin_plain(flat, dt, domain, full_grid, V,
                                         R_total)
        return flat, _build.into(_out, key, "drift_wrap_bin")
    if flat.device.type != "cuda":
        raise ValueError(f"drift_wrap_bin: unsupported device {flat.device}")
    K, m = flat.shape
    n = m // V
    key = _build.out_tensor(_out, (V, n), torch.int32, flat,
                            "drift_wrap_bin")
    D = domain.ndim
    fc = np.zeros((D, 5), np.float32)
    ic = np.zeros((D, 4), np.int32)
    for d in range(D):
        fc[d] = binning.axis_consts(domain, full_grid.shape, d)
        ic[d] = (
            int(domain.periodic[d]),
            int(binning._is_pow2(float(domain.extent[d]))),
            full_grid.shape[d],
            full_grid.strides[d],
        )
    KERNEL.launch(
        flat.data_ptr(), key.data_ptr(), m, n, K, D,
        float(np.float32(dt)), int(R_total), fc.ctypes.data, ic.ctypes.data,
        _build.stream_ptr(flat),
    )
    return flat, key
