"""Segmented CIC deposit: per-cell corner-weight sums of a cell-sorted
particle stream (kernel 4).

Replaces the TPU kernel ``mpi_grid_redistribute_tpu/ops/pallas_segdep.py``
(``_segsum_tpu``, entry ``segsum_sorted``) with the hand-written CUDA
kernel ``csrc/segdep.cu``. Input: ``keys [N]`` int32 sorted so that every
valid key is one contiguous run (a globally sorted stream, or per-slab
sorts concatenated with sentinel runs at the slab tails), sentinel
``n_cells`` for invalid rows; ``rel [D, N]`` block-local coordinates and
``mass [N]`` (or ``None``: unit mass) in the same order. Output
``[2^D, n_cells]`` float32.

The TPU's one-hot matrix products exist because it cannot scatter. On
Hopper one thread per row builds the corner weights, a block reduces
its equal-key runs in stream order and writes each run once; runs that
cross blocks are added in block order by a second tiny pass. Bound:
device memory bandwidth (read the stream once, write the canvas once).
No float atomics, so the result is bit-reproducible; the summation
order differs from the plain version's sequential ``index_add_``, so the
two agree bit for bit only where every order gives the same bits (dyadic
data) and at float32-summation tolerance otherwise.

:func:`segsum_sorted_plain` is the reference's ``_segsum_xla``: the
shared :func:`_corner_weights`, a mask, and an ``index_add_`` per channel
into ``n_cells + 1`` slots.
"""

from __future__ import annotations

import ctypes
import itertools

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch.ops import _build

MAX_D = 3  # SEGDEP_MAX_D in csrc/segdep.cu
BLOCK = 256  # SEGDEP_BLOCK: rows per block of the first pass

KERNEL = _build.register(_build.Kernel(
    "segsum_sorted", "segdep.cu", "segdep_launch",
    [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ],
))


def _corner_weights(rel_rows, mass, vblock) -> torch.Tensor:
    """The 2^D corner-weight channels ``[2^D, N]``: per axis the
    clip-floor frac (a FLOAT clip of ``floor(r)`` to ``[0, vblock - 1]``),
    the corner product as an explicit left fold, mass multiplied last
    (``mass=None``: unit mass, no multiply)."""
    d = len(rel_rows)
    fracs = []
    for dd in range(d):
        r = rel_rows[dd]
        i0 = torch.floor(r).clamp(0.0, float(vblock[dd] - 1))
        fracs.append((r - i0).clamp(0.0, 1.0))
    rows = []
    for corner in itertools.product((0, 1), repeat=d):
        w = None
        for dd in range(d):
            tt = fracs[dd] if corner[dd] == 1 else 1.0 - fracs[dd]
            w = tt if w is None else w * tt
        if mass is not None:
            w = mass * w
        rows.append(w)
    return torch.stack(rows, dim=0)


def _check(keys, rel, mass, n_cells: int) -> None:
    if n_cells > 2**27:
        raise ValueError(
            f"segsum_sorted: n_cells={n_cells} exceeds the int32/memory "
            "bound (2**27)"
        )
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise TypeError(
            f"segsum_sorted: keys must be int32 [N], got {keys.dtype} "
            f"{tuple(keys.shape)}"
        )
    n = keys.shape[0]
    if rel.dtype != torch.float32 or rel.dim() != 2 or rel.shape[1] != n:
        raise TypeError(
            f"segsum_sorted: rel must be float32 [D, {n}], got {rel.dtype} "
            f"{tuple(rel.shape)}"
        )
    if mass is not None and (
        mass.dtype != torch.float32 or tuple(mass.shape) != (n,)
    ):
        raise TypeError(
            f"segsum_sorted: mass must be float32 [{n}] or None, got "
            f"{mass.dtype} {tuple(mass.shape)}"
        )


def segsum_sorted_plain(keys, rel, mass, n_cells: int, vblock):
    """Plain PyTorch version (the reference's ``_segsum_xla``): masked
    corner weights summed per cell by ``index_add_`` into ``n_cells + 1``
    slots, the last one absorbing the sentinels."""
    _check(keys, rel, mass, n_cells)
    d = rel.shape[0]
    wch = _corner_weights([rel[dd] for dd in range(d)], mass, vblock)
    valid = keys < n_cells
    wch = torch.where(valid[None, :], wch, 0.0)
    seg = keys.clamp(0, n_cells).long()
    out = torch.zeros((wch.shape[0], n_cells + 1), dtype=torch.float32,
                      device=keys.device)
    out.index_add_(1, seg, wch)
    return out[:, :n_cells]


def segsum_sorted(keys, rel, mass, n_cells: int, vblock):
    """Per-cell corner-weight sums of a cell-sorted stream -> ``[2^D,
    n_cells]``. CPU tensors run :func:`segsum_sorted_plain`; CUDA tensors
    launch the kernel (``D`` up to 3; keys outside ``[0, n_cells)`` are
    dropped) or raise."""
    _check(keys, rel, mass, n_cells)
    if keys.device.type == "cpu":
        return segsum_sorted_plain(keys, rel, mass, n_cells, vblock)
    if keys.device.type != "cuda":
        raise ValueError(f"segsum_sorted: unsupported device {keys.device}")
    d = rel.shape[0]
    if not 1 <= d <= MAX_D or len(vblock) != d:
        raise ValueError(
            f"segsum_sorted: D={d} (vblock {tuple(vblock)}) outside the "
            f"kernel's 1..{MAX_D}"
        )
    tensors = (keys, rel) if mass is None else (keys, rel, mass)
    if any(t.device != keys.device for t in tensors):
        raise ValueError("segsum_sorted: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("segsum_sorted: tensors must be contiguous")
    n = keys.shape[0]
    nch = 1 << d
    out = torch.empty((nch, n_cells), dtype=torch.float32, device=keys.device)
    if n == 0:
        return out.zero_()
    nb = -(-n // BLOCK)
    carry_sum = torch.empty((nb, 2 * nch), dtype=torch.float32,
                            device=keys.device)
    carry_meta = torch.empty((nb, 3), dtype=torch.int32, device=keys.device)
    vmax = np.asarray([b - 1 for b in vblock], np.float32)
    KERNEL.launch(
        keys.data_ptr(), rel.data_ptr(),
        None if mass is None else mass.data_ptr(), out.data_ptr(),
        carry_sum.data_ptr(), carry_meta.data_ptr(), n, int(n_cells), d,
        vmax.ctypes.data, _build.stream_ptr(keys),
    )
    return out
