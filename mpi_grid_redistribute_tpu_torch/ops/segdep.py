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

Stream contract: the VALID keys (those in ``[0, n_cells)``) never
decrease along the stream; invalid keys may sit anywhere. Both callers
meet it: ``ops/deposit.cic_deposit_device_mxu`` sorts the whole stream,
``_slab_deposit_from_keys`` sorts each slab of vrank-major keys (slab
``v`` holds keys in ``[v * C, (v + 1) * C)``). It is inside the
reference's chunk-monotone contract.

The TPU's one-hot matrix products exist because it cannot scatter. On
Hopper a block takes a tile of 2048 rows, 8 consecutive rows a lane
loaded with 16-byte loads; each lane sums its runs in registers; only
each lane's first key, last key and last-run sum go through a segmented
block scan, which places the runs that cross lanes; runs land in a
shared-memory window of the canvas that the block writes out coalesced;
runs that cross tiles go through a carry record per tile and a one-block
scan over the records (the tile count is :func:`geometry`'s). Bound:
device memory bandwidth (read the stream once, write the canvas once,
plus the canvas's memset). No float atomics, so the result is
bit-reproducible; the summation order differs from the plain version's
sequential ``index_add_``, so the two agree bit for bit only where every
order gives the same bits (dyadic data) and at float32-summation
tolerance otherwise.

A negative key is dropped by the kernel but clamped into cell 0 by the
plain version, as by the reference's ``_segsum_xla`` (ROADMAP.md C4);
negative keys are outside the contract and no caller passes one.

:func:`segsum_sorted_plain` is the reference's ``_segsum_xla``: the
shared :func:`_corner_weights`, a mask, and an ``index_add_`` per channel
into ``n_cells + 1`` slots.
"""

from __future__ import annotations

import ctypes
import itertools
import os

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch.ops import _build

MAX_D = 3  # SEGDEP_MAX_D in csrc/segdep.cu
TILE = 2048  # SEGDEP_TILE: rows per block of the first pass

KERNEL = _build.register(_build.Kernel(
    "segsum_sorted", "segdep.cu", "segdep_launch",
    [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ],
))


def geometry(n: int, d: int):
    """``(n_tiles, carry_floats)``: the first pass's tile count for a
    stream of ``n`` rows (one 256-thread block per ``TILE`` rows) and the
    floats of one tile's carry record at ``2^d`` channels (its last run's
    total and its first run's sum)."""
    if n < 0 or not 1 <= d <= MAX_D:
        raise ValueError(f"segsum_sorted: no geometry for n={n}, D={d}")
    return -(-n // TILE), 2 * (1 << d)


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


def _raise_on_decreasing_valid_keys(keys: torch.Tensor, n_cells: int) -> None:
    v = keys[(keys >= 0) & (keys < n_cells)]
    down = torch.nonzero(v[1:] < v[:-1]).flatten()
    if down.numel() > 0:
        i = int(down[0])
        raise ValueError(
            f"segsum_sorted: the valid keys decrease {down.numel()} "
            f"time(s), first from {int(v[i])} to {int(v[i + 1])} (valid "
            f"row {i + 1}). The kernel sums equal-key runs and needs the "
            "valid keys non-decreasing along the stream; sort them (see "
            "ops.deposit's callers)."
        )


def segsum_sorted(keys, rel, mass, n_cells: int, vblock):
    """Per-cell corner-weight sums of a cell-sorted stream -> ``[2^D,
    n_cells]``. The valid keys must not decrease along the stream (see
    the module note); with env ``MPI_GRID_SEGDEP_DEBUG=1`` that is
    checked, with a device sync, and a stream that breaks it raises.
    CPU tensors run :func:`segsum_sorted_plain`; CUDA tensors launch the
    kernel (``D`` up to 3; keys outside ``[0, n_cells)`` are dropped) or
    raise."""
    _check(keys, rel, mass, n_cells)
    if os.environ.get("MPI_GRID_SEGDEP_DEBUG") == "1":
        _raise_on_decreasing_valid_keys(keys, n_cells)
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
    n_tiles, carry_floats = geometry(n, d)
    tile_meta = torch.empty((n_tiles, 2), dtype=torch.int32,
                            device=keys.device)
    tile_sums = torch.empty((n_tiles, carry_floats), dtype=torch.float32,
                            device=keys.device)
    vmax = np.asarray([b - 1 for b in vblock], np.float32)
    KERNEL.launch(
        keys.data_ptr(), rel.data_ptr(),
        None if mass is None else mass.data_ptr(), out.data_ptr(),
        tile_meta.data_ptr(), tile_sums.data_ptr(), n, int(n_cells), d,
        vmax.ctypes.data, n_tiles, _build.stream_ptr(keys),
    )
    return out
