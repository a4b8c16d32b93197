"""Stable key-value radix sort of the scan deposit's payload rows.

The scan deposit sorts its particles by segment key and reads their
block-local coordinates and mass in that order (``ops/deposit``'s
``dep:sort`` phase). The reference does it with ``lax.sort((key, iota,
payload...), num_keys=2)``; the port's plain version is a stable
``torch.sort`` of the key and one ``index_select`` of the payload by the
permutation (:func:`sort_rows_plain`). On the card that gather reads the
planar payload at random columns, a 32-byte sector for every 4-byte word.

:func:`sort_rows` makes the payload travel with its key instead
(``csrc/rowsort.cu``): one pass packs each particle's payload into a
16-byte row (the ``D`` coordinates, then the mass, zero lanes above it
when ``D < 3``; :func:`pack_rows_plain`) beside a copy of its key, and
cub's ``DeviceRadixSort::SortPairs`` sorts the keys with the rows as
values over the key's own ``bits`` low bits only (``bits =
n_segments.bit_length()``: the keys lie in ``[0, n_segments]``). An LSD
radix sort is stable, so the sorted keys and rows are bit-equal to the
plain version's. Kernel 5 reads the sorted rows as they are
(``ops.dfscan.cic_tile_prefix_rows``). Both buffers of each pair and
cub's temporary storage come from PyTorch's allocator.

One launch a call (:data:`KERNEL`'s count): the pack and the sort's
passes are one C entry.
"""

from __future__ import annotations

import ctypes

import torch

from mpi_grid_redistribute_tpu_torch.ops import _build
from mpi_grid_redistribute_tpu_torch.utils.costcount import kernel_scope

MAX_DIMS = 3  # ROWSORT_MAX_DIMS in csrc/rowsort.cu: D + 1 <= 4 lanes
MAX_ROWS = 2**31 - 1  # cub's int item count
ROW_FLOATS = 4  # a row is 16 bytes

KERNEL = _build.register(_build.Kernel(
    "sort_rows", "rowsort.cu", "rowsort_launch",
    [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ],
    entries={"rowsort_temp_bytes": [
        ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong),
    ]},
))


def _check(key, rel_rows, mass, bits: int) -> None:
    if key.dtype != torch.int32 or key.dim() != 1:
        raise TypeError(f"sort_rows: key must be int32 [n], got {key.dtype} "
                        f"{tuple(key.shape)}")
    n = key.shape[0]
    if (rel_rows.dtype != torch.float32 or rel_rows.dim() != 2
            or rel_rows.shape[1] != n
            or not 1 <= rel_rows.shape[0] <= MAX_DIMS):
        raise TypeError(
            f"sort_rows: rel_rows must be float32 [D, {n}] with D of 1 to "
            f"{MAX_DIMS}, got {rel_rows.dtype} {tuple(rel_rows.shape)}")
    if mass.dtype != torch.float32 or tuple(mass.shape) != (n,):
        raise TypeError(f"sort_rows: mass must be float32 [{n}], got "
                        f"{mass.dtype} {tuple(mass.shape)}")
    if not 1 <= bits <= 32:
        raise ValueError(f"sort_rows: bits {bits} not in 1..32")


def pack_rows_plain(rel_rows: torch.Tensor, mass: torch.Tensor):
    """The payload as rows ``[n, 4]`` float32: ``rel_rows [D, n]``'s
    columns, then ``mass [n]``, the lanes above it zero."""
    D, n = rel_rows.shape
    rows = torch.zeros((n, ROW_FLOATS), dtype=torch.float32,
                       device=rel_rows.device)
    rows[:, :D] = rel_rows.t()
    rows[:, D] = mass
    return rows


def rows_as_payload(rows: torch.Tensor, D: int) -> torch.Tensor:
    """The planar payload ``[D + 1, n]`` (coordinates, then mass) that
    rows ``[n, 4]`` hold, as a view."""
    return rows[:, :D + 1].t()


def kernel_cost(key, rel_rows, mass, bits, _out=None):
    """``(bytes, flops)`` of one call: the key and the planar payload read
    once, the sorted key and its 16-byte row written once; no flops."""
    D, n = rel_rows.shape
    return n * (4 + 4 * (D + 1)) + n * (4 + 4 * ROW_FLOATS), 0


@kernel_scope("sort_rows", kernel_cost)
def sort_rows_plain(key, rel_rows, mass, bits: int):
    """Plain PyTorch version of :func:`sort_rows`: a stable
    ``torch.sort`` of the key and one ``index_select`` of the packed
    rows by its permutation (``bits`` unused)."""
    keys_s, order = torch.sort(key, stable=True)
    return keys_s, torch.index_select(pack_rows_plain(rel_rows, mass), 0,
                                      order)


def temp_bytes(n: int, bits: int) -> int:
    """cub's temporary bytes for ``n`` rows over ``bits`` key bits."""
    out = ctypes.c_ulonglong(0)
    KERNEL.call(n, bits, ctypes.byref(out), entry="rowsort_temp_bytes")
    return int(out.value)


def launch_functions(key, rel_rows):
    """``[(function, threads a block, dynamic shared bytes)]`` of the pack
    that one call launches (``analysis.kernelcheck``'s K003). cub's sort
    kernels launch at block sizes of cub's choosing; ``KERNEL
    .resource_usage()`` lists their footprint beside the pack's."""
    return [(f"rowsort_pack_kernel<{rel_rows.shape[0]}>", 256, 0)]


@kernel_scope("sort_rows", kernel_cost)
def sort_rows(key: torch.Tensor, rel_rows: torch.Tensor, mass: torch.Tensor,
              bits: int, _out=None):
    """Stable sort of ``key [n]`` int32, each in ``[0, 2^bits)``, carrying
    its payload: ``rel_rows [D, n]`` block-local coordinates (D of 1 to
    :data:`MAX_DIMS`) and ``mass [n]``, float32. Returns ``(keys_s [n]
    int32, rows_s [n, 4] float32)``, each row the particle's coordinates,
    then its mass, then zeros, in sorted order; equal keys keep their
    input order. CPU tensors run :func:`sort_rows_plain`; CUDA tensors
    one launch of ``csrc/rowsort.cu``. ``_out`` (internal) is the
    ``(keys_s, rows_s)`` pair written to."""
    _check(key, rel_rows, mass, bits)
    if key.device.type == "cpu":
        keys_s, rows_s = sort_rows_plain(key, rel_rows, mass, bits)
        if _out is None:
            return keys_s, rows_s
        return (_build.into(_out[0], keys_s, "sort_rows"),
                _build.into(_out[1], rows_s, "sort_rows"))
    if key.device.type != "cuda":
        raise ValueError(f"sort_rows: unsupported device {key.device}")
    if not (key.is_contiguous() and rel_rows.is_contiguous()
            and mass.is_contiguous()):
        raise ValueError("sort_rows: key, rel_rows and mass must be "
                         "contiguous")
    D, n = rel_rows.shape
    if n > MAX_ROWS:
        raise ValueError(f"sort_rows: {n} rows exceed {MAX_ROWS}")
    keys_b, rows_b = (
        _build.out_tensor(o, shape, dt, key, "sort_rows")
        for o, shape, dt in zip(_out or (None, None),
                                ((n,), (n, ROW_FLOATS)),
                                (torch.int32, torch.float32)))
    if n == 0:
        return keys_b, rows_b
    keys_a = torch.empty_like(keys_b)
    rows_a = torch.empty_like(rows_b)
    nbytes = temp_bytes(n, bits)
    temp = torch.empty((max(nbytes, 1),), dtype=torch.uint8,
                       device=key.device)
    selector = ctypes.c_int(-1)
    KERNEL.launch(
        key.data_ptr(), rel_rows.data_ptr(), mass.data_ptr(), D, n, bits,
        keys_a.data_ptr(), keys_b.data_ptr(), rows_a.data_ptr(),
        rows_b.data_ptr(), temp.data_ptr(), nbytes, ctypes.byref(selector),
        _build.stream_ptr(key),
    )
    if selector.value == 1:
        return keys_b, rows_b
    if _out is None:
        return keys_a, rows_a
    return keys_b.copy_(keys_a), rows_b.copy_(rows_a)
