"""Stable key-value radix sort of the scan deposit's payload rows, with
the segment keys computed in its pack.

The scan deposit sorts its particles by segment key and reads their
block-local coordinates and mass in that order (``ops/deposit``'s
``dep:keys`` and ``dep:sort`` phases). The reference computes the keys
elementwise and sorts with ``lax.sort((key, iota, payload...),
num_keys=2)``; the port's plain version is the same keys phase
(:func:`slab_keys_plain`, the one copy of that chain, which the deposit's
planar route runs too), then a stable ``torch.sort`` of the key and one
``index_select`` of the payload, packed as rows, by the permutation
(:func:`sort_rows_plain`): :func:`sort_keyed_rows_plain`. The CPU runs it.

On the card :func:`sort_keyed_rows` is one launch of ``csrc/rowsort.cu``:
a pack computes each slot's block-local coordinates, base cell and
segment key from the slabs' positions, ``valid`` and mass, in the
arithmetic of the plain keys phase, and writes the key beside a 16-byte
row (the ``D`` coordinates, then the mass, zero lanes above it when ``D <
3``; :func:`pack_rows_plain`): 4 D + 5 bytes a slot read and 20 written
(37 at D = 3), where the plain chain makes ~40 elementwise passes over
every slot. cub's ``DeviceRadixSort::SortPairs`` then sorts the keys with
the rows as values over the key's own low bits only
(:func:`keyed_bits`: the keys lie in ``[0, V * prod(vblock)]``). An LSD
radix sort is stable, so the sorted keys and rows are bit-equal to the
plain version's. Kernel 5 reads the sorted rows as they are
(``ops.dfscan.cic_tile_prefix_rows``). Both buffers of each pair and
cub's temporary storage come from PyTorch's allocator.

One launch a call (:data:`KERNEL`'s count, ``sort_rows`` in
``_build.counts()``): the pack and the sort's passes are one C entry.
:data:`ROUTES` counts them under ``"keyed"``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mpi_grid_redistribute_tpu_torch.ops import _build, binning
from mpi_grid_redistribute_tpu_torch.utils.costcount import kernel_scope

MAX_DIMS = 3  # ROWSORT_MAX_DIMS in csrc/rowsort.cu: D + 1 <= 4 lanes
MAX_ROWS = 2**31 - 1  # cub's int item count
ROW_FLOATS = 4  # a row is 16 bytes

_PTR = ctypes.c_void_p
KERNEL = _build.register(_build.Kernel(
    "sort_rows", "rowsort.cu", "rowsort_keys_launch",
    [
        _PTR, ctypes.c_longlong, _PTR, _PTR, _PTR, _PTR, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, _PTR, _PTR, _PTR, _PTR, _PTR, ctypes.c_ulonglong,
        ctypes.POINTER(ctypes.c_int), _PTR,
    ],
    entries={"rowsort_temp_bytes": [
        ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong),
    ]},
    routes=("keyed",),
))
# the keyed pack's launches (sort_keyed_rows); _build.reset_counts()
# zeroes them
ROUTES = KERNEL.routes


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


def sort_rows_plain(key, rel_rows, mass):
    """The plain payload sort: a stable ``torch.sort`` of ``key [n]`` and
    one ``index_select`` of the packed rows (:func:`pack_rows_plain` of
    ``rel_rows [D, n]`` and ``mass [n]``) by its permutation. Returns
    ``(keys_s [n] int32, rows_s [n, 4] float32)``; equal keys keep their
    input order."""
    keys_s, order = torch.sort(key, stable=True)
    return keys_s, torch.index_select(pack_rows_plain(rel_rows, mass), 0,
                                      order)


def temp_bytes(n: int, bits: int) -> int:
    """cub's temporary bytes for ``n`` rows over ``bits`` key bits."""
    out = ctypes.c_ulonglong(0)
    KERNEL.call(n, bits, ctypes.byref(out), entry="rowsort_temp_bytes")
    return int(out.value)


def slab_keys_plain(pos_rows, valid, mass, lo_local, inv_h, vblock):
    """The scan deposit's keys phase in plain PyTorch (the reference's
    arithmetic): ``pos_rows [D, V * n]`` (vrank ``v`` owns columns
    ``[v*n, (v+1)*n)``), ``valid``/``mass`` ``[V * n]``, ``lo_local [V,
    D]`` and ``inv_h [D]``. Per axis ``r = (p - lo[v]) * inv_h``, zero on
    invalid slots, and the base cell summed with the block's row-major
    strides. Returns ``(key [V * n] int32, rel_rows [D, V * n], mass_z [V
    * n])``: the key ``v * prod(vblock) + cell``, the sentinel ``V *
    prod(vblock)`` on invalid slots; the mass, zero on invalid slots."""
    D, m = pos_rows.shape
    V = lo_local.shape[0]
    n = m // V
    n_cells = math.prod(vblock)
    valid2 = valid.reshape(V, n)
    rel = []
    cell = torch.zeros((V, n), dtype=torch.int32, device=pos_rows.device)
    for d in range(D):
        r = (pos_rows[d].reshape(V, n) - lo_local[:, d, None]) * inv_h[d]
        r = torch.where(valid2, r, 0.0)
        cell = cell + binning.base_cell(r, vblock[d]) * math.prod(
            vblock[d + 1:])
        rel.append(r.reshape(m))
    v_ids = torch.arange(V, dtype=torch.int32, device=pos_rows.device)
    key = torch.where(valid2, v_ids[:, None] * n_cells + cell,
                      V * n_cells).to(torch.int32)
    return (key.reshape(m), torch.stack(rel, dim=0),
            torch.where(valid, mass, 0.0))


def keyed_bits(lo_local, vblock) -> int:
    """The key bits of a keyed sort: the sentinel ``V * prod(vblock)``'s
    bit length."""
    return (lo_local.shape[0] * math.prod(vblock)).bit_length()


def kernel_cost(pos_rows, valid, mass, lo_local, inv_h, vblock,
                      _out=None):
    """``(bytes, flops)`` of one :func:`sort_keyed_rows` call: the
    positions, ``valid``, the mass, ``lo_local`` and ``inv_h`` read once,
    the sorted key and its 16-byte row written once (37 bytes a slot at D
    = 3); a subtract and a multiply a coordinate."""
    D, m = pos_rows.shape
    read = m * (4 * D + 1 + 4) + 4 * lo_local.numel() + 4 * inv_h.numel()
    return read + m * (4 + 4 * ROW_FLOATS), 2 * D * m


@kernel_scope("sort_rows", kernel_cost)
def sort_keyed_rows_plain(pos_rows, valid, mass, lo_local, inv_h, vblock):
    """Plain PyTorch version of :func:`sort_keyed_rows`:
    :func:`slab_keys_plain`, then :func:`sort_rows_plain`."""
    return sort_rows_plain(*slab_keys_plain(pos_rows, valid, mass, lo_local,
                                            inv_h, vblock))


def launch_functions(pos_rows):
    """``[(function, threads a block, dynamic shared bytes)]`` of the keyed
    pack that one :func:`sort_keyed_rows` call launches (K003)."""
    return [(f"rowsort_keys_kernel<{pos_rows.shape[0]}>", 256, 0)]


def _check(pos_rows, valid, mass, lo_local, inv_h, vblock) -> None:
    what = "sort_keyed_rows"
    if (pos_rows.dtype != torch.float32 or pos_rows.dim() != 2
            or not 1 <= pos_rows.shape[0] <= MAX_DIMS):
        raise TypeError(
            f"{what}: pos_rows must be float32 [D, m] with D of 1 to "
            f"{MAX_DIMS}, got {pos_rows.dtype} {tuple(pos_rows.shape)}")
    D, m = pos_rows.shape
    if (lo_local.dtype != torch.float32 or lo_local.dim() != 2
            or lo_local.shape[1] != D or lo_local.shape[0] < 1
            or m % lo_local.shape[0]):
        raise TypeError(
            f"{what}: lo_local must be float32 [V, {D}] with V dividing "
            f"{m}, got {lo_local.dtype} {tuple(lo_local.shape)}")
    for name, t, dt, shape in (("valid", valid, torch.bool, (m,)),
                               ("mass", mass, torch.float32, (m,)),
                               ("inv_h", inv_h, torch.float32, (D,))):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise TypeError(f"{what}: {name} must be {dt} {list(shape)}, "
                            f"got {t.dtype} {tuple(t.shape)}")
    if len(vblock) != D or min(vblock) < 1:
        raise ValueError(f"{what}: vblock {tuple(vblock)} is not {D} cell "
                         f"counts")
    if lo_local.shape[0] * math.prod(vblock) > 2**31 - 1:
        raise ValueError(f"{what}: the sentinel V * prod(vblock) does not "
                         f"fit an int32 key")
    devices = {t.device for t in (pos_rows, valid, mass, lo_local, inv_h)}
    if len(devices) != 1:
        raise ValueError(f"{what}: inputs on several devices {devices}")


@kernel_scope("sort_rows", kernel_cost)
def sort_keyed_rows(pos_rows: torch.Tensor, valid: torch.Tensor,
                    mass: torch.Tensor, lo_local: torch.Tensor,
                    inv_h: torch.Tensor, vblock, _out=None):
    """The scan deposit's keys and payload sort in one call: the keys,
    block-local coordinates and masked mass of :func:`slab_keys_plain`,
    stably sorted by key over :func:`keyed_bits` bits, the payload
    moving with its key as 16-byte rows. ``pos_rows [D, V * n]`` float32
    (D of 1 to :data:`MAX_DIMS`; on the card its rows may be strided, and
    a copy is read where its columns are), ``valid [V * n]`` bool, ``mass
    [V * n]``, ``lo_local [V, D]`` and ``inv_h [D]`` float32, ``vblock`` a
    vrank's cells. Returns ``(keys_s [V * n] int32, rows_s [V * n, 4]
    float32)``, each row the particle's coordinates, then its mass, then
    zeros. CPU tensors run :func:`sort_keyed_rows_plain`; CUDA tensors
    one launch of ``csrc/rowsort.cu`` (route ``"keyed"``), bit-equal to
    it. ``_out`` (internal) is the ``(keys_s, rows_s)`` pair written
    to."""
    what = "sort_keyed_rows"
    _check(pos_rows, valid, mass, lo_local, inv_h, vblock)
    if pos_rows.device.type == "cpu":
        pair = sort_keyed_rows_plain(pos_rows, valid, mass, lo_local, inv_h,
                                     vblock)
        if _out is None:
            return pair
        return tuple(_build.into(o, t, what) for o, t in zip(_out, pair))
    if pos_rows.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {pos_rows.device}")
    if pos_rows.stride(1) != 1:
        pos_rows = pos_rows.contiguous()
    valid, mass, lo_local, inv_h = (
        t.contiguous() for t in (valid, mass, lo_local, inv_h))
    D, m = pos_rows.shape
    if m > MAX_ROWS:
        raise ValueError(f"{what}: {m} rows exceed {MAX_ROWS}")
    keys_b, rows_b = (
        _build.out_tensor(o, shape, dt, pos_rows, what)
        for o, shape, dt in zip(_out or (None, None),
                                ((m,), (m, ROW_FLOATS)),
                                (torch.int32, torch.float32)))
    if m == 0:
        return keys_b, rows_b
    keys_a = torch.empty_like(keys_b)
    rows_a = torch.empty_like(rows_b)
    V = lo_local.shape[0]
    bits = keyed_bits(lo_local, vblock)
    nbytes = temp_bytes(m, bits)
    temp = torch.empty((max(nbytes, 1),), dtype=torch.uint8,
                       device=pos_rows.device)
    selector = ctypes.c_int(-1)
    # the pack writes the a's; cub leaves the sorted pair in the a's or
    # the b's, as the selector says
    KERNEL.launch(pos_rows.data_ptr(), pos_rows.stride(0), valid.data_ptr(),
                  mass.data_ptr(), lo_local.data_ptr(), inv_h.data_ptr(), D,
                  (ctypes.c_int * D)(*vblock), V, m // V, bits,
                  keys_a.data_ptr(), keys_b.data_ptr(), rows_a.data_ptr(),
                  rows_b.data_ptr(), temp.data_ptr(), nbytes,
                  ctypes.byref(selector), _build.stream_ptr(pos_rows),
                  route="keyed")
    if selector.value == 1:
        return keys_b, rows_b
    if _out is None:
        return keys_a, rows_a
    return keys_b.copy_(keys_a), rows_b.copy_(rows_a)
