"""The scan deposit's tile carries: the double-float prefix over the tiles'
totals.

Kernel 5 (``ops/dfscan``) leaves the within-tile prefixes of ``g`` corner
channels as one ``[2 g, n_pad]`` pack, hi rows above lo rows, ``n_pad //
tile`` tiles a row. The deposit then needs each tile's exclusive prefix
of the tiles before it: the inclusive double-float prefix (``_df_cumsum``,
Hillis-Steele doubling, the reference's order of operations) over the last
element of each tile, hi and lo carried together, with a zero column in
front, ``[2 g, T + 1]``. :func:`tile_carries_plain` is that, in PyTorch:
~14 launches a doubling step, ~250 a channel group at the CIC cell's
262,144 tiles, each too small to fill the card.

On the card :func:`tile_carries` is one C entry of ``csrc/tilecarry.cu``:
:func:`launches` launches of one kernel, each running up to ten doubling
steps in shared memory (two launches at 262,144 tiles), bit-equal to the
plain version: the same adds in the same order, the shifted-in zeros
included. The CPU runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from mpi_grid_redistribute_tpu_torch.ops import _build
from mpi_grid_redistribute_tpu_torch.ops.dfscan import _df_cumsum
from mpi_grid_redistribute_tpu_torch.utils.costcount import kernel_scope

STEPS = 10  # TC_STEPS in csrc/tilecarry.cu: the doubling steps a launch
THREADS = 1024  # TC_THREADS: a block's threads
MAX_GROUP = 65535  # a grid's y extent: the channels of one call

_PTR = ctypes.c_void_p
KERNEL = _build.register(_build.Kernel(
    "tile_carries", "tilecarry.cu", "tilecarry_launch",
    [_PTR, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
     ctypes.c_longlong, _PTR, _PTR, _PTR],
))


def _steps(T: int) -> int:
    """The doubling steps over ``T`` elements: the shifts 1, 2, 4, ...
    below ``T``."""
    return (T - 1).bit_length()


def launches(T: int) -> int:
    """The kernel's launches in one call over ``T`` tiles: ten doubling
    steps each, ``ceil(ceil(log2(T)) / 10)`` and at least one."""
    return max(1, -(-_steps(T) // STEPS))


def kernel_cost(l_pack, tile: int, _out=None):
    """``(bytes, flops)`` of one call: the tiles' last elements, hi and
    lo, read once and the ``[2 g, T + 1]`` result written once; a
    double-float add (11 adds, each an FMA's issue slot, 2 flops) an
    element and step."""
    rows, n_pad = l_pack.shape
    T = n_pad // tile
    g = rows // 2
    return 4 * rows * T + 4 * rows * (T + 1), 2 * 11 * _steps(T) * g * T


@kernel_scope("tile_carries", kernel_cost)
def tile_carries_plain(l_pack: torch.Tensor, tile: int):
    """Plain PyTorch version of :func:`tile_carries`: ``_df_cumsum`` over
    the tiles' last elements (hi rows, with the lo rows as their lo
    words), then a zero column in front of each channel's hi and lo."""
    rows, n_pad = l_pack.shape
    g = rows // 2
    tiles = l_pack.view(rows, n_pad // tile, tile)
    thi, tlo = _df_cumsum(tiles[:g, :, -1], axis=1, x_lo=tiles[g:, :, -1])
    zg = torch.zeros((g, 1), dtype=torch.float32, device=l_pack.device)
    return torch.cat([torch.cat([zg, thi], dim=1),
                      torch.cat([zg, tlo], dim=1)], dim=0)


def launch_functions(l_pack, tile: int):
    """``[(function, threads a block, dynamic shared bytes)]`` of what one
    call launches (``analysis.kernelcheck``'s K003): :func:`launches` of
    the one kernel, its shared memory static."""
    return [("tile_carry_kernel", THREADS, 0)]


@kernel_scope("tile_carries", kernel_cost)
def tile_carries(l_pack: torch.Tensor, tile: int, _out=None):
    """The exclusive double-float prefixes of the tiles of ``l_pack [2 g,
    n_pad]`` float32 (within-tile prefixes of ``g`` channels, hi rows
    above lo rows, ``n_pad`` a multiple of ``tile``): ``[2 g, n_pad //
    tile + 1]``, column 0 zero and column ``t + 1`` the inclusive prefix
    of the tiles' last elements up to tile ``t``, hi rows above lo rows.
    CPU tensors run :func:`tile_carries_plain`; CUDA tensors one call of
    ``csrc/tilecarry.cu``, bit-equal to it. ``_out`` (internal) is the
    result written to."""
    what = "tile_carries"
    if l_pack.dtype != torch.float32 or l_pack.dim() != 2:
        raise TypeError(f"{what} takes float32 [2 g, n_pad], got "
                        f"{l_pack.dtype} {tuple(l_pack.shape)}")
    rows, n_pad = l_pack.shape
    if rows < 2 or rows % 2 or rows // 2 > MAX_GROUP:
        raise ValueError(f"{what}: {rows} rows are not the hi and lo rows "
                         f"of 1 to {MAX_GROUP} channels")
    if tile < 1 or n_pad < tile or n_pad % tile:
        raise ValueError(f"{what}: {n_pad} columns are not whole tiles of "
                         f"{tile}")
    if l_pack.device.type == "cpu":
        return _build.into(_out, tile_carries_plain(l_pack, tile), what)
    if l_pack.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {l_pack.device}")
    if l_pack.stride(1) != 1:
        l_pack = l_pack.contiguous()
    T = n_pad // tile
    out = _build.out_tensor(_out, (rows, T + 1), torch.float32, l_pack, what)
    temp = torch.empty((rows, T) if launches(T) > 1 else (1,),
                       dtype=torch.float32, device=l_pack.device)
    KERNEL.launch(l_pack.data_ptr(), l_pack.stride(0), n_pad, rows // 2,
                  tile, temp.data_ptr(), out.data_ptr(),
                  _build.stream_ptr(l_pack))
    return out
