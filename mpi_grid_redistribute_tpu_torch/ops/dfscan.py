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
it is also the plain version of the level-2 scan over the tiles' totals,
which runs on the card as ``ops/tilecarry`` (``csrc/tilecarry.cu``).

The scan deposit calls the kernel through :func:`cic_tile_prefix_rows`:
from the sorted 16-byte rows that ``ops.rowsort.sort_keyed_rows`` leaves
(block-local coordinates, then mass) to one ``[2 g, n_pad]`` pack of the
within-tile prefixes of ``g`` corner channels, hi words above lo words.
On the card, for a tile of the register route and D of 1 to 3, that is
one launch of the fused route (``csrc/dfscan.cu``'s
``dfscan_kernel_cic_rows``), which loads a row a particle, computes the
base cells, fractions and corner weights in its load and writes the pack
itself. Otherwise, and from the planar payload ``[D + 1, n]``
(:func:`cic_tile_prefix`), the plain stages compute them in PyTorch
around :func:`tile_df_cumsum_rows` (:func:`cic_tile_prefix_plain` around
its plain version). :data:`ROUTES` counts the launches of each route.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import NamedTuple

import torch

from mpi_grid_redistribute_tpu_torch.ops import _build, binning, rowsort
from mpi_grid_redistribute_tpu_torch.utils.costcount import kernel_scope

MAX_TILE = 1024  # DFSCAN_MAX_TILE in csrc/dfscan.cu: the register route
# DFSCAN_MAX_BLOCK_TILE: the block route's two (hi, lo) buffers, 16 bytes
# an element, in one block's 232,448 bytes of shared memory
MAX_BLOCK_TILE = 232448 // 16

CIC_MAX_DIMS = 3  # DFSCAN_CIC_DIMS: the fused route's D = 1..3

KERNEL = _build.register(_build.Kernel(
    "tile_df_cumsum_rows", "dfscan.cu", "dfscan_launch",
    [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ],
    entries={"dfscan_cic_rows_launch": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]},
    routes=("rows", "packed"),
))
# launches by route: "rows" (x [rows, tile]) and "packed" (the fused route
# on the sorted rows of ops/rowsort); _build.reset_counts() zeroes them
ROUTES = KERNEL.routes


class Geometry(NamedTuple):
    """How a row of ``tile`` elements is scanned on the card. ``route``:
    ``"warp"`` (the register route, ``regs`` elements a lane and
    ``rows_per_warp`` rows a warp), ``"block"`` (a block per row in
    shared memory; ``regs = rows_per_warp = 0``) or ``"plain"`` (the
    plain version: the row does not fit one block's shared memory); and
    from :func:`cic_geometry`, ``"cic"`` (the fused route, with the
    register route's fields)."""

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


def cic_geometry(tile: int, D: int) -> Geometry:
    """The shape rule of :func:`cic_tile_prefix_rows` on the card: route
    ``"cic"`` (the fused launch) for a tile of the register route and D
    of 1 to :data:`CIC_MAX_DIMS`, with :func:`geometry`'s rows a warp and
    its registers rounded up to a power of two (the instances the source
    holds); otherwise :func:`geometry`'s own route, which the plain
    stages take around :func:`tile_df_cumsum_rows`."""
    geo = geometry(tile)
    if geo.route != "warp" or not 1 <= D <= CIC_MAX_DIMS:
        return geo
    return Geometry("cic", 1 << (geo.regs - 1).bit_length(),
                    geo.rows_per_warp)


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
        geo.rows_per_warp, _build.stream_ptr(x), route="rows",
    )
    return hi, lo


def cic_frac(rel_s: torch.Tensor, local_shape) -> torch.Tensor:
    """The CIC fractions ``[D, n]`` of block-local coordinates ``rel_s
    [D, n]``: ``clamp(rel - float(base cell), 0, 1)`` on each axis."""
    D = rel_s.shape[0]
    i0_s = torch.stack(
        [binning.base_cell(rel_s[d], local_shape[d]) for d in range(D)],
        dim=0
    )
    return (rel_s - i0_s.to(torch.float32)).clamp(0.0, 1.0)


def _cic_stages(payload_s, local_shape, c0: int, g: int, tile: int, scan):
    """The plain stages of :func:`cic_tile_prefix`: fractions, the corner
    weight rows, the pad to whole tiles, ``scan`` on ``[g * T, tile]`` and
    the pack of its hi and lo."""
    D, n = payload_s.shape[0] - 1, payload_s.shape[1]
    frac = cic_frac(payload_s[:D], local_shape)
    mass_s = payload_s[D]
    n_pad = -(-n // tile) * tile
    # corner-weight rows [g, n] in sorted order: mass * ((f0 * f1) * f2),
    # the explicit left fold the reference pins
    rows = []
    for corner in list(itertools.product((0, 1), repeat=D))[c0:c0 + g]:
        w = None
        for d in range(D):
            t = frac[d] if corner[d] == 1 else 1.0 - frac[d]
            w = t if w is None else w * t
        rows.append(mass_s * w)
    wg = torch.stack(rows, dim=0)
    wt = torch.nn.functional.pad(wg, (0, n_pad - n))
    lhi, llo = scan(wt.reshape(g * n_pad // tile, tile))
    return torch.cat([lhi.reshape(g, n_pad), llo.reshape(g, n_pad)], dim=0)


def cic_kernel_cost(payload_s, local_shape, c0, g, tile, _out=None):
    """``(bytes, flops)`` of one :func:`cic_tile_prefix` call, counted as
    one pass would do it: the payload read once (``4 (D + 1)`` bytes a
    row, whatever ``g`` is) and the pack written once (hi and lo, 8 bytes
    an element of each channel, the pad included); a double-float add of
    11 operations a doubling step, and ``2 D`` operations of the weight
    (its D products and at most D subtracts), an element, each taking an
    FMA's issue slot (2 flops)."""
    d1, n = payload_s.shape
    elems = g * -(-n // tile) * tile
    return (4 * d1 * n + 8 * elems,
            2 * (11 * (tile - 1).bit_length() + 2 * (d1 - 1)) * elems)


def cic_rows_kernel_cost(rows_s, local_shape, c0, g, tile, _out=None):
    """``(bytes, flops)`` of one :func:`cic_tile_prefix_rows` call, the
    fused route's real traffic: :func:`cic_kernel_cost` with a 16-byte row
    read once a particle, whatever ``D`` is."""
    n, D = rows_s.shape[0], len(local_shape)
    elems = g * -(-n // tile) * tile
    return (16 * n + 8 * elems,
            2 * (11 * (tile - 1).bit_length() + 2 * D) * elems)


@kernel_scope("tile_df_cumsum_rows", cic_kernel_cost)
def cic_tile_prefix_plain(payload_s: torch.Tensor, local_shape, c0: int,
                          g: int, tile: int):
    """Plain PyTorch version of :func:`cic_tile_prefix`: the scan
    deposit's stages as they are written in the reference, around
    :func:`tile_df_cumsum_rows_plain`."""
    return _cic_stages(payload_s, local_shape, c0, g, tile,
                       tile_df_cumsum_rows_plain)


@kernel_scope("tile_df_cumsum_rows", cic_kernel_cost)
def cic_tile_prefix(payload_s: torch.Tensor, local_shape, c0: int, g: int,
                    tile: int, _out=None):
    """Within-tile double-float prefixes of the scan deposit's corner
    channels ``c0 .. c0 + g - 1`` (of ``2^D``, in
    ``itertools.product((0, 1), repeat=D)`` order) from the sorted
    ``payload_s [D + 1, n]`` float32 (block-local coordinates on an axis
    of ``local_shape[d]`` cells, then the mass): the weights ``mass *
    ((t0 * t1) * t2)`` with ``t`` the fraction or one less it, zero-padded
    to ``n_pad = ceil(n / tile) * tile`` and scanned tile by tile. Returns
    the pack ``[2 g, n_pad]``: row ``j`` the hi words of channel ``c0 +
    j``, row ``g + j`` its lo words. The plain stages around
    :func:`tile_df_cumsum_rows` (its plain version on the CPU); the fused
    launch reads the sorted rows (:func:`cic_tile_prefix_rows`).
    ``_out`` (internal) is the pack written to."""
    if payload_s.dtype != torch.float32 or payload_s.dim() != 2:
        raise TypeError(
            f"cic_tile_prefix takes float32 [D + 1, n], got "
            f"{payload_s.dtype} {tuple(payload_s.shape)}")
    D = payload_s.shape[0] - 1
    if (D < 1 or len(local_shape) != D or tile < 1 or g < 1 or c0 < 0
            or c0 + g > 1 << D):
        raise ValueError(
            f"cic_tile_prefix: channels {c0}..{c0 + g - 1} of D = {D}, "
            f"local_shape {tuple(local_shape)}, tile {tile}")
    return _build.into(_out, _cic_stages(
        payload_s, local_shape, c0, g, tile, tile_df_cumsum_rows),
        "cic_tile_prefix")


@kernel_scope("tile_df_cumsum_rows", cic_rows_kernel_cost)
def cic_tile_prefix_rows(rows_s: torch.Tensor, local_shape, c0: int, g: int,
                         tile: int, _out=None):
    """:func:`cic_tile_prefix` on the sorted rows ``rows_s [n, 4]``
    float32 of ``ops.rowsort.sort_keyed_rows`` (row ``i``: particle
    ``i``'s ``D = len(local_shape)`` block-local coordinates, then its
    mass): the same pack, bit for bit, as from the planar payload those
    rows hold. CUDA tensors take one launch of the fused route, which
    loads a 16-byte row a particle (route ``"packed"``), for the tiles
    :func:`cic_geometry` sends to it; CPU tensors and other tiles run
    :func:`cic_tile_prefix` on that payload."""
    D = len(local_shape)
    if (rows_s.dtype != torch.float32 or rows_s.dim() != 2
            or rows_s.shape[1] != rowsort.ROW_FLOATS):
        raise TypeError(
            f"cic_tile_prefix_rows takes float32 [n, "
            f"{rowsort.ROW_FLOATS}], got {rows_s.dtype} "
            f"{tuple(rows_s.shape)}")
    if not 1 <= D <= CIC_MAX_DIMS:
        raise ValueError(
            f"cic_tile_prefix_rows: local_shape {tuple(local_shape)} has "
            f"D = {D}, not 1 to {CIC_MAX_DIMS}")
    geo = cic_geometry(tile, D)
    if rows_s.device.type != "cuda" or geo.route != "cic":
        return cic_tile_prefix(rowsort.rows_as_payload(rows_s, D),
                               local_shape, c0, g, tile, _out=_out)
    if g < 1 or c0 < 0 or c0 + g > 1 << D:
        raise ValueError(
            f"cic_tile_prefix_rows: channels {c0}..{c0 + g - 1} of D = {D}")
    if not rows_s.is_contiguous() or rows_s.data_ptr() % 16:
        raise ValueError(
            "cic_tile_prefix_rows: rows_s must be contiguous and 16-byte "
            "aligned")
    n = rows_s.shape[0]
    tiles = -(-n // tile)
    pack = _build.out_tensor(_out, (2 * g, tiles * tile), torch.float32,
                             rows_s, "cic_tile_prefix_rows")
    if n == 0:
        return pack
    cells = [int(c) for c in local_shape] + [1] * (CIC_MAX_DIMS - D)
    KERNEL.launch(
        rows_s.data_ptr(), n, pack.data_ptr(), tiles, tile, geo.regs,
        geo.rows_per_warp, D, c0, g, *cells, _build.stream_ptr(rows_s),
        entry="dfscan_cic_rows_launch", route="packed",
    )
    return pack
