"""The yardstick's counts: the chips' peaks and the bytes and operations of
each kernel a launch, frozen here from the shape formulas of the
program's ``ops/driftbin``, ``ops/overlay`` and ``ops/dfscan``
``kernel_cost`` (each input byte read once, each output byte written
once), and the launch shapes the loop gives them in a cell; and the
bytes any implementation of the one-shot call has to move.
"""

from __future__ import annotations

import math

from benchmark.spec import Cell

# published peaks: NVIDIA's H100 SXM data sheet (HBM3 bandwidth; float32
# outside the tensor cores), at the full 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "flops_per_s": 67e12},
}
ROW_BYTES = 4 * (2 * 3 + 1)  # pos 3 + vel 3 + alive 1, 4-byte words
K_ROWS = 2 * 3 + 1  # the fused state's rows


def driftbin_cost(m: int, D: int = 3):
    """Kernel 1 over ``m`` columns: ``2D + 1`` words read and ``D + 1``
    written a column; 22 flops a column and axis."""
    return m * 4 * ((2 * D + 1) + (D + 1)), m * D * 22


def overlay_cost(targets: int, n_ok: int, K: int = K_ROWS):
    """Kernel 2: ``targets`` int32 targets read, ``K`` words of each of
    the ``n_ok`` in-range targets read and written; no flops."""
    return 4 * targets + 2 * 4 * K * n_ok, 0


def dfscan_cost(rows: int, tile: int):
    """Kernel 5 on ``[rows, tile]``: 4 bytes read and 8 written an
    element; ``ceil(log2(tile))`` double-float adds of 11 operations, 2
    flops each, an element."""
    n = rows * tile
    return 12 * n, 2 * 11 * (tile - 1).bit_length() * n


ONESHOT_ROW_BYTES = 4 * (3 + 3)  # a one-shot row: position 3 + velocity 3


def redistribute_floor_bytes(live_rows: int) -> int:
    """The least bytes a one-shot call over ``live_rows`` live rows moves,
    whatever implements it: each row's 24 bytes read once and written
    once. No flops."""
    return 2 * ONESHOT_ROW_BYTES * live_rows


def bound_s(nbytes: float, flops: float, kind: str):
    """Least seconds the chip ``kind`` needs for the work, or ``None``
    where the table has no peaks for it."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return max(nbytes / peak["bytes_per_s"], flops / peak["flops_per_s"])


def card_columns(cell: Cell) -> int:
    """Slots a card holds: the columns kernel 1 and the deposit sweep."""
    return cell.V * cell.n_local


def overlay_targets(cell: Cell) -> int:
    """Targets of kernel 2 a step: ``V`` plans of ``P`` entries. On one
    card ``P`` is the mover block, the local budget (the fast and the
    dense step alike); across cards the local budget plus ``C`` slots for
    each vrank of the other cards."""
    P = cell.budget + (cell.chips - 1) * cell.V * cell.capacity
    return cell.V * P


def dfscan_launches(cell: Cell):
    """``(launches a deposit, rows, tile)`` of kernel 5 in the scan
    deposit: 256-row tiles over all of a card's slots, the 8 corner
    channels two at a time above 2^24 slots, else all at once."""
    tile = 256
    m = card_columns(cell)
    n_pad = math.ceil(m / tile) * tile
    group = 2 if m > (1 << 24) else 8
    return 8 // group, group * n_pad // tile, tile
