"""Span table of the port's planar scan deposit (the counterpart of the JAX
package's ``scripts/knockout_deposit.py``): config 5's deposit, whole and
uncut, its device time a deposit charged to the deposit's own spans.

The deposit is the one config 5's ``"scan"`` method runs
(``ops.deposit.shard_deposit_device_planar_fn``): device-cell keys onto a
128^3 mesh owned by one device (Dev = 1), every row of the ``V x n``
rows of ``KNOCKOUT_GRID``'s vranks, then the periodic self-fold of the
+1 ghost faces. The reference times a copy of its jitted deposit core
cut after each phase. The port reads the spans its deposit opens
(``telemetry.phases.attribute_phases``: ``STEPS`` deposits profiled once
after a warm call, each device operation charged to the innermost span
open at its launch); what the call launched outside them is the
``rest`` row, so the rows add up to the deposit.

Rows: ``dep:keys`` (block-local coordinates, cell keys, masked mass; on
the card none, as the payload sort's pack computes them), ``dep:sort``
(the payload sort: ``ops/rowsort.sort_keyed_rows`` on the card),
``dep:bounds``, ``dep:prefix`` (kernel 5's fused launches, a channel
group each, and the tile-total scan), ``dep:place`` (the boundary gathers
and differences, the corner channels' placement and the ghost fold),
``rest``.

    python -m mpi_grid_redistribute_tpu_torch.bench.knockout_deposit [n]
    KNOCKOUT_GRID=2,2,2 KNOCKOUT_JSON=rows.json \\
        python -m mpi_grid_redistribute_tpu_torch.bench.knockout_deposit

``KNOCKOUT_GRID`` defaults to the reference's 4,4,4 (64 x 2^20 = 67.1M
rows); ``--device cpu`` runs on the CPU (the host ops' time).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch import _device
from mpi_grid_redistribute_tpu_torch.bench.knockout_stages import cli
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops import deposit
from mpi_grid_redistribute_tpu_torch.telemetry import phases as phases_lib
from mpi_grid_redistribute_tpu_torch.utils import profiling

PHASES = ("dep:keys", "dep:sort", "dep:bounds", "dep:prefix", "dep:place")
FILL = 0.9
MESH_CELLS = 128
DEFAULT_GRID = "4,4,4"
STEPS = 2  # deposits of the profiled call


def make_state(grid_shape, n: int, device, seed: int = 0):
    """The reference knockout's rows: ``(pos_rows [3, V * n] uniform in
    [0, 1), mass [V * n] ones, valid [V * n] at FILL)`` on ``device``."""
    m = int(np.prod(grid_shape)) * n
    rng = np.random.default_rng(seed)
    pos = rng.random((3, m), np.float32)
    valid = rng.random(m) < FILL
    return (torch.from_numpy(pos).to(device),
            torch.ones((m,), dtype=torch.float32, device=device),
            torch.from_numpy(valid).to(device))


def make_loop(steps: int = STEPS, mesh_cells: int = MESH_CELLS,
              plain: bool = False):
    """``loop(pos_rows, mass, valid)``: ``steps`` of config 5's scan
    deposit and fold on one device, returning the last density. The
    deposit reads its inputs only."""
    full = deposit.shard_deposit_device_planar_fn(
        Domain(0.0, 1.0, periodic=True), ProcessGrid((1, 1, 1)),
        (mesh_cells,) * 3, plain=plain)

    def loop(pos_rows, mass, valid):
        out = None
        for _ in range(steps):
            out = full(pos_rows, mass, valid)
        return out

    return loop


def phase_bytes(m: int, n_cells: int):
    """Minimum logical traffic a deposit a row (the reference's
    convention: measured / roofline >> 1 flags a latency or
    serialization bound), in 4-byte words: ``m`` rows, ``n_cells`` mesh
    cells, 8 corner channels."""
    w = 4
    ghost = round(n_cells ** (1 / 3) + 1) ** 3
    return {
        "dep:keys": (5 + 5) * m * w,  # pos, mass, valid -> key, rel, mass
        "dep:sort": (2 * 2 + 4 * 2) * m * w,  # key sort + 4-row payload
        "dep:bounds": (1 + 3 + 3) * m * w + (n_cells + 1) * w,
        "dep:prefix": (4 + 8 + 8 + 16) * m * w,  # weights, kernel 5
        # gathers + differences, corner adds + fold
        "dep:place": (2 * 2 * 8 + 8 + 8) * n_cells * w + 2 * ghost * w,
    }


def run(n: int, grid_shape=(4, 4, 4), device=None, steps: int = STEPS,
        mesh_cells: int = MESH_CELLS):
    """The span table of the deposit of ``prod(grid_shape) x n`` rows
    onto ``mesh_cells``^3 on ``device``: the
    :class:`~..telemetry.phases.PhaseTiming` rows, a deposit each."""
    dev = _device.resolve(device)
    state = make_state(grid_shape, n, dev)
    m = state[0].shape[1]
    return phases_lib.attribute_phases(
        make_loop(steps, mesh_cells), state, PHASES, steps=steps,
        phase_bytes=phase_bytes(m, mesh_cells ** 3),
        peak_bytes_per_sec=profiling.HBM_PEAK_BYTES_PER_SEC,
        device=dev.type)


def main(argv=None) -> int:
    return cli(
        argv, "mpi_grid_redistribute_tpu_torch.bench.knockout_deposit",
        "Span table of the planar scan deposit (env KNOCKOUT_GRID, "
        "KNOCKOUT_JSON).", 2**20,
        lambda n, grid, device: [("deposit", run(n, grid, device=device))],
        lambda grid, n: f"shapes: V={int(np.prod(grid))} n={n} "
        f"rows={int(np.prod(grid)) * n} mesh={MESH_CELLS}^3 (Dev = 1), "
        f"{STEPS} deposits",
        default_grid=DEFAULT_GRID)


if __name__ == "__main__":
    sys.exit(main())
