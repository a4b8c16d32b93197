"""Knockout attribution of the port's planar scan deposit (the twin of the
JAX package's ``scripts/knockout_deposit.py``): config 5's deposit, timed
cut after each of its phases (cumulative), with CUDA events on the card.

The deposit is the one config 5's ``"scan"`` method runs
(``ops.deposit.shard_deposit_device_planar_fn``): device-cell keys onto a
128^3 mesh owned by one device (Dev = 1), every row of the ``V x n``
rows of ``KNOCKOUT_GRID``'s vranks, then the periodic self-fold of the
+1 ghost faces. The reference keeps a truncatable COPY of its jitted
deposit core, because a compiled program cannot be cut. The port's
deposit is eager Python, so it is cut in place:
``ops.deposit.cic_deposit_device_planar`` takes an internal
``_stop_after`` and returns after the phase asked for. Nothing here can
drift from the deposit, and phase 6 IS the deposit and its fold, bit for
bit.

Phases (the reference's numbering, ``ops.deposit.DEPOSIT_PHASES``):
1 keys (block-local coordinates, cell keys, masked mass), 2 the payload
sort (stable key sort and the gather of the rel and mass rows), 3 the
bounds (``bounds_dense``; the cut also computes the fractions it
returns), 4 the channel prefixes (fractions, corner weights and kernel
5, one fused launch a channel group on the card; the tile-total scan), 5
the boundary gathers and differences, 6 placement of the corner channels
and the ghost fold.

    python -m mpi_grid_redistribute_tpu_torch.bench.knockout_deposit [n]
    KNOCKOUT_GRID=2,2,2 KNOCKOUT_JSON=rows.json \\
        python -m mpi_grid_redistribute_tpu_torch.bench.knockout_deposit

``KNOCKOUT_GRID`` defaults to the reference's 4,4,4 (64 x 2^20 = 67.1M
rows); ``--device cpu`` runs on the CPU (host clock).
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

PHASES = deposit.DEPOSIT_PHASES
FILL = 0.9
MESH_CELLS = 128
DEFAULT_GRID = "4,4,4"


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


def deposit_fns(mesh_cells: int = MESH_CELLS, plain: bool = False):
    """``(full, cut)``: ``full(pos_rows, mass, valid)`` is config 5's
    scan deposit and fold on one device; ``cut(phase, pos_rows, mass,
    valid)`` its core cut after ``phase`` (1-5)."""
    domain = Domain(0.0, 1.0, periodic=True)
    grid = ProcessGrid((1, 1, 1))
    mesh_shape = (mesh_cells,) * 3
    full = deposit.shard_deposit_device_planar_fn(domain, grid, mesh_shape,
                                                  plain=plain)
    lo, inv_h = deposit._device_consts(domain, grid, mesh_shape)
    consts = _device.OnDevice(lo, inv_h)

    def cut(phase, pos_rows, mass, valid):
        dev_lo, ih = consts.get(pos_rows.device)
        return deposit.cic_deposit_device_planar(
            pos_rows, mass, valid, dev_lo, ih, mesh_shape, plain=plain,
            _stop_after=phase)

    return full, cut


def loop_builder(mesh_cells: int = MESH_CELLS, plain: bool = False):
    """``build(phase, S) -> loop(pos_rows, mass, valid)``: S deposits cut
    after ``phase`` (the last phase: whole, with the fold). The deposit
    reads its inputs only, so every run starts from the same state."""
    full, cut = deposit_fns(mesh_cells, plain)

    def build(phase, S):
        k = PHASES.index(phase) + 1

        def loop(pos_rows, mass, valid):
            out = None
            for _ in range(S):
                out = (full(pos_rows, mass, valid) if k == len(PHASES)
                       else cut(k, pos_rows, mass, valid))
            return out

        return loop

    return build


def phase_bytes(m: int, n_cells: int):
    """Minimum logical traffic per phase (the reference's convention:
    measured / roofline >> 1 flags a latency or serialization bound), in
    4-byte words: ``m`` rows, ``n_cells`` mesh cells, 8 corner channels."""
    w = 4
    ghost = round(n_cells ** (1 / 3) + 1) ** 3
    return {
        PHASES[0]: (5 + 5) * m * w,  # pos, mass, valid -> key, rel, mass
        PHASES[1]: (2 * 2 + 4 * 2) * m * w,  # key sort + 4-row gather
        PHASES[2]: (1 + 3 + 3) * m * w + (n_cells + 1) * w,  # frac, bounds
        PHASES[3]: (4 + 8 + 8 + 16) * m * w,  # weights, kernel 5 in/out
        PHASES[4]: (2 * 2 * 8 + 8) * n_cells * w,  # gathers + differences
        PHASES[5]: (8 * n_cells + 2 * ghost) * w,  # corner adds + fold
    }


def run(n: int, grid_shape=(4, 4, 4), device=None, s1: int = 2, s2: int = 6,
        reps: int = 5, progress=None, mesh_cells: int = MESH_CELLS):
    """Attribute the deposit of ``prod(grid_shape) x n`` rows onto
    ``mesh_cells``^3 on ``device``; returns the
    :class:`~..telemetry.phases.PhaseTiming` rows."""
    dev = _device.resolve(device)
    state = make_state(grid_shape, n, dev)
    m = state[0].shape[1]
    return phases_lib.attribute_phases(
        loop_builder(mesh_cells), state, list(PHASES), s1=s1, s2=s2,
        reps=reps, phase_bytes=phase_bytes(m, mesh_cells ** 3),
        peak_bytes_per_sec=profiling.HBM_PEAK_BYTES_PER_SEC,
        progress=progress, device=dev.type)


def main(argv=None) -> int:
    return cli(
        argv, "mpi_grid_redistribute_tpu_torch.bench.knockout_deposit",
        "Knockout attribution of the planar scan deposit (env "
        "KNOCKOUT_GRID, KNOCKOUT_JSON).", 2**20,
        lambda n, grid, device, progress: run(
            n, grid, device=device, progress=progress),
        lambda grid, n: f"shapes: V={int(np.prod(grid))} n={n} "
        f"rows={int(np.prod(grid)) * n} mesh={MESH_CELLS}^3 (Dev = 1)",
        default_grid=DEFAULT_GRID)


if __name__ == "__main__":
    sys.exit(main())
