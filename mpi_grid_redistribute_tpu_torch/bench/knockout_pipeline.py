"""Span table of the port's pipelined chunk step (the counterpart of the
JAX package's ``scripts/knockout_pipeline.py``): the steady-state step of
``service.pipeline.make_pipelined_chunk_fn``, whole and uncut, its device
time a step charged to the chunk's own spans through ``telemetry.phases.
attribute_phases``.

The reference composes its two-phase surface in issue-first order and
cuts it, because a jitted chunk cannot be read inside. The port reads
the spans its chunk opens in the order the pipelined step runs them:
``pipe:land+drift`` (step k+1's drift and bin, then step k's landing:
the arrivals drift in flight and land with their next-step key, K = 9
rows), ``pipe:issue`` (step k+1's issue and arrival gather) and
``pipe:probe`` (the health probes, only when they are armed: 0 here).

A run of S steps is one chunk of S + 1 steps on the same start state
(the reference knockout's: uniform rows, ``FILL`` of each vrank live),
profiled once after a warm call: its prologue (step 1's drift and
issue), then S steady-state steps. The chunk has no enclosing span, so
``rest`` is what the whole call launched outside the listed ones (the
fuse, the prologue, the epilogue's landing and compaction) over its S
steps, and the rows add up to the call a step.

    python -m mpi_grid_redistribute_tpu_torch.bench.knockout_pipeline [n_local]

``KNOCKOUT_GRID=2,2,2`` (default), ``KNOCKOUT_JSON=file`` dumps the rows
for ``tools.trace_export --phases``; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch import _device, api
from mpi_grid_redistribute_tpu_torch.bench.knockout_stages import (
    DT,
    FILL,
    cli,
    uniform_fused,
)
from mpi_grid_redistribute_tpu_torch.service import pipeline
from mpi_grid_redistribute_tpu_torch.telemetry import phases as phases_lib
from mpi_grid_redistribute_tpu_torch.utils import profiling

K = 8  # the chunk's state: 3 pos + 3 vel + ids + alive
STEPS = 8  # steady-state steps of the profiled chunk

# the chunk's spans, in the order the pipelined step opens them
PHASES = ("pipe:land+drift", "pipe:issue", "pipe:probe")


def phase_bytes(V, n):
    """Minimum logical traffic a step a row (the reference's convention:
    measured / roofline >> 1 flags a latency or serialization bound), at
    the chunk's widths: the landing drifts the ``[K, V, n]`` arrivals,
    bins them and scatters K + 1 rows (the key rides along)."""
    f32 = 4
    return {
        # drift (read pos+vel, write pos), bin (read pos+alive, write
        # key), arrival drift + key, scatter + targets + stack
        "pipe:land+drift": ((3 + 3 + 3) + (3 + 1 + 1)
                            + (9 + 4 + (K + 1) + 1 + 2)) * V * n * f32,
        # sort in/out of (key, iota), gather in + out
        "pipe:issue": (4 + 2 * K) * V * n * f32,
    }


def make_state(grid_shape, n: int, device, seed: int = 0):
    """The chunk's arguments ``(pos [V*n, 3], vel [V*n, 3], ids [V*n],
    count [V])`` from the migrate knockout's start state
    (:func:`..knockout_stages.uniform_fused`): its position and velocity
    rows, ``FILL`` of every vrank's rows live."""
    V = int(np.prod(grid_shape))
    fused = uniform_fused(grid_shape, n, seed)
    pos = np.ascontiguousarray(fused[:3].view(np.float32).T)
    vel = np.ascontiguousarray(fused[3:6].view(np.float32).T)
    return (torch.from_numpy(pos).to(device),
            torch.from_numpy(vel).to(device),
            torch.arange(V * n, dtype=torch.int32, device=device),
            torch.full((V,), int(FILL * n), dtype=torch.int32,
                       device=device))


def make_loop(grid_shape, n: int, state, steps: int = STEPS):
    """``macro(pos, vel, ids, count)``: one pipelined chunk of ``steps``
    steady-state steps (``steps + 1`` with the prologue's) on the
    template ``state`` (:func:`make_state`). It reads its arguments
    only."""
    rd = api.GridRedistribute(
        grid=tuple(grid_shape), lo=(0.0,) * 3, hi=(1.0,) * 3,
        periodic=(True,) * 3, engine="auto", device=state[0].device)
    pos, vel, ids, _ = state
    macro, _, _ = pipeline.make_pipelined_chunk_fn(rd, DT, steps + 1, pos,
                                                   vel, ids)
    return macro


def run(n: int, grid_shape=(2, 2, 2), device=None, steps: int = STEPS):
    """The span table of the pipelined step at ``n`` rows a vrank on
    ``device``: the :class:`~..telemetry.phases.PhaseTiming` rows, a
    step each."""
    dev = _device.resolve(device)
    V = int(np.prod(grid_shape))
    state = make_state(grid_shape, n, dev)
    return phases_lib.attribute_phases(
        make_loop(grid_shape, n, state, steps), state, PHASES,
        steps=steps, phase_bytes=phase_bytes(V, n),
        peak_bytes_per_sec=profiling.HBM_PEAK_BYTES_PER_SEC,
        device=dev.type)


def main(argv=None) -> int:
    return cli(
        argv, "mpi_grid_redistribute_tpu_torch.bench.knockout_pipeline",
        "Span table of the pipelined chunk step (env KNOCKOUT_GRID, "
        "KNOCKOUT_JSON).", 4096,
        lambda n, grid, device: [("pipeline", run(n, grid, device=device))],
        lambda grid, n: f"shapes: V={int(np.prod(grid))} n={n} (plan "
        f"width = n), {STEPS} steps")


if __name__ == "__main__":
    sys.exit(main())
