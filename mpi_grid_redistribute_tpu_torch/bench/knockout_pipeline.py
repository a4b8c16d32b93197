"""Knockout attribution of the port's pipelined chunk step (the twin of
the JAX package's ``scripts/knockout_pipeline.py``): the steady-state
step of ``service.pipeline.make_pipelined_chunk_fn`` is timed cut after
each of its phases (cumulative), through ``telemetry.phases.
attribute_phases``, with CUDA events on the card.

The reference composes its two-phase surface in issue-first order,
because a jitted chunk cannot be cut. The port's chunk is eager Python,
so it is cut in place: ``make_pipelined_chunk_fn`` takes an internal
``_stop_after`` and each steady-state step returns after the phase asked
for. The phases keep the reference's names and numbers, in the order the
pipelined step runs them: step k+1's drift and bin come BEFORE step k's
landing (the arrivals drift in flight and land with their next-step key,
K = 9 rows), then step k+1's issue and arrival gather. Nothing here can
drift from the service chunk, and the last phase IS its step.

A run of S steps is one chunk of S + 1 steps on the same start state
(the reference knockout's: uniform rows, ``FILL`` of each vrank live):
its prologue (step 1's drift and issue), then S steady-state steps. The
fuse, prologue, epilogue and compaction of the chunk are the same in
every run and cancel in the length difference.

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

# the reference's phase names, in the order the pipelined step runs them
PHASES = (
    "1 drift + wrap",
    "2 bin (routing key)",
    "5 landing (fused scatter + free-stack)",
    "3 issue (sort + flow-control plans)",
    "4 arrival gather",
)


def phase_bytes(V, n):
    """Minimum logical traffic per phase (the reference's convention:
    measured / roofline >> 1 flags a latency or serialization bound), at
    the chunk's widths: the landing drifts the ``[K, V, n]`` arrivals,
    bins them and scatters K + 1 rows (the key rides along)."""
    f32 = 4
    return {
        PHASES[0]: (3 + 3 + 3) * V * n * f32,   # read pos+vel, write pos
        PHASES[1]: (3 + 1 + 1) * V * n * f32,   # read pos+alive, write key
        # arrival drift + key, scatter + targets + stack
        PHASES[2]: (9 + 4 + (K + 1) + 1 + 2) * V * n * f32,
        PHASES[3]: 4 * V * n * f32,             # sort in/out of (key, iota)
        PHASES[4]: 2 * K * V * n * f32,         # gather in + out
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


def loop_builder(grid_shape, n: int, state):
    """``build(phase, S) -> macro(pos, vel, ids, count)``: one pipelined
    chunk of ``S`` steady-state steps (``S + 1`` steps with the
    prologue's) on the template ``state`` (:func:`make_state`), each cut
    after ``phase``."""
    rd = api.GridRedistribute(
        grid=tuple(grid_shape), lo=(0.0,) * 3, hi=(1.0,) * 3,
        periodic=(True,) * 3, engine="auto", device=state[0].device)
    pos, vel, ids, _ = state

    def build(phase, S):
        cut = int(phase.split()[0])
        macro, _, _ = pipeline.make_pipelined_chunk_fn(
            rd, DT, S + 1, pos, vel, ids,
            _stop_after=None if phase == PHASES[-1] else cut)
        return macro

    return build


def run(n: int, grid_shape=(2, 2, 2), device=None, s1: int = 4,
        s2: int = 36, reps: int = 7, progress=None):
    """Attribute the pipelined step at ``n`` rows a vrank on
    ``device``; returns the :class:`~..telemetry.phases.PhaseTiming`
    rows."""
    dev = _device.resolve(device)
    V = int(np.prod(grid_shape))
    state = make_state(grid_shape, n, dev)
    return phases_lib.attribute_phases(
        loop_builder(grid_shape, n, state), state, PHASES, s1=s1, s2=s2,
        reps=reps, phase_bytes=phase_bytes(V, n),
        peak_bytes_per_sec=profiling.HBM_PEAK_BYTES_PER_SEC,
        progress=progress, device=dev.type)


def main(argv=None) -> int:
    return cli(
        argv, "mpi_grid_redistribute_tpu_torch.bench.knockout_pipeline",
        "Knockout attribution of the pipelined chunk step (env "
        "KNOCKOUT_GRID, KNOCKOUT_JSON).", 4096,
        lambda n, grid, device, progress: run(
            n, grid, device=device, progress=progress),
        lambda grid, n: f"shapes: V={int(np.prod(grid))} n={n} (plan "
        "width = n)")


if __name__ == "__main__":
    sys.exit(main())
