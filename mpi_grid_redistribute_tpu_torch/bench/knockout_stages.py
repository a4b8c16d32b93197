"""Knockout attribution of the port's planar vrank migrate step (the twin
of the JAX package's ``scripts/knockout_stages.py``): the step is timed
cut after each of its phases (cumulative), at the reference's shapes on
one card, with a logical-bytes column that turns the attribution into a
roofline statement (the bytes each phase's math implies over HBM3's
3.35 TB/s).

The reference keeps a truncatable COPY of its jitted step, because a
compiled program cannot be cut. The port's step is eager Python, so it
is cut in place: ``parallel.migrate.shard_migrate_vranks_fn``'s step
takes an internal ``_stop_after`` and returns after the phase asked for.
Nothing here can drift from the engine, and phase 8 IS the step
``nbody.make_migrate_loop(engine="planar")`` runs, bit for bit.

Phases (the reference's numbering): 1 drift + wrap + bin (kernel 1),
2 stable key sort + counts, 3 local allocation fixpoint, 4 vacated-slot
plan, 5 arrival gather, 6 landing plan, 7 landing (kernel 2), 8 free-stack
update (the full step).

    python -m mpi_grid_redistribute_tpu_torch.bench.knockout_stages [n_local]
    KNOCKOUT_GRID=2,2,2 KNOCKOUT_PHASES=1,2,8 KNOCKOUT_JSON=rows.json \\
        python -m mpi_grid_redistribute_tpu_torch.bench.knockout_stages 65536

``--device cpu`` runs on the CPU (host clock). ``KNOCKOUT_JSON=file``
dumps the rows for ``tools.trace_export --phases``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch import _device
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops import driftbin
from mpi_grid_redistribute_tpu_torch.parallel import migrate
from mpi_grid_redistribute_tpu_torch.telemetry import phases as phases_lib
from mpi_grid_redistribute_tpu_torch.utils import profiling

FILL = 0.9
MIGRATION = 0.02
K = 7  # 3 pos + 3 vel + alive
# the step's drift: velocities in [0, 1) times 2^-13 (~1.2e-4, the
# reference's 1e-4 rounded to a power of two, so the CPU run is
# bit-comparable with the reference's planar loop)
DT = 2.0**-13
PHASES = (1, 2, 3, 4, 5, 6, 7, 8)


def sizing(grid_shape, n: int):
    """``(C, M)``: the pair capacity and the local plan budget, the
    reference's formulas."""
    g = np.asarray(grid_shape)
    distinct = int(np.where(g == 1, 0, np.where(g == 2, 1, 2)).sum()) or 1
    C = max(64, math.ceil(FILL * n * MIGRATION / distinct * 1.3))
    M = max(256, math.ceil(FILL * n * MIGRATION * 1.3))
    return C, M


def uniform_fused(grid_shape, n: int, seed: int = 0) -> np.ndarray:
    """The reference's start state: every row of the planar int32 ``[K,
    V * n]`` matrix uniform in ``[0, 1)`` as float32 bits, the alive row
    at ``FILL``."""
    V = int(np.prod(grid_shape))
    rng = np.random.default_rng(seed)
    fused = rng.random((K, V * n), dtype=np.float32).view(np.int32)
    fused[-1, :] = (rng.random((V * n,)) < FILL).astype(np.int32)
    return fused


def make_state(grid_shape, n: int, device, seed: int = 0):
    """:func:`uniform_fused` on ``device`` as the
    :class:`~..parallel.migrate.MigrateState` the step takes."""
    fused = torch.from_numpy(uniform_fused(grid_shape, n, seed)).to(device)
    return migrate.init_state(fused, vranks=int(np.prod(grid_shape)),
                              batched=True)


def loop_builder(grid_shape, n: int, plain: bool = False):
    """``build(phase, S) -> loop(fused, free_stack, n_free)``: S steps of
    the port's planar vrank step cut after ``phase`` (a fresh copy of the
    state a run, so every run starts from the same one). Returns the
    final state."""
    domain = Domain(0.0, 1.0, periodic=True)
    vgrid = ProcessGrid(grid_shape)
    V = vgrid.nranks
    C, M = sizing(grid_shape, n)
    step = migrate.shard_migrate_vranks_fn(
        domain, ProcessGrid((1,) * len(grid_shape)), vgrid, C,
        local_budget=M, plain=plain)
    bin_fn = driftbin.drift_wrap_bin_plain if plain else driftbin.drift_wrap_bin

    def build(phase, S):
        def loop(fused, free_stack, n_free):
            st = migrate.MigrateState(fused.clone(), free_stack.clone(),
                                      n_free.clone())
            for _ in range(S):
                f, key = bin_fn(st.fused, DT, domain, vgrid, V, V)
                st, _ = step(st._replace(fused=f), key,
                             _stop_after=None if phase == 8 else phase)
            return st

        return loop

    return build


def phase_bytes(V, n, M):
    """Logical bytes each phase NEWLY touches (reads + writes), the
    reference's deliberately minimal traffic (sorts make several passes,
    scatters touch whole sectors), so measured / roofline >> 1 flags a
    latency or serialization bound, not a bandwidth wall."""
    f32 = 4
    return {
        1: (3 + 3 + 1 + 1) * V * n * f32,  # read pos+vel+alive, write key
        2: 4 * V * n * f32,                # sort in/out of (key, iota)
        3: 0,                              # [V, V] tables
        4: 3 * V * M * f32,                # plan vectors + order gather
        5: (K + 1) * V * M * f32 + K * V * M * f32,  # gather in + out
        6: 4 * V * M * f32,                # plan vectors
        7: (K + 1) * V * M * f32,          # scatter writes + targets
        8: 2 * V * M * f32,                # stack windows
    }


def run(n: int, grid_shape=(2, 2, 2), phases=PHASES, device=None,
        s1: int = 4, s2: int = 36, reps: int = 7, progress=None):
    """Attribute the step at ``n`` rows a vrank on ``device``; returns the
    :class:`~..telemetry.phases.PhaseTiming` rows."""
    dev = _device.resolve(device)
    V = int(np.prod(grid_shape))
    _, M = sizing(grid_shape, n)
    state = make_state(grid_shape, n, dev)
    return phases_lib.attribute_phases(
        loop_builder(grid_shape, n), tuple(state), list(phases),
        s1=s1, s2=s2, reps=reps, phase_bytes=phase_bytes(V, n, M),
        peak_bytes_per_sec=profiling.HBM_PEAK_BYTES_PER_SEC,
        progress=progress, device=dev.type)


def cli(argv, prog, description, default_n, run_fn, shapes_line,
        default_grid="2,2,2"):
    """The knockouts' shared command line: ``n_local`` and ``--device``,
    the grid from ``KNOCKOUT_GRID`` (default ``default_grid``), each row
    streamed as it is measured, the rows dumped to ``KNOCKOUT_JSON``.
    ``run_fn(n, grid, device, progress)`` measures; ``shapes_line(grid,
    n)`` heads the output."""
    p = argparse.ArgumentParser(prog=prog, description=description)
    p.add_argument("n_local", nargs="?", type=int, default=default_n)
    p.add_argument("--device", default=None,
                   help="default: the GPU; 'cpu' runs on the host clock")
    args = p.parse_args(argv)
    grid = tuple(int(x) for x in
                 os.environ.get("KNOCKOUT_GRID", default_grid).split(","))
    print(shapes_line(grid, args.n_local), file=sys.stderr)
    for line in phases_lib.format_phase_table([]).splitlines():
        print(line, file=sys.stderr, flush=True)
    rows = []

    def stream(row):
        rows.append(row)
        print(phases_lib.format_phase_table(rows).splitlines()[-1],
              file=sys.stderr, flush=True)

    run_fn(args.n_local, grid, args.device, stream)
    out_json = os.environ.get("KNOCKOUT_JSON")
    if out_json:
        with open(out_json, "w") as f:
            json.dump([r._asdict() for r in rows], f, indent=1)
        print(f"wrote {out_json} ({len(rows)} phase rows)", file=sys.stderr)
    return 0


def _shapes_line(grid, n):
    V = int(np.prod(grid))
    C, M = sizing(grid, n)
    return (f"shapes: V={V} n={n} C={C} M={M} (plan rows/vrank), "
            f"~{int(V * n * FILL * MIGRATION)} migrants/step")


def main(argv=None) -> int:
    phases = [int(x) for x in
              os.environ.get("KNOCKOUT_PHASES", "1,2,3,4,5,6,7,8").split(",")]
    return cli(
        argv, "mpi_grid_redistribute_tpu_torch.bench.knockout_stages",
        "Knockout attribution of the planar vrank migrate step (env "
        "KNOCKOUT_GRID, KNOCKOUT_PHASES, KNOCKOUT_JSON).", 2**20,
        lambda n, grid, device, progress: run(
            n, grid, phases, device=device, progress=progress),
        _shapes_line)


if __name__ == "__main__":
    sys.exit(main())
