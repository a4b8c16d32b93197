"""Span tables of the port's vrank migrate loop (the counterpart of the JAX
package's ``scripts/knockout_stages.py``), at the reference's shapes on
one card, with a logical-bytes column that turns each row into a
roofline statement (the bytes its math implies over HBM3's 3.35 TB/s).

The reference times a copy of its jitted step cut after each phase and
differences the cumulative times. The port reads the spans its loop
already opens instead: ``models.nbody.make_migrate_loop``, whole and
uncut, runs ``STEPS`` steps once under ``torch.profiler`` after a warm
call, and each device operation goes to the innermost listed span open
when it was launched (``telemetry.phases.attribute_phases``); what
``mig:step`` launched outside them is the ``rest`` row, so the rows add
up to the step. Nothing is cut and nothing is copied: the table times
the loop the benchmark's cells run.

Two tables, by engine:

* ``"auto"`` (the mover-sparse engine every cell runs): ``mig:init``
  (the per-call set-up, paid once a call: its row is that over the
  call's steps), ``mig:select``, ``mig:grant``, ``sync:sparse_guard``,
  ``mig:pack``, ``mig:unpack``, ``mig:fallback`` (the dense step when the
  guard reads false), ``rest`` (kernel 1's drift and bin, and the rest of
  ``mig:step``);
* ``"planar"`` (the dense step): ``mig:bin``, ``mig:grant``,
  ``mig:pack``, ``mig:unpack``, ``rest`` (kernel 1, the cycle rescue and
  the vacated-slot plan).

    python -m mpi_grid_redistribute_tpu_torch.bench.knockout_stages [n_local]
    KNOCKOUT_GRID=2,2,2 KNOCKOUT_JSON=rows.json \\
        python -m mpi_grid_redistribute_tpu_torch.bench.knockout_stages 65536

``--device cpu`` runs on the CPU (the host ops' time). ``KNOCKOUT_JSON=
file`` dumps the ``"auto"`` table's rows for ``tools.trace_export
--phases``.
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
from mpi_grid_redistribute_tpu_torch.models import nbody
from mpi_grid_redistribute_tpu_torch.telemetry import phases as phases_lib
from mpi_grid_redistribute_tpu_torch.utils import profiling

FILL = 0.9
MIGRATION = 0.02
K = 7  # 3 pos + 3 vel + alive
# the step's drift: velocities in [0, 1) times 2^-13 (~1.2e-4, the
# reference's 1e-4 rounded to a power of two, so the CPU run is
# bit-comparable with the reference's planar loop)
DT = 2.0**-13
STEPS = 8  # steps of the profiled call
ENGINES = ("auto", "planar")
# the spans each engine's table reads, in the order a step opens them
PHASES = ("mig:init", "mig:select", "mig:grant", "sync:sparse_guard",
          "mig:pack", "mig:unpack", "mig:fallback")
PLANAR_PHASES = ("mig:bin", "mig:grant", "mig:pack", "mig:unpack")
WHOLE = "mig:step"


def spans_of(engine: str):
    """The spans ``engine``'s table reads."""
    return PLANAR_PHASES if engine == "planar" else PHASES


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
    """:func:`uniform_fused` on ``device`` as the loop's arguments,
    ``(pos [3 * V * n], vel [3 * V * n], alive [V * n])`` planar flat,
    with each vrank's positions moved into its own slab (row-major vrank
    ids), as the cells start: the sparse engine then runs its fast branch
    from the first step."""
    V = int(np.prod(grid_shape))
    fused = uniform_fused(grid_shape, n, seed)
    u = fused[:3].view(np.float32).reshape(3, V, n)
    coords = np.stack(np.unravel_index(np.arange(V), grid_shape))[..., None]
    g = np.asarray(grid_shape, np.float32)[:, None, None]
    pos = ((coords + u) / g).astype(np.float32).reshape(-1)
    return (torch.from_numpy(pos).to(device),
            torch.from_numpy(fused[3:6].view(np.float32).reshape(-1)).to(
                device),
            torch.from_numpy(fused[6] > 0).to(device))


def make_loop(grid_shape, n: int, steps: int = STEPS, engine: str = "auto",
              device=None, plain: bool = False):
    """``models.nbody.make_migrate_loop`` of ``steps`` steps over the
    ``grid_shape`` vranks of one device, at the knockout's sizing: the
    loop the cells run (``engine="auto"``) or the dense step's
    (``"planar"``). It reads its arguments only."""
    C, M = sizing(grid_shape, n)
    cfg = nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True),
        grid=ProcessGrid((1,) * len(grid_shape)), dt=DT, capacity=C,
        n_local=n, local_budget=M, engine=engine)
    return nbody.make_migrate_loop(cfg, steps, vgrid=ProcessGrid(grid_shape),
                                   device=device, plain=plain)


def phase_bytes(V, n, M, steps: int = STEPS, engine: str = "auto"):
    """Logical bytes a row touches a step (reads + writes), the
    reference's deliberately minimal traffic (sorts make several passes,
    scatters touch whole sectors), so measured / roofline >> 1 flags a
    latency or serialization bound, not a bandwidth wall."""
    f32 = 4
    gather = (K + 1) * V * M * f32 + K * V * M * f32  # plan + in, out
    landing = (4 + (K + 1) + 2) * V * M * f32  # plan, scatter, stack
    if engine == "planar":
        return {
            "mig:bin": 4 * V * n * f32,  # sort in/out of (key, iota)
            "mig:grant": 0,              # [V, V] tables
            "mig:pack": gather,
            "mig:unpack": landing,
            # kernel 1 (read pos+vel+alive, write key), the vacated plan
            phases_lib.REST: (3 + 3 + 1 + 1) * V * n * f32
            + 3 * V * M * f32,
        }
    return {
        # the fused state's cat in and out and the free stack, a call
        "mig:init": (2 * K + 2) * V * n * f32 // steps,
        "mig:select": (V * n + V * M) * f32,  # keys in, mover block out
        "mig:grant": 0,
        "sync:sparse_guard": 0,
        "mig:pack": gather,
        "mig:unpack": landing,
        phases_lib.REST: (3 + 3 + 1 + 1) * V * n * f32,  # kernel 1
    }


def run(n: int, grid_shape=(2, 2, 2), engine: str = "auto", device=None,
        steps: int = STEPS):
    """``engine``'s span table at ``n`` rows a vrank on ``device``:
    the :class:`~..telemetry.phases.PhaseTiming` rows, a step each."""
    dev = _device.resolve(device)
    V = int(np.prod(grid_shape))
    _, M = sizing(grid_shape, n)
    return phases_lib.attribute_phases(
        make_loop(grid_shape, n, steps, engine, dev),
        make_state(grid_shape, n, dev), spans_of(engine), whole=WHOLE,
        steps=steps, phase_bytes=phase_bytes(V, n, M, steps, engine),
        peak_bytes_per_sec=profiling.HBM_PEAK_BYTES_PER_SEC,
        device=dev.type)


def cli(argv, prog, description, default_n, run_fn, shapes_line,
        default_grid="2,2,2"):
    """The span tables' shared command line: ``n_local`` and
    ``--device``, the grid from ``KNOCKOUT_GRID`` (default
    ``default_grid``). ``run_fn(n, grid, device)`` measures and returns
    ``[(title, rows)]``; each table is printed, and the first one's rows
    are dumped to ``KNOCKOUT_JSON``. ``shapes_line(grid, n)`` heads the
    output."""
    p = argparse.ArgumentParser(prog=prog, description=description)
    p.add_argument("n_local", nargs="?", type=int, default=default_n)
    p.add_argument("--device", default=None,
                   help="default: the GPU; 'cpu' runs on the host clock")
    args = p.parse_args(argv)
    grid = tuple(int(x) for x in
                 os.environ.get("KNOCKOUT_GRID", default_grid).split(","))
    print(shapes_line(grid, args.n_local), file=sys.stderr)
    tables = run_fn(args.n_local, grid, args.device)
    for title, rows in tables:
        print(f"{title} (ms a step)", file=sys.stderr)
        print(phases_lib.format_phase_table(rows), file=sys.stderr,
              flush=True)
    out_json = os.environ.get("KNOCKOUT_JSON")
    if out_json:
        rows = tables[0][1]
        with open(out_json, "w") as f:
            json.dump([r._asdict() for r in rows], f, indent=1)
        print(f"wrote {out_json} ({len(rows)} phase rows)", file=sys.stderr)
    return 0


def _shapes_line(grid, n):
    V = int(np.prod(grid))
    C, M = sizing(grid, n)
    return (f"shapes: V={V} n={n} C={C} M={M} (plan rows/vrank), "
            f"~{int(V * n * FILL * MIGRATION)} migrants/step, {STEPS} steps")


def main(argv=None) -> int:
    return cli(
        argv, "mpi_grid_redistribute_tpu_torch.bench.knockout_stages",
        "Span tables of the vrank migrate loop, the sparse engine's and "
        "the dense step's (env KNOCKOUT_GRID, KNOCKOUT_JSON).", 2**20,
        lambda n, grid, device: [
            (f"engine={e}", run(n, grid, e, device=device))
            for e in ENGINES],
        _shapes_line)


if __name__ == "__main__":
    sys.exit(main())
