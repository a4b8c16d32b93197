"""The system under test: the drift loop of ``mpi_grid_redistribute_tpu_torch``
as a cell configures it, or its public one-shot ``redistribute()`` call
(:func:`build_oneshot`). The only module of the benchmark that imports the
program.

:func:`build` returns ``step(state) -> (state, rho)``: one call of
``models.nbody.make_migrate_loop(cfg, S, vgrid=..., mesh=...)`` whose
planar ``(pos, vel, alive)`` outputs are the next call's inputs, and its
density (``None`` without a deposit). Under an assignment the loop gets
the ``cells`` grid and the table. :func:`emit` gives a state's live rows
with the slab that holds each; :func:`stats_arrays` the counts of
``MigrateStats`` a metric reads.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.spec import Cell


def build(cell: Cell, device, mesh=None):
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.models import nbody

    cfg = nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True),
        grid=ProcessGrid(cell.dev_grid), dt=cell.dt,
        capacity=cell.capacity, n_local=cell.n_local,
        local_budget=cell.budget, engine=cell.config.get("engine", "auto"),
        deposit_shape=cell.deposit_shape,
        deposit_method=cell.deposit_method or "scan",
        cells=None if cell.cells is None else ProcessGrid(cell.cells),
        assignment=cell.assignment,
    )
    loop = nbody.make_migrate_loop(
        cfg, cell.steps_per_call, vgrid=ProcessGrid(cell.vgrid), mesh=mesh,
        device=device, deposit_each_step=cell.deposit_shape is not None,
    )

    def step(state):
        out = loop(state[0].reshape(-1), state[1].reshape(-1), state[2])
        rho = out[4] if len(out) > 4 else None
        return (out[0], out[1], out[2], out[3]), rho

    return step


def make_mesh(cell: Cell):
    """The port's rank mesh over the default process group."""
    from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid
    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh(ProcessGrid(cell.dev_grid))


def initialize_distributed(port: int, world: int, rank: int) -> None:
    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib.initialize_distributed(
        "nccl", init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=300.0)


def emit(cell: Cell, state, rank: int):
    """``(pos [3, k], vel [3, k], slab [k])`` of the live rows of this
    card's state: slot column ``c`` lies on slab ``rank * V + c //
    n_local``."""
    pos, vel, alive = state[0], state[1], state[2]
    cols = alive.nonzero().squeeze(1)
    slab = rank * cell.V + torch.div(cols, cell.n_local, rounding_mode="floor")
    return (pos.reshape(3, -1)[:, cols], vel.reshape(3, -1)[:, cols],
            slab.to(torch.int64))


def stats_arrays(stats_list):
    """The traced calls' ``MigrateStats`` as host arrays, steps stacked:
    ``sent``/``received`` ``[steps, R]``, ``flow`` ``[steps, R, R]``."""
    out = {}
    for f in ("sent", "received", "flow"):
        out[f] = np.concatenate(
            [getattr(s, f).cpu().numpy() for s in stats_list], axis=0)
    return out


def kernel_launches() -> dict:
    from mpi_grid_redistribute_tpu_torch.ops import _build

    return dict(_build.counts())


def build_oneshot(cell: Cell, device):
    """``(gr, call)``: ``api.GridRedistribute`` over the cell's grid in the
    periodic unit box with the public defaults (``capacity_factor`` 2,
    ``out_capacity`` ``n_local``, ``on_overflow="grow"``, ``check_every``
    16, ``engine="auto"``), and ``call((pos, vel, count)) ->
    RedistributeResult``, one ``gr.redistribute(pos, vel, count=count)``."""
    from mpi_grid_redistribute_tpu_torch.api import GridRedistribute
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid

    gr = GridRedistribute(Domain(0.0, 1.0, periodic=True),
                          ProcessGrid(cell.grid), device=device)

    def call(snapshot):
        pos, vel, count = snapshot
        return gr.redistribute(pos, vel, count=count)

    return gr, call


def oneshot_report(gr) -> dict:
    """What the run logs of the instance: ``gr.report()``'s resolved
    engine, calls and blocking fetches, the capacities of the journal's
    last ``redistribute`` attempt, and its counts of attempts and of
    ``capacity_grow`` events (a call re-run by ``"grow"`` makes two
    attempts). Reads the last call's stats."""
    rep = gr.report()
    events = rep.get("events") or {}
    last = gr.telemetry.last("redistribute")
    return {"engine": rep["engine"], "calls": rep["calls"],
            "blocking_fetches": rep["blocking_fetches"],
            "capacity": last.data.get("capacity"),
            "out_capacity": last.data.get("out_capacity"),
            "attempts": events.get("redistribute", 0),
            "grows": events.get("capacity_grow", 0)}
