"""Seeded fixture programs of the progcheck and shardcheck tests that need
a world of ranks (they run inside the ranks ``parallel.launch.run_world``
starts, so this module imports the port and nothing of JAX or of the JAX
package), and the vrank fixtures the tests record in-process.

Each fixture is a small program in the engines' own idiom: its branches
open the engines' ``traced_span`` regions and issue the port's
collectives, so progcheck records it as it records a registry program.
"""

from __future__ import annotations

import torch

from mpi_grid_redistribute_tpu_torch.analysis import progcheck, rules_prog
from mpi_grid_redistribute_tpu_torch.parallel import collectives as col
from mpi_grid_redistribute_tpu_torch.telemetry.phases import traced_span

CAP, B = 16, 4  # the fixtures' dense and mover-block widths


def _wire(x, mesh, cols, region):
    """A ``[2, R * cols]`` int32 pool through one all-to-all in
    ``region``."""
    R = mesh.size
    with traced_span(region):
        pool = x[:, :R * cols].contiguous()
        return col.all_to_all(pool, mesh, dim=1)


def sparse_fixture(mesh, fast: bool, narrow_cols: int):
    """The sparse engine's dispatch: the fast wire at ``narrow_cols``
    columns a destination, the dense pool at :data:`CAP`."""
    x = torch.arange(2 * mesh.size * CAP, dtype=torch.int32).reshape(2, -1)
    if fast:
        return _wire(x, mesh, narrow_cols, rules_prog.SPARSE_WIRE)
    return _wire(x, mesh, CAP, rules_prog.DENSE_WIRE)


def neighbor_fixture(mesh, fast: bool, permutes: bool):
    """The neighbor engine's dispatch: the fast region shifts a block
    one rank on (``permutes``) or, seeded, only doubles it; the dense
    branch is the pool all-to-all."""
    x = torch.ones((2, mesh.size * B), dtype=torch.int32)
    if not fast:
        return _wire(x, mesh, B, rules_prog.DENSE_WIRE)
    with traced_span(rules_prog.NEIGHBOR_WIRE):
        if permutes:
            perm = [(i, (i + 1) % mesh.size) for i in range(mesh.size)]
            return col.ppermute(x, mesh, perm)
        return x * 2


def guard_fixture(mesh, agreed: bool):
    """A branch around a collective on a guard each rank reads: agreed
    (a ``pmin`` first, as the engines do) or, seeded, this rank's own
    (rank 0 alone overflows), so rank 0 reduces with ``psum`` where the
    others ``pmin`` (the same wire, another schedule)."""
    ok = torch.tensor([0 if mesh.rank == 0 else 1], dtype=torch.int32)
    if agreed:
        ok = col.pmin(ok, mesh)
    if bool(ok[0] == 1):
        return col.pmin(ok, mesh)
    return col.psum(ok, mesh)


def fixture_world(ctx):
    """Rank target: the records of the seeded fixtures on this rank,
    ``{name: {input: record}}`` in :func:`progcheck.world_records`'s
    shape (rank 0 whole, the others their sequences)."""
    from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid
    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(ProcessGrid((ctx.world_size, 1, 1)))
    runs = {
        "sparse_ok": {"registry": lambda: sparse_fixture(mesh, False, B),
                      "fast": lambda: sparse_fixture(mesh, True, B)},
        "sparse_broken_width": {
            "registry": lambda: sparse_fixture(mesh, False, B),
            "fast": lambda: sparse_fixture(mesh, True, 2 * B)},
        "neighbor_ok": {"registry": lambda: neighbor_fixture(mesh, False, 1),
                        "fast": lambda: neighbor_fixture(mesh, True, True)},
        "neighbor_lost_ppermute": {
            "registry": lambda: neighbor_fixture(mesh, False, True),
            "fast": lambda: neighbor_fixture(mesh, True, False)},
        "guard_agreed": {"registry": lambda: guard_fixture(mesh, True)},
        "guard_local": {"registry": lambda: guard_fixture(mesh, False)},
    }
    out = {}
    for name, inputs in runs.items():
        out[name] = {}
        for data, fn in inputs.items():
            rec = progcheck.record_program(fn, ())
            rec["events"] = [tuple(e) for e in rec["events"]]
            if ctx.rank != 0:
                rec = {"sequence": rec["sequence"]}
            out[name][data] = rec
    return out


# ------------------------------------------------------- vrank fixtures


def migrate_fixture(sort: bool = False, wide_gather: bool = False,
                    n: int = 64):
    """A fast branch in ``mig:fast``: a mover-block gather of 8 rows, and,
    seeded, a sort spliced in or a gather of all ``n`` rows."""
    def fn(x):
        with traced_span(rules_prog.MIGRATE_FAST):
            y = x.index_select(0, torch.arange(8))
            if sort:
                y = torch.sort(y).values
            if wide_gather:
                y = x.index_select(0, torch.arange(n))
            return y

    return fn, (torch.arange(n, dtype=torch.float32),)


def pipeline_fixture(land_first: bool = False, landings: int = 1):
    """A steady-state iteration in ``pipe:land+drift``: bin (``floor``)
    then land with one scatter, or, seeded, land before binning or land
    twice."""
    def fn(x, t):
        with traced_span(rules_prog.PIPELINE_STEADY):
            if land_first:
                x = x.index_put((t,), torch.ones(t.shape))
            key = torch.floor(x * 4.0)
            for _ in range(landings if not land_first else 0):
                x = x.index_put((t,), key[t])
            return x

    return fn, (torch.linspace(0.0, 1.0, 16), torch.tensor([1, 3]))


def resident_fixture(item: bool = False):
    """A resident macro of two steps; seeded, one ``.item()`` read."""
    def fn(x):
        for _ in range(2):
            x = x * 0.5 + 1.0
            if item:
                x = x + x.sum().item()
        return x

    return fn, (torch.ones(8),)
