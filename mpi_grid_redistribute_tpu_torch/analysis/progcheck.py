"""The port's program registry (the registry part of the JAX package's
``analysis/progcheck.py``): every entry point the roofline report
(``telemetry.roofline``) counts, times and journals, under the
reference's 17 names and at the reference's shapes.

A :class:`ProgramSpec`'s ``build(device=..., n_local=..., mesh=...)``
returns ``(fn, args)`` that RUN (the port has no trace-only stage):
``fn(*args)`` is one call of the program. ``sharded`` programs are one
rank's part of a ``torch.distributed`` world of 8 ranks (``mesh`` is
that rank's :class:`~..parallel.mesh.RankMesh`; :func:`world_costs` is
the rank target that counts them); ``vranks`` programs run on one
device.

The shapes are the reference's: sharded grid (2, 2, 2), vrank grid
(2, 2, 4), ``n_local`` 32, capacity 16, mover cap 4, DCN (2, 1, 1) and
(1, 1, 2); the migrate programs 64 rows a rank, capacity 64, 3 steps;
the macro-steps chunks of 4. A wider ``n_local`` takes the API's default
capacity and a mover cap of ``n_local / 64`` (the migrate programs the
bench's sizing). The data:

* sharded programs take the reference's template (every row at the
  origin, every slot counted), so their collectives are those of the
  dense fallback the reference's J004 bills (its ``lax.cond`` at the
  max-bytes branch) and their counts compare with its
  ``progprofile_baseline.json``;
* vrank programs take rows on their owner's subdomain with a small
  velocity (seeded), the traffic a roofline time is measured on.

J000 is :func:`registry_coverage`; J001-J004 (``analysis/rules_prog.py``)
read recorded runs (:func:`record_registry`): every program on the
registry's input, and the sharded count-driven ones also on an input on
which one rank alone overflows the mover block (``one_rank_overflows``)
and, for the two wire contracts, on one whose movers fit (``fast``).
Sharded programs run in one gloo world of :data:`WORLD_SIZE` processes
(:func:`world_records`), every rank returning its collective sequence.

CLI: ``python -m mpi_grid_redistribute_tpu_torch.analysis.progcheck
[--device cpu] [--check] [--format text|json|sarif|github]
[--update-baseline]``; exit codes 0 clean, 1 findings, 2 usage.
``--update-baseline`` writes the ``profiles`` section of
``analysis/progprofile_baseline.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_SHARDED_GRID = (2, 2, 2)  # 8 ranks, one a process
_VRANK_GRID = (2, 2, 4)  # 16 vranks on one device
_N_LOCAL = 32
_CAPACITY = 16
_MOVER_CAP = 4
_DCN_SHARDED = (2, 1, 1)
_DCN_VRANK = (1, 1, 2)
_MIGRATE_N_LOCAL = 64
_MIGRATE_STEPS = 3
_MIGRATE_MOVER_CAP = 16
_CHUNK = 4
WORLD_SIZE = int(np.prod(_SHARDED_GRID))
J_RULE_IDS = ("J000", "J001", "J002", "J003", "J004")
# the inputs a sharded program can run (:func:`program_inputs`)
INPUTS = ("registry", "one_rank_overflows", "fast")
_OVERFLOW_RANK = 3  # the rank that alone overflows the mover block
_OVERFLOW_ROWS = 8  # > every registry mover cap, <= capacity
# engines whose wire follows the counts (a guard agreed across ranks)
COUNT_DRIVEN = ("sparse", "neighbor", "hierarchical")
# seconds a rank waits in one collective: a rank that diverges (the
# deadlock J001 catches) fails the world within this, not at its end
PG_TIMEOUT = 120.0


@dataclasses.dataclass(frozen=True)
class ProgFinding:
    """One registry finding."""

    rule: str
    program: str
    message: str
    path: str = "mpi_grid_redistribute_tpu_torch/analysis/progcheck.py"
    line: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"<{self.program}>: {self.rule}: {self.message}"


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One entry point of the port. ``build(device=None, n_local=None,
    mesh=None) -> (fn, args)``; the program is one ``fn(*args)``."""

    name: str
    build: Callable[..., Tuple[Callable, tuple]]
    description: str = ""
    engine: Optional[str] = None  # exchange.ENGINES member it exercises
    topology: Optional[str] = None  # "sharded" | "vranks"
    resident: bool = False
    fastpath: Optional[str] = None
    resident_rows: Optional[int] = None
    capacity: Optional[int] = None
    mover_cap: Optional[int] = None
    tags: Tuple[str, ...] = ()
    fast_rows: Optional[int] = None  # mover_cap x V: a fast gather's most
    dcn_shape: Optional[Tuple[int, ...]] = None  # pods of its deployment


PROGRAMS: Dict[str, ProgramSpec] = {}


def register_program(spec: ProgramSpec) -> ProgramSpec:
    if spec.name in PROGRAMS:
        raise ValueError(f"program {spec.name!r} already registered")
    PROGRAMS[spec.name] = spec
    return spec


# -- builders ---------------------------------------------------------------


def _sizes(n_local):
    """``(n_local, capacity, mover_cap)``: the reference's up to its
    width; wider, the API's default capacity (``None``: twice the mean
    share of a destination) and a mover block of ``n_local / 64``."""
    n = _N_LOCAL if n_local is None else int(n_local)
    if n <= _N_LOCAL:
        return n, max(1, n * _CAPACITY // _N_LOCAL), max(
            1, n * _MOVER_CAP // _N_LOCAL)
    return n, None, max(1, n // 64)


def _owner_rows(shape, n, seed, vel_scale=0.01):
    """``(pos [R*n, 3], vel [R*n, 3])`` float32: rank ``r``'s rows on its
    own subdomain, velocities uniform in ``[-vel_scale, vel_scale]``."""
    rng = np.random.default_rng(seed)
    R = int(np.prod(shape))
    strides = np.cumprod((1,) + tuple(shape)[::-1])[:-1][::-1]
    cell = np.stack([(np.arange(R) // s) % g
                     for s, g in zip(strides, shape)], axis=1)
    lo = np.repeat(cell / np.asarray(shape), n, axis=0)
    pos = (lo + rng.random((R * n, 3)) / np.asarray(shape)).astype(np.float32)
    pos = np.minimum(pos, np.float32(1.0) - np.float32(2.0**-24))
    vel = (vel_scale * (2 * rng.random((R * n, 3)) - 1)).astype(np.float32)
    return pos, vel


def _mk_rd(engine, topology, device, n_local, mesh=None, edges=None,
           dcn_shape=None):
    from mpi_grid_redistribute_tpu_torch import api
    from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid

    n, cap, mover = _sizes(n_local)
    grid = ProcessGrid(_SHARDED_GRID if topology == "sharded"
                       else _VRANK_GRID)
    count_driven = engine in ("sparse", "neighbor", "hierarchical")
    return api.GridRedistribute(
        grid=grid, lo=(0.0,) * 3, hi=(1.0,) * 3, periodic=(True,) * 3,
        engine=engine, device=device,
        mesh=mesh if topology == "sharded" else None,
        capacity=cap, mover_cap=mover if count_driven else None,
        dcn_shape=dcn_shape,
        cross_cap=mover if engine == "hierarchical" else None,
        edges=edges,
    )


def _sharded_rows(rank, n, data):
    """``(pos [n, 3] float32, ids [n] int32)`` of one rank of the
    sharded world: the reference's template (every row at the origin)
    for ``registry``; else the rank's own rows on its subdomain, with
    one row moved one subdomain along y on every rank (``fast``: the
    movers fit every mover block and the stencil) or
    :data:`_OVERFLOW_ROWS` rows moved on rank :data:`_OVERFLOW_RANK`
    alone (``one_rank_overflows``; y stays inside a pod of the two-pod
    split)."""
    if data == "registry":
        return np.zeros((n, 3), np.float32), np.zeros((n,), np.int32)
    if data not in INPUTS:
        raise ValueError(f"unknown input {data!r} (known: {INPUTS})")
    p, _ = _owner_rows(_SHARDED_GRID, n, seed=23)
    pos = p[rank * n:(rank + 1) * n].copy()
    moved = (1 if data == "fast" else
             _OVERFLOW_ROWS if rank == _OVERFLOW_RANK else 0)
    pos[:moved, 1] = np.mod(pos[:moved, 1] + np.float32(0.5),
                            np.float32(1.0))
    ids = np.arange(rank * n, (rank + 1) * n, dtype=np.int32)
    return pos, ids


def _canonical_args(rd, topology, device, n, seed, rank=0,
                    data="registry"):
    import torch

    if topology == "sharded":
        p, i = _sharded_rows(rank, n, data)
        pos = torch.from_numpy(p).to(device)
        ids = torch.from_numpy(i).to(device)
        count = torch.full((1,), n, dtype=torch.int32, device=device)
        return pos, ids, count
    if data != "registry":
        raise ValueError(f"a vranks program runs the registry input only, "
                         f"not {data!r}")
    R = rd.nranks
    p, _ = _owner_rows(_VRANK_GRID, n, seed)
    pos = torch.from_numpy(p).to(device)
    ids = torch.arange(R * n, dtype=torch.int32, device=device)
    count = torch.full((R,), n, dtype=torch.int32, device=device)
    return pos, ids, count


def _canonical_build(engine, topology, edges_fn=None, dcn_shape=None):
    """One canonical-exchange program: the engine
    ``GridRedistribute.engine_fn`` resolves (what ``redistribute()``
    dispatches), run once on ``(pos, count, ids)``."""

    def build(device=None, n_local=None, mesh=None, data="registry"):
        from mpi_grid_redistribute_tpu_torch import _device

        dev = _device.resolve(device)
        n, _, _ = _sizes(n_local)
        edges = edges_fn() if edges_fn is not None else None
        rd = _mk_rd(engine, topology, dev, n, mesh=mesh, edges=edges,
                    dcn_shape=dcn_shape)
        pos, ids, count = _canonical_args(
            rd, topology, dev, n, seed=11,
            rank=0 if mesh is None else mesh.rank, data=data)
        fn, _cap, _out_cap = rd.engine_fn(pos, ids)
        return fn, (pos, count, ids)

    return build


def _sparse_pods_build(device=None, n_local=None, mesh=None,
                       data="registry"):
    """The flat sparse engine across the ranks of the two-pod split, the
    denominator of the reference's hierarchical DCN ratio: capacity
    ``n_local``, the mover cap, the flat wire (every hop billed to DCN
    in the reference; one flat world here)."""
    import torch

    from mpi_grid_redistribute_tpu_torch import _device
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.parallel import exchange

    dev = _device.resolve(device)
    n, _, mover = _sizes(n_local)
    fn = exchange.shard_redistribute_count_driven_sharded(
        mesh, Domain(0.0, 1.0, periodic=True), ProcessGrid(_SHARDED_GRID),
        n, n, mover, 3, engine="sparse")
    p, i = _sharded_rows(mesh.rank, n, data)
    fused = torch.from_numpy(np.concatenate(
        [p.T.view(np.int32), i[None]], axis=0)).to(dev)
    count = torch.full((1,), n, dtype=torch.int32, device=dev)
    return fn, (fused, count)


def _assignment_edges():
    """The sharded grid's fine 4^3 cells, each mapped to the rank of its
    coarse cell (the LPT-map shape ``apply_assignment`` installs)."""
    from mpi_grid_redistribute_tpu_torch.domain import GridEdges, ProcessGrid

    grid = ProcessGrid(_SHARDED_GRID)
    fine = 4
    edges = tuple(tuple(float(v) for v in np.linspace(0.0, 1.0, fine + 1))
                  for _ in range(3))
    assignment = []
    for i in range(fine):
        for j in range(fine):
            for k in range(fine):
                assignment.append(grid.rank_of_cell((
                    i * grid.shape[0] // fine, j * grid.shape[1] // fine,
                    k * grid.shape[2] // fine)))
    return GridEdges(edges, assignment=assignment)


def _migrate_build(engine, topology):
    """A drift/migrate loop of 3 steps (``nbody.make_migrate_loop``)."""

    def build(device=None, n_local=None, mesh=None, data="registry"):
        import torch

        from mpi_grid_redistribute_tpu_torch import _device
        from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
        from mpi_grid_redistribute_tpu_torch.models import nbody

        _registry_only(data)
        dev = _device.resolve(device)
        n = _MIGRATE_N_LOCAL if n_local is None else int(n_local)
        # the reference's capacity (n_local) up to its 64 rows; above
        # that the bench's sizing (~2% migration, 1.3 headroom)
        cap = n if n <= _MIGRATE_N_LOCAL else max(
            _MIGRATE_N_LOCAL, math.ceil(0.9 * n * 0.02 * 1.3))
        domain = Domain(0.0, 1.0, periodic=True)
        if topology == "sharded":
            dev_grid, vgrid = ProcessGrid(_SHARDED_GRID), None
        else:
            dev_grid, vgrid = ProcessGrid((1, 1, 1)), ProcessGrid((2, 2, 2))
        cfg = nbody.DriftConfig(
            domain=domain, grid=dev_grid, dt=0.07, capacity=cap,
            n_local=n, engine=engine,
            mover_cap=_MIGRATE_MOVER_CAP if engine == "sparse" else None,
        )
        loop = nbody.make_migrate_loop(cfg, _MIGRATE_STEPS, vgrid=vgrid,
                                       mesh=mesh, device=dev)
        R = 1 if topology == "sharded" else vgrid.nranks
        # one planar block a device: the vranks of one device share it
        # (rows_to_planar's n_blocks is the device count, not R)
        if topology == "sharded":
            p = np.zeros((n, 3), np.float32)
            v = np.zeros((n, 3), np.float32)
            alive = torch.zeros((n,), dtype=torch.bool, device=dev)
        else:
            p, v = _owner_rows((2, 2, 2), n, seed=13, vel_scale=0.05)
            rng = np.random.default_rng(14)
            alive = torch.from_numpy(rng.random(R * n) < 0.9).to(dev)
        pos = torch.from_numpy(nbody.rows_to_planar(p, 1)).to(dev)
        vel = torch.from_numpy(nbody.rows_to_planar(v, 1)).to(dev)
        return loop, (pos, vel, alive)

    return build


def _macro_args(device, n):
    import torch

    R = int(np.prod(_VRANK_GRID))
    p, v = _owner_rows(_VRANK_GRID, n, seed=17)
    pos = torch.from_numpy(p).to(device)
    vel = torch.from_numpy(v).to(device)
    ids = torch.arange(R * n, dtype=torch.int32, device=device)
    count = torch.full((R,), n, dtype=torch.int32, device=device)
    return pos, vel, ids, count


def _resident_build(probe_tier=None):
    """The resident chunk macro-step of 4 steps
    (``service.resident.make_chunk_fn``), the counters-tier probes armed
    with ``probe_tier``."""

    def build(device=None, n_local=None, mesh=None, data="registry"):
        from mpi_grid_redistribute_tpu_torch import _device
        from mpi_grid_redistribute_tpu_torch.service import resident
        from mpi_grid_redistribute_tpu_torch.telemetry.probes import (
            ProbeConfig,
        )

        _registry_only(data)
        dev = _device.resolve(device)
        n, _, _ = _sizes(n_local)
        rd = _mk_rd("auto", "vranks", dev, n)
        pos, vel, ids, count = _macro_args(dev, n)
        kwargs = {}
        if probe_tier is not None:
            kwargs["probes"] = ProbeConfig(tier=probe_tier)
        macro, _cap, _out_cap = resident.make_chunk_fn(
            rd, 0.05, _CHUNK, pos, vel, ids, **kwargs)
        return macro, (pos, vel, ids, count)

    return build


def _registry_only(data):
    if data != "registry":
        raise ValueError(f"this program runs the registry input only, not "
                         f"{data!r}")


def _pipeline_build(device=None, n_local=None, mesh=None, data="registry"):
    """The software-pipelined chunk macro-step of 4 steps
    (``service.pipeline.make_pipelined_chunk_fn``; kernel 2 lands it)."""
    from mpi_grid_redistribute_tpu_torch import _device
    from mpi_grid_redistribute_tpu_torch.service import pipeline

    _registry_only(data)
    dev = _device.resolve(device)
    n, _, _ = _sizes(n_local)
    rd = _mk_rd("auto", "vranks", dev, n)
    pos, vel, ids, count = _macro_args(dev, n)
    macro, _cap, _out_cap = pipeline.make_pipelined_chunk_fn(
        rd, 0.05, _CHUNK, pos, vel, ids)
    return macro, (pos, vel, ids, count)


_DEFAULTS_BUILT = False


def _register_defaults() -> None:
    """Populate :data:`PROGRAMS` with the reference's 17 programs."""
    global _DEFAULTS_BUILT
    if _DEFAULTS_BUILT:
        return
    _DEFAULTS_BUILT = True
    for topology in ("sharded", "vranks"):
        for engine in ("planar", "rowmajor", "sparse", "neighbor"):
            fastpath = None
            if engine == "sparse" and topology == "sharded":
                fastpath = "sparse_wire"
            elif engine == "neighbor" and topology == "sharded":
                fastpath = "neighbor_wire"
            register_program(ProgramSpec(
                name=f"canonical_{engine}_{topology}",
                build=_canonical_build(engine, topology),
                description=(f"GridRedistribute.engine_fn({engine!r}), "
                             f"{topology}"),
                engine=engine, topology=topology, fastpath=fastpath,
                capacity=_CAPACITY, mover_cap=_MOVER_CAP,
                tags=("canonical",),
            ))
    for topology, dcn in (("sharded", _DCN_SHARDED), ("vranks", _DCN_VRANK)):
        register_program(ProgramSpec(
            name=f"canonical_hierarchical_{topology}",
            build=_canonical_build("hierarchical", topology, dcn_shape=dcn),
            description=("GridRedistribute.engine_fn('hierarchical'), "
                         f"{topology}, pods split by dcn {dcn}"),
            engine="hierarchical", topology=topology,
            capacity=_CAPACITY, mover_cap=_MOVER_CAP,
            tags=("canonical", "hierarchical"), dcn_shape=dcn,
        ))
    register_program(ProgramSpec(
        name="canonical_sparse_pods", build=_sparse_pods_build,
        description="the flat sparse engine across the two-pod split, the "
        "denominator of the hierarchical DCN ratio",
        engine="sparse", topology="sharded", capacity=_N_LOCAL,
        mover_cap=_MOVER_CAP, tags=("hierarchical", "comparison"),
        dcn_shape=_DCN_SHARDED,
    ))
    register_program(ProgramSpec(
        name="migrate_sparse_vranks",
        build=_migrate_build("sparse", "vranks"),
        description="nbody.make_migrate_loop, the sparse engine, 8 vranks",
        engine="sparse", topology="vranks", fastpath="migrate",
        resident_rows=8 * _MIGRATE_N_LOCAL, tags=("migrate",),
        fast_rows=_MIGRATE_MOVER_CAP * 8,
    ))
    register_program(ProgramSpec(
        name="migrate_planar_sharded",
        build=_migrate_build("planar", "sharded"),
        description="nbody.make_migrate_loop, the planar engine, 8 ranks",
        engine="planar", topology="sharded", tags=("migrate",),
    ))
    register_program(ProgramSpec(
        name="resident_macro_step", build=_resident_build(),
        description="service/resident.py chunk macro-step (drift -> "
        "engine_fn, 4 steps)",
        engine="planar", topology="vranks", resident=True,
        tags=("resident",),
    ))
    register_program(ProgramSpec(
        name="resident_macro_step_probed",
        build=_resident_build(probe_tier="counters"),
        description="the resident macro-step with the counters-tier "
        "state-health probes",
        engine="planar", topology="vranks", resident=True,
        tags=("resident", "probes"),
    ))
    register_program(ProgramSpec(
        name="pipelined_macro_step", build=_pipeline_build,
        description="service/pipeline.py software-pipelined chunk "
        "macro-step (4 steps)",
        engine="planar", topology="vranks", resident=True,
        fastpath="pipeline", tags=("resident", "pipeline"),
    ))
    register_program(ProgramSpec(
        name="apply_assignment_oneshot",
        build=_canonical_build("auto", "sharded", _assignment_edges),
        description="the one-shot redistribute apply_assignment "
        "dispatches (assignment-aware fine-grid edges)",
        engine="sparse", topology="sharded", tags=("apply_assignment",),
    ))


def default_programs() -> Dict[str, ProgramSpec]:
    _register_defaults()
    return dict(PROGRAMS)


def registry_coverage(programs: Dict[str, ProgramSpec]) -> List[ProgFinding]:
    """J000: every dispatchable engine on both topologies, every
    count-driven engine and every service-surface tag has a program."""
    from mpi_grid_redistribute_tpu_torch.parallel import exchange

    findings: List[ProgFinding] = []
    for engine in [e for e in exchange.ENGINES if e != "auto"]:
        for topology in ("sharded", "vranks"):
            if not any(p.engine == engine and p.topology == topology
                       for p in programs.values()):
                findings.append(ProgFinding(
                    "J000", "<registry>",
                    f"engine {engine!r} has no registered program on the "
                    f"{topology} topology — register it in "
                    "analysis/progcheck.py or it ships uncounted"))
    for engine in exchange.COUNT_DRIVEN_ENGINES:
        if not any(p.engine == engine for p in programs.values()):
            findings.append(ProgFinding(
                "J000", "<registry>",
                f"count-driven engine {engine!r} (exchange."
                "COUNT_DRIVEN_ENGINES) has no registered program"))
    for tag in ("resident", "pipeline", "migrate", "apply_assignment",
                "probes"):
        if not any(tag in p.tags for p in programs.values()):
            findings.append(ProgFinding(
                "J000", "<registry>",
                f"no registered program carries the {tag!r} tag"))
    return findings


# -- counting across ranks --------------------------------------------------


def world_costs(ctx, names, n_local=None):
    """Rank target (``parallel.launch.run_world``): build and count each
    sharded program in ``names`` on this rank; returns ``{name:
    telemetry.roofline.count_cost(...)}``."""
    from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid
    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib
    from mpi_grid_redistribute_tpu_torch.telemetry import roofline

    programs = default_programs()
    mesh = mesh_lib.make_mesh(ProcessGrid(_SHARDED_GRID))
    out = {}
    for name in names:
        fn, args = programs[name].build(device=ctx.device, n_local=n_local,
                                        mesh=mesh)
        out[name] = roofline.count_cost(fn, args)
    return out


def sharded_costs(names, device=None, n_local=None, timeout=600.0):
    """Rank 0's counted costs of the sharded programs ``names``, from one
    gloo world of :data:`WORLD_SIZE` processes on ``device`` (the ranks
    share one card on the GPU)."""
    from mpi_grid_redistribute_tpu_torch import _device
    from mpi_grid_redistribute_tpu_torch.parallel import launch

    dev = _device.resolve(device)
    res = launch.run_world(
        "mpi_grid_redistribute_tpu_torch.analysis.progcheck:world_costs",
        WORLD_SIZE, args=(list(names), n_local),
        backend="gloo", device=dev.type, timeout=timeout)
    return res[0]


def program_costs(programs=None, device=None, n_local=None) -> Dict[str, dict]:
    """Counted costs of every program: vrank programs in this process,
    sharded ones in one world (:func:`sharded_costs`)."""
    from mpi_grid_redistribute_tpu_torch import _device
    from mpi_grid_redistribute_tpu_torch.telemetry import roofline

    programs = default_programs() if programs is None else programs
    dev = _device.resolve(device)
    out = {}
    sharded = sorted(n for n, p in programs.items()
                     if p.topology == "sharded")
    for name in sorted(programs):
        if name in sharded:
            continue
        fn, args = programs[name].build(device=dev, n_local=n_local)
        out[name] = roofline.count_cost(fn, args)
    if sharded:
        out.update(sharded_costs(sharded, device=dev, n_local=n_local))
    return out


def collective_profiles(costs: Dict[str, dict]) -> Dict[str, dict]:
    """The J004 ``profiles`` section of counted costs."""
    return {
        name: {
            "collective_bytes": c["collective_bytes"],
            "collective_bytes_total": c["collective_bytes_total"],
            "collective_count": c["collective_count"],
        }
        for name, c in costs.items()
    }


# -- recorded runs (the input of J001-J004 and S004) -------------------


def _strip(events):
    """Events of a record as plain tuples (pickled across the world)."""
    return [tuple(e) for e in events]


def record_program(fn, args) -> dict:
    """Run ``fn(*args)`` once under ``costcount.counting(record=True)``:
    ``{"cost", "events", "sequence", "peak_live_bytes"}`` (the outputs
    are dropped)."""
    from mpi_grid_redistribute_tpu_torch.utils import costcount

    with costcount.counting(record=True) as c:
        out = fn(*args)
        peak = c.peak(out)
        del out
    return {
        "cost": c.as_dict(),
        "events": list(c.events),
        "sequence": c.collective_sequence(),
        "peak_live_bytes": int(peak),
    }


class HostReadCounter:
    """Counts the host reads of tensors inside the block (J002): ``item``,
    ``tolist``, ``bool``/``int``/``float`` of a tensor, ``cpu``,
    ``numpy``, ``nonzero``, ``masked_select`` and boolean-mask indexing
    (each returns a value whose size or content only the device knows,
    so the host waits for it). ``counts`` maps each read to its count.
    Reads inside a kernel's scope are not the program's: there the
    kernel's plain version stands in, on the CPU, for a launch that reads
    nothing back (on the card the launch runs, and sync debug mode
    "error" watches it)."""

    READS = frozenset({"item", "tolist", "__bool__", "__int__", "__float__",
                       "cpu", "numpy", "nonzero", "masked_select"})

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self._mode = None

    def __enter__(self):
        import torch
        from torch.overrides import TorchFunctionMode

        from mpi_grid_redistribute_tpu_torch.utils import costcount

        counter = self

        class _Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                name = getattr(func, "__name__", "")
                if name in HostReadCounter.READS:
                    counter._add(name)
                elif name == "__getitem__" and len(args) > 1:
                    idx = args[1] if isinstance(args[1], tuple) else (
                        args[1],)
                    if any(isinstance(i, torch.Tensor)
                           and i.dtype == torch.bool for i in idx):
                        counter._add("mask_index")
                return func(*args, **(kwargs or {}))

        self._watch = costcount.watching_kernels()
        self._watch.__enter__()
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._watch.__exit__(*exc)
        return False

    def _add(self, name):
        from mpi_grid_redistribute_tpu_torch.utils import costcount

        if not costcount.in_kernel_scope():
            self.counts[name] = self.counts.get(name, 0) + 1


def host_reads(fn, args, device) -> Tuple[Dict[str, int], Optional[str]]:
    """One call of ``fn(*args)``: the host reads it made, and on the card
    what ``torch.cuda.set_sync_debug_mode("error")`` raised (``None``
    when nothing synchronized)."""
    import torch

    error = None
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        with HostReadCounter() as reads:
            try:
                out = fn(*args)
                del out
            except RuntimeError as exc:
                if not on_card:
                    raise
                error = str(exc).splitlines()[0]
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    return reads.counts, error


def program_inputs(spec: ProgramSpec) -> Tuple[str, ...]:
    """The inputs a program runs: the registry's; for a sharded
    count-driven program also ``one_rank_overflows`` (J001), and for the
    two wire contracts ``fast`` (J001, J003)."""
    if spec.topology != "sharded" or spec.engine not in COUNT_DRIVEN:
        return ("registry",)
    if spec.fastpath in ("sparse_wire", "neighbor_wire"):
        return INPUTS
    return ("registry", "one_rank_overflows")


def world_records(ctx, names, n_local=None, inputs=None):
    """Rank target (``parallel.launch.run_world``): record each sharded
    program in ``names`` on each of its inputs on this rank. Returns
    ``{name: {input: record}}``; rank 0's records are whole, the other
    ranks' hold only their collective ``sequence``. ``inputs`` limits
    the inputs run (default: each program's :func:`program_inputs`)."""
    from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid
    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib

    programs = default_programs()
    mesh = mesh_lib.make_mesh(ProcessGrid(_SHARDED_GRID))
    out = {}
    for name in names:
        spec = programs[name]
        out[name] = {}
        for data in program_inputs(spec):
            if inputs is not None and data not in inputs:
                continue
            fn, args = spec.build(device=ctx.device, n_local=n_local,
                                  mesh=mesh, data=data)
            rec = record_program(fn, args)
            rec["events"] = _strip(rec["events"])
            if ctx.rank != 0:
                rec = {"sequence": rec["sequence"]}
            out[name][data] = rec
    return out


# a path: record_registry records the whole registry once into it (under
# a file lock) and serves every later call from it; tools.check_all sets
# it, so progcheck and shardcheck share one recording
RECORDS_CACHE_ENV = "MPI_GRID_PROGCHECK_RECORDS"


def record_registry(programs=None, device=None, n_local=None,
                    timeout=600.0, host_read_check=True,
                    inputs=None) -> Dict[str, dict]:
    """Record every program: ``{name: {"records": {input: rank 0's
    record}, "sequences": {input: [rank r's sequence]}, "host_reads",
    "sync_error"}}``. Sharded programs run in one gloo world of
    :data:`WORLD_SIZE` processes on ``device`` (the ranks share one card
    on the GPU) while the vrank programs run in this process. A resident
    program also runs once under :func:`host_reads` (J002). ``inputs``
    limits the sharded programs' inputs (:func:`world_records`). Under
    :data:`RECORDS_CACHE_ENV` a registry-wide request is served from
    (or recorded once into) that file."""
    from mpi_grid_redistribute_tpu_torch import _device

    programs = default_programs() if programs is None else programs
    dev = _device.resolve(device)
    cache = os.environ.get(RECORDS_CACHE_ENV)
    registry = default_programs()
    if (cache and n_local is None
            and all(registry.get(n) is p for n, p in programs.items())):
        full = _cached_registry(cache, dev, timeout)
        return {n: _subset(full[n], inputs) for n in programs}
    return _record(programs, dev, n_local, timeout, host_read_check,
                   inputs)


def _subset(entry, inputs):
    if inputs is None:
        return entry
    keep = [d for d in entry["records"] if d in inputs]
    return dict(entry, records={d: entry["records"][d] for d in keep},
                sequences={d: entry["sequences"][d] for d in keep})


def _cached_registry(path, dev, timeout):
    """The whole registry's records on ``dev``, recorded into ``path``
    by the first caller (the others wait on its lock)."""
    import fcntl
    import pickle

    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):
                with open(path, "rb") as f:
                    device, full = pickle.load(f)
                if device == str(dev):
                    return full
            full = _record(default_programs(), dev, None, timeout, True,
                           None)
            write_records_cache(path, dev, full)
            return full
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def vrank_entries(programs, dev, n_local=None, host_read_check=True
                  ) -> Dict[str, dict]:
    """:func:`record_registry`'s entries of the vrank programs among
    ``programs``, recorded in this process on ``dev``."""
    out: Dict[str, dict] = {}
    for name in sorted(programs):
        spec = programs[name]
        if spec.topology == "sharded":
            continue
        fn, args = spec.build(device=dev, n_local=n_local)
        rec = record_program(fn, args)
        entry = {"records": {"registry": rec},
                 "sequences": {"registry": [rec["sequence"]]},
                 "host_reads": {}, "sync_error": None}
        if spec.resident and host_read_check:
            entry["host_reads"], entry["sync_error"] = host_reads(
                fn, args, dev)
        out[name] = entry
    return out


def world_entries(ranks, names) -> Dict[str, dict]:
    """:func:`record_registry`'s entries of the sharded programs
    ``names`` from every rank's :func:`world_records` result (rank
    order)."""
    from mpi_grid_redistribute_tpu_torch.utils import costcount

    out: Dict[str, dict] = {}
    for name in names:
        records = {}
        for data, rec in ranks[0][name].items():
            records[data] = dict(rec, events=[costcount.Event(*e)
                                              for e in rec["events"]])
        out[name] = {
            "records": records,
            "sequences": {data: [r[name][data]["sequence"] for r in ranks]
                          for data in records},
            "host_reads": {}, "sync_error": None,
        }
    return out


def write_records_cache(path: str, dev, full: Dict[str, dict]) -> None:
    """Save the whole registry's records on ``dev`` where
    :data:`RECORDS_CACHE_ENV` finds them (a caller that recorded them
    itself, as ``chip_smoke.py`` does in a world it already runs)."""
    import pickle

    missing = sorted(set(default_programs()) - set(full))
    if missing:
        raise ValueError(f"records of {missing} are missing")
    with open(path, "wb") as f:
        pickle.dump((str(dev), full), f)


def _record(programs, dev, n_local, timeout, host_read_check, inputs):
    import threading

    from mpi_grid_redistribute_tpu_torch.parallel import launch

    sharded = sorted(n for n, p in programs.items()
                     if p.topology == "sharded")
    world: Dict[str, object] = {}

    def run():
        try:
            world["ranks"] = launch.run_world(
                "mpi_grid_redistribute_tpu_torch.analysis.progcheck:"
                "world_records", WORLD_SIZE,
                args=(sharded, n_local, None if inputs is None else
                      tuple(inputs)),
                backend="gloo", device=dev.type, timeout=timeout,
                pg_timeout=PG_TIMEOUT)
        except BaseException as exc:  # re-raised by the caller below
            world["error"] = exc

    # the world's ranks start while this process records the vranks
    thread = threading.Thread(target=run, name="progcheck-world")
    if sharded:
        thread.start()
    try:
        out = vrank_entries(programs, dev, n_local, host_read_check)
    finally:
        if sharded:
            thread.join()
    if "error" in world:
        raise world["error"]
    if sharded:
        out.update(world_entries(world["ranks"], sharded))
    return out


def run_progcheck(programs=None, rules: Optional[Iterable[str]] = None,
                  device=None, n_local=None, recorded=None
                  ) -> Tuple[List[ProgFinding], Dict[str, dict]]:
    """Record every program (or take ``recorded``, :func:`
    record_registry`'s result) and run the J-rules. Returns ``(findings,
    profiles)``: the profiles are J004's input, which the caller gates
    against the committed baseline (so ``--update-baseline`` shares one
    pass)."""
    from mpi_grid_redistribute_tpu_torch.analysis import rules_prog

    programs = default_programs() if programs is None else programs
    wanted = set(rules) if rules else set(J_RULE_IDS)
    if recorded is None:
        recorded = record_registry(
            programs, device=device, n_local=n_local,
            host_read_check="J002" in wanted)
    findings: List[ProgFinding] = []
    profiles: Dict[str, dict] = {}
    for name in sorted(programs):
        spec, entry = programs[name], recorded[name]
        if "J001" in wanted and spec.topology == "sharded":
            findings.extend(rules_prog.check_j001(name, entry["sequences"]))
        if "J002" in wanted:
            findings.extend(rules_prog.check_j002(
                spec, entry["host_reads"], entry["sync_error"]))
        if "J003" in wanted:
            findings.extend(rules_prog.check_j003(spec, entry["records"]))
        if "J004" in wanted:
            profiles[name] = rules_prog.program_profile(
                entry["records"]["registry"])
    if "J000" in wanted:
        findings.extend(registry_coverage(programs))
    findings.sort(key=lambda f: (f.rule, f.program, f.message))
    return findings, profiles


def gate_profiles(profiles, baseline_doc, rtol=0.0, check_stale=False,
                  partial=False) -> List[ProgFinding]:
    """J004 against a committed baseline document: the port's own
    profiles (drift), then the reference's copied ``reference_profiles``
    under the justified list ``reference_differences``."""
    from mpi_grid_redistribute_tpu_torch.analysis import rules_prog

    findings = rules_prog.compare_profiles(
        profiles, baseline_doc.get("profiles"), rtol=rtol,
        check_stale=check_stale, partial=partial)
    findings += rules_prog.compare_reference(
        "J004", "profiles", profiles, baseline_doc.get("reference_profiles"),
        baseline_doc.get("reference_differences", []),
        rules_prog.REFERENCE_PROFILE_KEYS)
    return findings


def _parser() -> argparse.ArgumentParser:
    from mpi_grid_redistribute_tpu_torch.analysis import baseline

    p = argparse.ArgumentParser(
        prog="mpi_grid_redistribute_tpu_torch.analysis.progcheck",
        description="The port's program registry: records every program "
        "and checks J000-J004.")
    p.add_argument("--device", default=None,
                   help="where the programs run (default: the GPU)")
    p.add_argument("--format", choices=("text", "json", "sarif", "github"),
                   default="text", help="output format")
    p.add_argument("--rules", default=None, metavar="J00x[,J00y]",
                   help="comma-separated subset of rules to run")
    p.add_argument("--programs", default=None, metavar="NAME[,NAME]",
                   help="comma-separated subset of registered programs")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="J004 profile baseline (default: "
                   f"{baseline.progprofile_baseline_path()})")
    p.add_argument("--check", action="store_true",
                   help="CI mode: also fail on baseline entries of "
                   "programs that are no longer registered")
    p.add_argument("--update-baseline", action="store_true",
                   help="write the current profiles to the baseline file "
                   "and exit 0")
    p.add_argument("--rtol", type=float, default=0.0,
                   help="relative tolerance of J004's drift (default 0: "
                   "the counts are deterministic, any drift is a change)")
    p.add_argument("--list-rules", action="store_true",
                   help="list rules and exit")
    p.add_argument("--list-programs", action="store_true",
                   help="list registered programs and exit")
    return p


def _split(arg):
    return [x.strip() for x in arg.split(",") if x.strip()]


def main(argv: Optional[Sequence[str]] = None) -> int:
    from mpi_grid_redistribute_tpu_torch.analysis import (
        baseline, rules_prog, sarif,
    )

    args = _parser().parse_args(argv)
    if args.list_rules:
        for rid in J_RULE_IDS:
            print(f"{rid}  {rules_prog.RULE_DOCS[rid]}")
        return 0
    rules: Optional[List[str]] = None
    if args.rules:
        rules = _split(args.rules)
        unknown = [r for r in rules if r not in J_RULE_IDS]
        if unknown:
            print(f"progcheck: unknown rule(s): {', '.join(unknown)} "
                  f"(known: {', '.join(J_RULE_IDS)})", file=sys.stderr)
            return 2
    programs = default_programs()
    if args.list_programs:
        for name in sorted(programs):
            spec = programs[name]
            print(f"{name}  [{spec.engine}/{spec.topology}]  "
                  f"{spec.description}")
        return 0
    if args.programs:
        wanted = _split(args.programs)
        unknown = [p for p in wanted if p not in programs]
        if unknown:
            print(f"progcheck: unknown program(s): {', '.join(unknown)} "
                  f"(known: {', '.join(sorted(programs))})",
                  file=sys.stderr)
            return 2
        programs = {n: programs[n] for n in wanted}
        # a subset run cannot judge the registry's completeness
        rules = [r for r in (rules or J_RULE_IDS) if r != "J000"]

    findings, profiles = run_progcheck(programs, rules=rules,
                                       device=args.device)
    path = args.baseline or baseline.progprofile_baseline_path()
    if args.update_baseline:
        baseline.write_progprofile_baseline(path, profiles)
        print(f"progcheck: wrote {len(profiles)} program profile(s) to "
              f"{path}")
        return 0
    if profiles:  # J004 asked for: gate against the committed baseline
        findings += gate_profiles(
            profiles, baseline.load_progprofile_doc(path), rtol=args.rtol,
            check_stale=args.check, partial=args.programs is not None)
        findings.sort(key=lambda f: (f.rule, f.program, f.message))

    if args.format == "json":
        print(json.dumps({"findings": [f.to_dict() for f in findings],
                          "programs": sorted(programs),
                          "profiles": profiles}, indent=2, sort_keys=True))
    elif args.format == "sarif":
        print(json.dumps(sarif.to_sarif(findings, "progcheck",
                                        rules_prog.RULE_DOCS), indent=2))
    elif args.format == "github":
        for line in sarif.github_annotations(findings):
            print(line)
    else:
        for f in findings:
            print(f.render())
        print(f"progcheck: {len(findings)} finding(s) over "
              f"{len(programs)} program(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
