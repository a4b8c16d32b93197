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

The jaxpr rules (J001-J004) are not ported; J000 is
:func:`registry_coverage`. ``python -m
mpi_grid_redistribute_tpu_torch.analysis.progcheck --update-baseline
--device cpu`` writes the counted collective bytes to
``analysis/progprofile_baseline.json`` (``--check`` compares them).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from typing import Callable, Dict, List, Optional, Tuple

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
_CHUNK = 4
WORLD_SIZE = int(np.prod(_SHARDED_GRID))


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


def _canonical_args(rd, topology, device, n, seed):
    import torch

    if topology == "sharded":
        pos = torch.zeros((n, 3), dtype=torch.float32, device=device)
        ids = torch.zeros((n,), dtype=torch.int32, device=device)
        count = torch.full((1,), n, dtype=torch.int32, device=device)
        return pos, ids, count
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

    def build(device=None, n_local=None, mesh=None):
        from mpi_grid_redistribute_tpu_torch import _device

        dev = _device.resolve(device)
        n, _, _ = _sizes(n_local)
        edges = edges_fn() if edges_fn is not None else None
        rd = _mk_rd(engine, topology, dev, n, mesh=mesh, edges=edges,
                    dcn_shape=dcn_shape)
        pos, ids, count = _canonical_args(rd, topology, dev, n, seed=11)
        fn, _cap, _out_cap = rd.engine_fn(pos, ids)
        return fn, (pos, count, ids)

    return build


def _sparse_pods_build(device=None, n_local=None, mesh=None):
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
    fused = torch.zeros((4, n), dtype=torch.int32, device=dev)
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

    def build(device=None, n_local=None, mesh=None):
        import torch

        from mpi_grid_redistribute_tpu_torch import _device
        from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
        from mpi_grid_redistribute_tpu_torch.models import nbody

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
            mover_cap=16 if engine == "sparse" else None,
        )
        loop = nbody.make_migrate_loop(cfg, _MIGRATE_STEPS, vgrid=vgrid,
                                       mesh=mesh, device=dev)
        R = 1 if topology == "sharded" else vgrid.nranks
        if topology == "sharded":
            p = np.zeros((n, 3), np.float32)
            v = np.zeros((n, 3), np.float32)
            alive = torch.zeros((n,), dtype=torch.bool, device=dev)
        else:
            p, v = _owner_rows((2, 2, 2), n, seed=13, vel_scale=0.05)
            rng = np.random.default_rng(14)
            alive = torch.from_numpy(rng.random(R * n) < 0.9).to(dev)
        pos = torch.from_numpy(nbody.rows_to_planar(p, R)).to(dev)
        vel = torch.from_numpy(nbody.rows_to_planar(v, R)).to(dev)
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

    def build(device=None, n_local=None, mesh=None):
        from mpi_grid_redistribute_tpu_torch import _device
        from mpi_grid_redistribute_tpu_torch.service import resident
        from mpi_grid_redistribute_tpu_torch.telemetry.probes import (
            ProbeConfig,
        )

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


def _pipeline_build(device=None, n_local=None, mesh=None):
    """The software-pipelined chunk macro-step of 4 steps
    (``service.pipeline.make_pipelined_chunk_fn``; kernel 2 lands it)."""
    from mpi_grid_redistribute_tpu_torch import _device
    from mpi_grid_redistribute_tpu_torch.service import pipeline

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
            tags=("canonical", "hierarchical"),
        ))
    register_program(ProgramSpec(
        name="canonical_sparse_pods", build=_sparse_pods_build,
        description="the flat sparse engine across the two-pod split, the "
        "denominator of the hierarchical DCN ratio",
        engine="sparse", topology="sharded", capacity=_N_LOCAL,
        mover_cap=_MOVER_CAP, tags=("hierarchical", "comparison"),
    ))
    register_program(ProgramSpec(
        name="migrate_sparse_vranks",
        build=_migrate_build("sparse", "vranks"),
        description="nbody.make_migrate_loop, the sparse engine, 8 vranks",
        engine="sparse", topology="vranks", fastpath="migrate",
        resident_rows=8 * _MIGRATE_N_LOCAL, tags=("migrate",),
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


def main(argv=None) -> int:
    from mpi_grid_redistribute_tpu_torch.analysis import baseline, core

    p = argparse.ArgumentParser(
        prog="mpi_grid_redistribute_tpu_torch.analysis.progcheck",
        description="The port's program registry: J000 coverage and the "
        "counted collective bytes of every program.")
    p.add_argument("--device", default=None,
                   help="where the programs run (default: the GPU)")
    p.add_argument("--update-baseline", action="store_true",
                   help="count every program and write "
                   "analysis/progprofile_baseline.json")
    p.add_argument("--check", action="store_true",
                   help="J000, and the counted collective bytes against "
                   "the committed profile")
    args = p.parse_args(argv)
    programs = default_programs()
    findings = registry_coverage(programs)
    if args.update_baseline or args.check:
        profiles = collective_profiles(
            program_costs(programs, device=args.device))
        if args.update_baseline:
            baseline.write_progprofile_baseline(None, profiles)
            print(f"progcheck: wrote {len(profiles)} profiles")
        else:
            committed = baseline.load_progprofile_baseline() or {}
            for name in sorted(profiles):
                if committed.get(name) != profiles[name]:
                    findings.append(ProgFinding(
                        "J004", name,
                        f"counted collective bytes {profiles[name]} != "
                        f"committed {committed.get(name)}"))
    for f in findings:
        print(f.render())
    if not findings:
        print("progcheck: clean")
    return core.exit_code(findings)


if __name__ == "__main__":
    sys.exit(main())
