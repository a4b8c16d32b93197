"""PyTorch/CUDA port of ``mpi_grid_redistribute_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
neither it nor JAX. Ported so far, on ONE device with the ranks of the
grid as virtual ranks, or with ``mesh=`` one rank a process:

  * the canonical :class:`GridRedistribute` ``.redistribute()`` (the
    planar, row-major, count-driven ``"sparse"`` and stencil
    ``"neighbor"`` engines, and the two-level ``"hierarchical"`` one over
    the pods of ``dcn_shape=`` with its ``cross_cap=`` block;
    ``engine="auto"`` picks planar on one device, hierarchical across
    the ranks of several pods and sparse across ranks of one) with its
    NumPy oracle (:mod:`.oracle`) and non-uniform :class:`GridEdges`,
    ``.apply_assignment()``, and the functional :func:`redistribute` and
    :func:`.api.reshard`;
  * the halo exchange ``GridRedistribute.halo()`` (:class:`HaloResult`;
    the planar and row-major engines of :mod:`.parallel.halo`, on one
    device and across ranks), with the set-level ghost oracle
    ``oracle.brute_force_ghosts``;
  * the drift/migrate loop (:func:`.models.nbody.make_migrate_loop`, the
    mover-sparse and planar engines, the row-store landing route, the
    flat engine and the vrank engine across ranks) and the CIC deposit
    fused into it, on one device and across ranks;
  * the canonical drift loop (:func:`.models.nbody.make_drift_loop` /
    ``make_drift_step``: drift, wrap, the row-major canonical exchange
    and the CIC deposit each step or once at the end), one rank a
    process, or on a one-rank grid in one process;
  * the telemetry core (:mod:`.telemetry`): every ``GridRedistribute``
    journals into ``rd.telemetry`` and reports through ``report()``,
    ``flow()``, ``health()``, ``metrics()`` and ``to_perfetto()``; the
    headline bench :mod:`.bench.headline` (``bench.py``'s twin) and the
    C++ host runtime's binding :mod:`.utils.native`.

Ranks over ``torch.distributed`` (the reference is ONE program over a
``jax.sharding.Mesh``; the port is one program a rank):

  * a rank is a process; :func:`.parallel.mesh.make_mesh` gives its
    :class:`~.parallel.mesh.RankMesh`. Rank ``r`` is row-major over
    ``grid.shape``, the order of the reference's device mesh and of
    ``lax.axis_index(axis_names)``; vrank ``v`` of device ``d`` is global
    rank ``d * V + v`` (device-major);
  * rank ``r`` holds the reference's shard ``r`` of every global array
    (rows ``[r * n, (r + 1) * n)``, or lane-sharded planar columns) and
    a scalar ``count``, and returns the reference's output shard ``r``;
  * stats the reference returns as ``[R]`` (``[R, R]``, ``[S, R]``; the
    halo's ghost counts and overflow too) come back the same on every
    rank (gathered), so every decision a caller or an engine takes from
    them (capacity, mover-block, cross-block and halo growth, the
    count-driven and hierarchical engines' branch, the cycle rescue) is
    the same on every rank, and every rank takes the same branch around
    a collective;
  * the collectives (:mod:`.parallel.collectives`) use only what gloo and
    NCCL both take, a collective over a subset of the mesh axes (the
    hierarchical engine's pod and pod-slot groups) being one world call;
    :func:`.parallel.launch.run_world` starts a world of processes (the
    counterpart of ``mpirun``). Several ranks sharing one card run over
    gloo; NCCL takes one rank a card.

Every TPU kernel of the reference has a hand-written CUDA counterpart
under ``csrc/``, compiled with ``nvcc`` at first use. Entry points run on
the GPU unless the caller passes ``device="cpu"``, where every kernel
runs as its plain PyTorch version.
"""

from mpi_grid_redistribute_tpu_torch.api import (
    GridRedistribute, MoverCapacity, RedistributeResult, redistribute,
)
from mpi_grid_redistribute_tpu_torch.domain import Domain, GridEdges, ProcessGrid
from mpi_grid_redistribute_tpu_torch.parallel.halo import HaloResult

__all__ = [
    "Domain", "GridEdges", "GridRedistribute", "HaloResult", "MoverCapacity",
    "ProcessGrid", "RedistributeResult", "redistribute",
]
