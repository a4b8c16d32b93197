"""PyTorch/CUDA port of ``mpi_grid_redistribute_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
neither it nor JAX. Ported so far, all on ONE device with the ranks of
the grid as virtual ranks:

  * the canonical :class:`GridRedistribute` ``.redistribute()`` (the
    planar and row-major engines; ``engine="auto"`` picks planar) with its
    NumPy oracle (:mod:`.oracle`) and non-uniform :class:`GridEdges`,
    ``.apply_assignment()``, and the functional :func:`redistribute` and
    :func:`.api.reshard`;
  * the halo exchange ``GridRedistribute.halo()`` (:class:`HaloResult`;
    the planar and row-major vrank engines of :mod:`.parallel.halo`),
    with the set-level ghost oracle ``oracle.brute_force_ghosts``;
  * the drift/migrate loop (:func:`.models.nbody.make_migrate_loop`, the
    mover-sparse and planar engines, the row-store landing route) and the
    config-5 CIC deposit fused into it.

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
