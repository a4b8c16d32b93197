"""PyTorch/CUDA port of ``mpi_grid_redistribute_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
neither it nor JAX. Ported so far: the single-device drift/migrate loop
(:func:`.models.nbody.make_migrate_loop` with ``engine="planar"``) on the
resident-slot vrank engine, with two hand-written CUDA kernels
(``csrc/driftbin.cu``, ``csrc/overlay.cu``) that are compiled with
``nvcc`` at first use. Entry points run on the GPU unless the caller
passes ``device="cpu"``, where every kernel runs as its plain PyTorch
version.
"""

from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid

__all__ = ["Domain", "ProcessGrid"]
