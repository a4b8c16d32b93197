"""The service plane of the port (the JAX package's ``service``
package, its chunked stepping so far):

* :mod:`.resident`: :func:`make_chunk_fn`, ``chunk`` drift ->
  redistribute steps issued back to back with nothing read back to the
  host, :class:`ResidentLayoutError`, :func:`final_stats`;
* :mod:`.pipeline`: :func:`make_pipelined_chunk_fn`, the
  software-pipelined sibling over the two-phase exchange, degrading to
  the sequential chunk where it cannot arm;
* :mod:`.elastic`: :func:`particle_set`, the particle-set audit two runs
  are held to.

The service driver, its supervisor, the fault injectors and
``reshard_state`` are not ported yet.
"""

from mpi_grid_redistribute_tpu_torch.service.elastic import (  # noqa: F401
    gather_live,
    particle_set,
)
from mpi_grid_redistribute_tpu_torch.service.pipeline import (  # noqa: F401
    make_pipelined_chunk_fn,
)
from mpi_grid_redistribute_tpu_torch.service.resident import (  # noqa: F401
    ResidentLayoutError,
    final_stats,
    make_chunk_fn,
)

__all__ = [
    "ResidentLayoutError",
    "final_stats",
    "gather_live",
    "make_chunk_fn",
    "make_pipelined_chunk_fn",
    "particle_set",
]
