"""The service plane of the port (the JAX package's ``service``
package): the drift -> redistribute loop as an always-on supervised
service.

* :mod:`.driver`: :class:`ServiceDriver` and :class:`DriverConfig`, the
  checkpointed loop (snapshot cadence, journal export, watchdog,
  health-driven degrade, SLO-breach failures, the closed rebalance loop)
  and the CLI ``python -m mpi_grid_redistribute_tpu_torch.service``;
* :mod:`.supervisor`: :class:`Supervisor` and :class:`RestartPolicy`,
  restore from the latest valid snapshot with jittered backoff, a
  crash-loop circuit breaker and the repeated-breach grid shrink;
* :mod:`.faults`: the deterministic fault injectors (:class:`FaultPlan`);
* :mod:`.elastic`: :func:`reshard_state` (restore onto another grid) and
  :func:`particle_set`, the audit two runs are held to;
* :mod:`.resident`: :func:`make_chunk_fn`, ``chunk`` steps issued back
  to back with nothing read back to the host;
* :mod:`.pipeline`: :func:`make_pipelined_chunk_fn`, the
  software-pipelined chunk over the two-phase exchange.
"""

from mpi_grid_redistribute_tpu_torch.service.driver import (  # noqa: F401
    DriverConfig,
    ServiceDriver,
)
from mpi_grid_redistribute_tpu_torch.service.elastic import (  # noqa: F401
    ElasticRestoreError,
    ReshardedState,
    gather_live,
    particle_set,
    reshard_state,
)
from mpi_grid_redistribute_tpu_torch.service.faults import (  # noqa: F401
    CrashFault,
    DeviceLossFault,
    FallbackFloodFault,
    FaultPlan,
    InjectedCrash,
    JournalShardLossFault,
    LatencySpikeFault,
    SLOBreachError,
    StallError,
    StallFault,
    StateCorruptionError,
    StateCorruptionFault,
    TornSnapshotFault,
)
from mpi_grid_redistribute_tpu_torch.service.pipeline import (  # noqa: F401
    make_pipelined_chunk_fn,
)
from mpi_grid_redistribute_tpu_torch.service.resident import (  # noqa: F401
    ResidentLayoutError,
    final_stats,
    make_chunk_fn,
)
from mpi_grid_redistribute_tpu_torch.service.supervisor import (  # noqa: F401
    RestartPolicy,
    Supervisor,
    SupervisorVerdict,
)

__all__ = [
    "CrashFault",
    "DeviceLossFault",
    "DriverConfig",
    "ElasticRestoreError",
    "FallbackFloodFault",
    "FaultPlan",
    "InjectedCrash",
    "JournalShardLossFault",
    "LatencySpikeFault",
    "ReshardedState",
    "ResidentLayoutError",
    "RestartPolicy",
    "SLOBreachError",
    "ServiceDriver",
    "StallError",
    "StallFault",
    "StateCorruptionError",
    "StateCorruptionFault",
    "Supervisor",
    "SupervisorVerdict",
    "TornSnapshotFault",
    "final_stats",
    "gather_live",
    "make_chunk_fn",
    "make_pipelined_chunk_fn",
    "particle_set",
    "reshard_state",
]
