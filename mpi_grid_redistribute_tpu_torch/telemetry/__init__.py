"""Telemetry core of the port: the journal, its reports and its views (the
JAX package's ``telemetry`` package, its host-side core).

* :mod:`.context`: thread-local step context merged into every event;
* :mod:`.recorder`: the bounded event ring with JSON Lines export; every
  :class:`~..api.GridRedistribute` owns one as ``rd.telemetry``;
* :mod:`.metrics`: Counter/Gauge/Histogram registry, journal replay into
  the grid metric families, OpenMetrics text (``rd.metrics()``);
* :mod:`.flow`: per-link flow matrices, the flow accumulator and the
  per-link report (``rd.flow()``);
* :mod:`.health`: the rule monitor over the journal (``rd.health()``);
* :mod:`.report`: the merged metrics dict (``rd.report()``);
* :mod:`.traceview`: Chrome-trace/Perfetto export (``rd.to_perfetto()``);
* :mod:`.phases`: phase attribution and ``torch.profiler`` spans;
* :mod:`.profiler`: a gated ``torch.profiler`` session.

Journaling is host-side only and never reads the device; ``report()`` and
``flow()`` read the last call's stats once. Event kinds, payload keys and
metric families are the JAX package's (its ``telemetry/SCHEMA.md``).
"""

from mpi_grid_redistribute_tpu_torch.telemetry.context import (  # noqa: F401
    StepContext,
    current,
    envelope_fields,
    scoped,
    use,
)
from mpi_grid_redistribute_tpu_torch.telemetry.recorder import (  # noqa: F401
    Event,
    StepRecorder,
    fast_path_hit_rate,
    record_chunk_steps,
    record_fast_path_steps,
    record_migrate_steps,
)
from mpi_grid_redistribute_tpu_torch.telemetry.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    from_journal,
    pow2_edges,
    render_openmetrics,
)
from mpi_grid_redistribute_tpu_torch.telemetry.flow import (  # noqa: F401
    FlowAccumulator,
    flow_matrix_of,
    link_report,
    record_flow_snapshot,
    top_pairs,
)
from mpi_grid_redistribute_tpu_torch.telemetry.health import (  # noqa: F401
    ALERT,
    OK,
    WARN,
    Finding,
    HealthMonitor,
    HealthRule,
    backlog_growth,
    bounds_violation,
    burn_rate_dropped,
    burn_rate_latency,
    capacity_grow_frequency,
    conservation_drift,
    default_rules,
    dropped_rows,
    fast_path_fallback,
    imbalance_ratio,
    nan_detected,
    slo_dropped_rows,
    slo_latency_p99,
    snapshot_staleness,
    step_time_spike,
)
from mpi_grid_redistribute_tpu_torch.telemetry.report import (  # noqa: F401
    exchange_report,
    format_report,
    row_bytes_of,
)
from mpi_grid_redistribute_tpu_torch.telemetry.traceview import (  # noqa: F401
    to_chrome_trace,
    write_trace,
)
from mpi_grid_redistribute_tpu_torch.telemetry.phases import (  # noqa: F401
    PhaseTiming,
    attribute_phases,
    format_phase_table,
    span,
    traced_span,
)
from mpi_grid_redistribute_tpu_torch.telemetry.profiler import (  # noqa: F401
    ProfilerSession,
    profile_dir_from_env,
)
