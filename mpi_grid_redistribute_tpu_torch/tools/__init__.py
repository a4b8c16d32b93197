"""Command-line tools over the port's telemetry (the twins of the JAX
package's ``scripts/``), each run as ``python -m
mpi_grid_redistribute_tpu_torch.tools.<name>``:

* :mod:`.incident`: list, show and export flight-recorder bundles;
* :mod:`.metrics_serve`: ``/metrics``, ``/healthz``, ``/query``,
  ``/events`` and ``/incidents`` over a journal, a store or a live demo;
* :mod:`.bench_check`: the regression gate over the port's captures;
* :mod:`.trace_export`: a journal, knockout phase rows or a demo run as a
  Perfetto trace;
* :mod:`.grid_top`: a terminal dashboard over a store or a
  ``metrics_serve`` endpoint;
* :mod:`.history`: the run index over the port's captures and stores;
* :mod:`.storecheck`: the journal store's on-disk contract (ST01-ST07);
* :mod:`.incident_demo`: the incident loop end to end (I001-I004);
* :mod:`.attribution`: the knockout and roofline snapshot, its
  ``PERF.md`` tables and their structural gate (A001-A003).
"""
