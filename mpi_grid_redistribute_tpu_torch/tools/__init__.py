"""Command-line tools over the port's telemetry (the twins of the JAX
package's ``scripts/``), each run as ``python -m
mpi_grid_redistribute_tpu_torch.tools.<name>``:

* :mod:`.incident`: list, show and export flight-recorder bundles;
* :mod:`.metrics_serve`: ``/metrics``, ``/healthz``, ``/query``,
  ``/events`` and ``/incidents`` over a journal, a store or a live demo;
* :mod:`.bench_check`: the regression gate over the port's captures.
"""
