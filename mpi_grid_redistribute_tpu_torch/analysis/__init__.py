"""The port's analysis plane, as far as its tools need it (the JAX
package's ``analysis/``):

* :mod:`.core`: :class:`Finding` and the exit codes (0 clean, 1 findings,
  2 usage error);
* :mod:`.sarif`: SARIF 2.1.0 documents and GitHub annotation lines;
* :mod:`.baseline`: the committed baselines of the port's checkers
  (``progprofile_baseline.json``, the collective bytes of every
  registered program; ``storecheck_baseline.json``;
  ``incident_demo_baseline.json``; ``telemetry/attribution_baseline.json``);
* :mod:`.progcheck`: the program registry (``ProgramSpec``,
  ``default_programs``, the J000 coverage rule). Imported on demand: its
  programs build the port's engines.
"""

from mpi_grid_redistribute_tpu_torch.analysis.core import Finding

__all__ = ["Finding"]
