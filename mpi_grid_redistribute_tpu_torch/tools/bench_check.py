"""The bench regression gate over the port's captures (the twin of the
JAX package's ``scripts/bench_check.py``): the CLI of
:mod:`..telemetry.regress`.

    python -m mpi_grid_redistribute_tpu_torch.tools.bench_check \\
        --history 'captures/*.json' [--current CAPTURE.json] \\
        [--threshold 0.10] [--legacy]

``--history`` is required and must hold the port's captures only (a
history with a TPU capture in it is refused, exit 2). Exit 0 = no
REGRESSION, 1 = a REGRESSION, 2 = nothing to compare or a mixed history.
"""

import sys

from mpi_grid_redistribute_tpu_torch.telemetry.regress import main

if __name__ == "__main__":
    sys.exit(main())
