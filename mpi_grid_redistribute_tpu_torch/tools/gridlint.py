"""``python -m mpi_grid_redistribute_tpu_torch.tools.gridlint [PATH ...]
[--check] [--format text|json|sarif|github]``: the port's AST invariant
checker (the twin of the JAX package's ``scripts/gridlint.py``; the rule
driver is ``analysis/core.py``, the CLI ``analysis/cli.py``, the rules
``analysis/rules_*.py``). It imports nothing it scans and needs no card.
"""

import sys

from mpi_grid_redistribute_tpu_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
