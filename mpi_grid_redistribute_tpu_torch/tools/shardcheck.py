"""``python -m mpi_grid_redistribute_tpu_torch.tools.shardcheck``: S004
and the DCN-ratio gate over the program registry (the port's counterpart
of the JAX package's ``scripts/shardcheck.py``; the analysis is
``analysis/shardcheck.py``). On the card unless given ``--device cpu``.
"""

import sys

from mpi_grid_redistribute_tpu_torch.analysis.shardcheck import main

if __name__ == "__main__":
    sys.exit(main())
