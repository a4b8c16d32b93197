"""``python -m mpi_grid_redistribute_tpu_torch.service``: the service
driver's CLI (:func:`.driver.main`), the port's always-on entry point.
It runs on the GPU unless ``--device cpu`` is given."""

import sys

from mpi_grid_redistribute_tpu_torch.service.driver import main

if __name__ == "__main__":
    sys.exit(main())
