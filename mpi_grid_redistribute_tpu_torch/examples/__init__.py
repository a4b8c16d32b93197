"""Runnable examples of the port (``python -m
mpi_grid_redistribute_tpu_torch.examples.<name>``):

* :mod:`.drift_demo`: redistribute, check ownership, drift with a
  migrate every step, read the observatory; the twin of the JAX
  package's ``examples/drift_demo.py``.
"""
