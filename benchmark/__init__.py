"""The benchmark of ``mpi_grid_redistribute_tpu_torch``: the periodic
drift-and-redistribute loop at deployment size on NVIDIA H100 cards.

Run one cell once::

    python -m benchmark.run --workload <config>.<mix> --seed <n> \\
        --seconds <s> --trace <0|1>

Everything a cell needs is found by name: ``configs/<config>.json``,
``traffic/<mix>.json`` and the per-layer readers in ``metrics/``. Nothing
in this package imports JAX or the JAX package; only :mod:`.program`
imports the port, and :mod:`.reference` imports neither.
"""
