"""Device time a deposit of the operations launched inside the program's
``dep:sort`` ranges of the scan deposit: the stable sort by key and the
payload's gather into sorted order. The five ``dev_ms.dep_*`` add up to
``dev_ms.deposit``."""

NAME = "dev_ms.dep_sort"
UNIT = "ms"
LAYER = "ops/deposit"
MOVES = "particles_per_s"
SOURCE = "device_trace"


def read(ctx):
    n = ctx.trace.count("dep:deposit")
    us = ctx.trace.device_us_in("dep:sort")
    if n == 0 or us == 0.0:
        return None
    return us / n / 1e3
