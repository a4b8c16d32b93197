"""Device time a deposit of the operations launched inside the program's
``dep:place`` ranges of the scan deposit: the boundary gathers and
differences per channel group, the corner placement and the ghost fold.
The five ``dev_ms.dep_*`` add up to ``dev_ms.deposit``."""

NAME = "dev_ms.dep_place"
UNIT = "ms"
LAYER = "ops/deposit"
MOVES = "particles_per_s"
SOURCE = "device_trace"


def read(ctx):
    n = ctx.trace.count("dep:deposit")
    us = ctx.trace.device_us_in("dep:place")
    if n == 0 or us == 0.0:
        return None
    return us / n / 1e3
