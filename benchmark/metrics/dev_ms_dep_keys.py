"""Device time a deposit of the operations launched inside the program's
``dep:keys`` ranges of the scan deposit: the keys: the valid rows, the
unit mass, each row's cell key and block-local coordinates. The five
``dev_ms.dep_*`` add up to ``dev_ms.deposit``."""

NAME = "dev_ms.dep_keys"
UNIT = "ms"
LAYER = "ops/deposit"
MOVES = "particles_per_s"
SOURCE = "device_trace"


def read(ctx):
    n = ctx.trace.count("dep:deposit")
    us = ctx.trace.device_us_in("dep:keys")
    if n == 0 or us == 0.0:
        return None
    return us / n / 1e3
