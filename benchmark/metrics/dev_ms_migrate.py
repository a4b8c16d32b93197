"""Device time a step of the operations launched inside the program's
``mig:step`` range: drift, wrap and bin, the mover selection, the grants,
the gathers and the landing."""

NAME = "dev_ms.migrate"
UNIT = "ms"
LAYER = "parallel/migrate with ops/binning"
MOVES = "particles_per_s"
SOURCE = "device_trace"


def read(ctx):
    n = ctx.trace.count("mig:step")
    us = ctx.trace.device_us_in("mig:step")
    if n == 0 or us == 0.0:
        return None
    return us / n / 1e3
