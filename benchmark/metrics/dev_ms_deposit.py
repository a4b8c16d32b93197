"""Device time a deposit of the operations launched inside the program's
``dep:deposit`` range (the CIC deposit after each step)."""

NAME = "dev_ms.deposit"
UNIT = "ms"
LAYER = "ops/deposit"
MOVES = "particles_per_s"
SOURCE = "device_trace"


def read(ctx):
    n = ctx.trace.count("dep:deposit")
    us = ctx.trace.device_us_in("dep:deposit")
    if n == 0 or us == 0.0:
        return None
    return us / n / 1e3
