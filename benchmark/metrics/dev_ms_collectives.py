"""Device time a step of the NCCL kernels launched inside the program's
``coll:*`` ranges on this card (rank 0 in the line). An NCCL kernel runs
until its peers arrive, so this is the exchange and the wait for the
slowest card."""

NAME = "dev_ms.collectives"
UNIT = "ms"
LAYER = "parallel/collectives and parallel/mesh"
MOVES = "particles_per_s"
SOURCE = "device_trace"


def read(ctx):
    n = ctx.trace.count("mig:step")
    us = ctx.trace.device_us_in("coll:", kernel="nccl")
    if n == 0 or us == 0.0:
        return None
    return us / n / 1e3
