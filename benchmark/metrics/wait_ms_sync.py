"""Host time a step spent waiting on host reads of device values: the
host duration of the program's ``sync:*`` ranges (each one read, such as
the sparse engine's guard, ``sync:sparse_guard``) over the steps. The
host blocks there until the device has run what was issued before the
read."""

NAME = "wait_ms.sync"
UNIT = "ms"
LAYER = "parallel/migrate with ops/binning"
MOVES = "particles_per_s"
SOURCE = "program_span"


def read(ctx):
    n = ctx.trace.count("mig:step")
    waits = [e - s for name, s, e in ctx.trace.ranges
             if name.startswith("sync:")]
    if n == 0 or not waits:
        return None
    return sum(waits) / n / 1e3
