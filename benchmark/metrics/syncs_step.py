"""Host reads of device values a step: the program's ``sync:*`` ranges
(one a read, counted in the program's ``HOST_SYNCS`` too) over its
``mig:step`` ranges."""

NAME = "syncs.step"
UNIT = "reads"
LAYER = "parallel/migrate with ops/binning"
MOVES = "particles_per_s"
SOURCE = "program_span"


def read(ctx):
    n = ctx.trace.count("mig:step")
    reads = sum(1 for name, _, _ in ctx.trace.ranges
                if name.startswith("sync:"))
    if n == 0 or reads == 0:
        return None
    return reads / n
