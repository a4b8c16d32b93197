"""Host time a step of the loop: the mean host duration of the program's
``mig:step`` range (the host's Python work for one drift + migrate step)."""

NAME = "host_ms.step"
UNIT = "ms"
LAYER = "models/nbody loop"
MOVES = "particles_per_s"
SOURCE = "program_span"


def read(ctx):
    n = ctx.trace.count("mig:step")
    if n == 0:
        return None
    return ctx.trace.host_us("mig:step") / n / 1e3
