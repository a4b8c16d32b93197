"""Device time a call of the operations launched inside the program's
``mig:init`` range: the loop's per-call set-up (the fused state's
``torch.cat`` and ``migrate.init_state``'s argsort over every slot)."""

NAME = "dev_ms.init"
UNIT = "ms"
LAYER = "models/nbody loop"
MOVES = "particles_per_s"
SOURCE = "device_trace"


def read(ctx):
    n = ctx.trace.count("mig:init")
    us = ctx.trace.device_us_in("mig:init")
    if n == 0 or us == 0.0:
        return None
    return us / n / 1e3
