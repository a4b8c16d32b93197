"""Device time a call of the one-shot cells: the operations launched
inside the harness's ``bench:call`` range (the API's checks, the fuse, the
binning, the route, the pack, the wire transpose, the compaction and the
unfuse) over the traced calls."""

from benchmark import trace

NAME = "dev_ms.call"
UNIT = "ms"
LAYER = "parallel/exchange with ops/binning and ops/pack"
MOVES = "particles_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.cell.entry != "redistribute":
        return None
    n = ctx.trace.count(trace.CALL)
    us = ctx.trace.device_us_in(trace.CALL)
    if n == 0 or us == 0.0:
        return None
    return us / n / 1e3
