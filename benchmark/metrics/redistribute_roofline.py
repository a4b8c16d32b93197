"""The one-shot call against its byte floor: 48 bytes a live row (its 24
bytes read once and written once, ``costs.redistribute_floor_bytes``) at
the card's bandwidth, over the device time a call inside ``bench:call``.
The floor counts the same work whatever implements the call, so the share
cannot pass 100%."""

from benchmark import costs, trace

NAME = "redistribute_roofline"
UNIT = "%"
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
    bound = costs.bound_s(costs.redistribute_floor_bytes(ctx.cell.live_total),
                          0, ctx.kind)
    if bound is None:
        return None
    return 100.0 * bound / (us / n * 1e-6)
