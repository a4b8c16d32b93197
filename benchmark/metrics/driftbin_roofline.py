"""Kernel 1 (``ops/driftbin``, fused drift, wrap and bin) against its
roofline: the least time its counted bytes and flops take at the card's
peaks over the mean device time of a launch in the trace."""

from benchmark import costs

NAME = "driftbin_roofline"
UNIT = "%"
LAYER = "kernel 1, ops/driftbin"
MOVES = "particles_per_s"
SOURCE = "device_trace"


def read(ctx):
    d = ctx.trace.kernel_durations("driftbin_kernel")
    if not d:
        return None
    b, f = costs.driftbin_cost(costs.card_columns(ctx.cell))
    bound = costs.bound_s(b, f, ctx.kind)
    if bound is None:
        return None
    return 100.0 * bound / (sum(d) / len(d) * 1e-6)
