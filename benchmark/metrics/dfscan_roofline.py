"""Kernel 5 (``ops/dfscan``, the double-float channel prefixes of the scan
deposit) against its roofline: the counted bytes and flops of one launch
at the card's peaks over the mean device time of a launch in the trace."""

from benchmark import costs

NAME = "dfscan_roofline"
UNIT = "%"
LAYER = "kernel 5, ops/dfscan"
MOVES = "particles_per_s"
SOURCE = "device_trace"


def read(ctx):
    d = ctx.trace.kernel_durations("dfscan_kernel")
    if not d or ctx.cell.deposit_shape is None:
        return None
    _, rows, tile = costs.dfscan_launches(ctx.cell)
    b, f = costs.dfscan_cost(rows, tile)
    bound = costs.bound_s(b, f, ctx.kind)
    if bound is None:
        return None
    return 100.0 * bound / (sum(d) / len(d) * 1e-6)
