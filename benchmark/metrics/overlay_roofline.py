"""Kernel 2 (``ops/overlay``, the landing) against its roofline. Its bytes
depend on the rows it lands: a step's in-range targets are, for each of
this card's vranks, the larger of the rows it sent and the rows it took
from its own card, read from the traced steps' ``MigrateStats``. One
launch a step; the share is the steps' bound over their summed time."""

from benchmark import costs

NAME = "overlay_roofline"
UNIT = "%"
LAYER = "kernel 2, ops/overlay"
MOVES = "particles_per_s"
SOURCE = "device_trace"


def read(ctx):
    d = ctx.trace.kernel_durations("overlay_kernel")
    sent, flow = ctx.stats.get("sent"), ctx.stats.get("flow")
    if not d or sent is None or len(d) != len(sent):
        return None
    cell = ctx.cell
    mine = range(ctx.rank * cell.V, (ctx.rank + 1) * cell.V)
    targets = costs.overlay_targets(cell)
    nbytes = 0
    for t in range(len(sent)):
        n_ok = sum(max(int(sent[t, v]), int(flow[t, list(mine), v].sum()))
                   for v in mine)
        nbytes += costs.overlay_cost(targets, n_ok)[0]
    bound = costs.bound_s(nbytes, 0, ctx.kind)
    if bound is None:
        return None
    return 100.0 * bound / (sum(d) * 1e-6)
