"""Megabytes a card sends to other cards a step: the rows of the traced
steps' ``MigrateStats.flow`` whose source and destination vranks lie on
different cards, 28 bytes a row, over the steps and the cards."""

from benchmark.costs import ROW_BYTES

NAME = "wire_mb.step"
UNIT = "MB"
LAYER = "parallel/collectives and parallel/mesh"
MOVES = "particles_per_s"
SOURCE = "program_counter"


def read(ctx):
    cell = ctx.cell
    flow = ctx.stats.get("flow")
    if cell.chips == 1 or flow is None or len(flow) == 0:
        return None
    R = flow.shape[-1]
    card = [r // cell.V for r in range(R)]
    rows = sum(int(flow[:, s, d].sum()) for s in range(R) for d in range(R)
               if card[s] != card[d])
    return rows * ROW_BYTES / len(flow) / cell.chips / 1e6
