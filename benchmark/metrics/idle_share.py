"""Share of the traced window in which no kernel, copy or set ran on the
card; across cards, the share of the cards' summed windows."""

NAME = "idle_share"
UNIT = "%"
LAYER = "device (H100)"
MOVES = "particles_per_s"
SOURCE = "device_trace"


def read(ctx):
    busy = sum(b for b, _ in ctx.cards)
    window = sum(w for _, w in ctx.cards)
    if window <= 0.0 or busy <= 0.0:
        return None
    return 100.0 * (1.0 - busy / window)
