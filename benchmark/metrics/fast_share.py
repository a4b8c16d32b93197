"""Share of the traced steps the sparse engine ran on its fast branch: the
program's ``mig:step`` ranges less its ``mig:fallback`` ranges (the dense
step that runs when the sparse guard reads false) over the ``mig:step``
ranges. ``None`` with no step traced, and where no step took the fast
branch, so the share never reads 0."""

NAME = "fast_share"
UNIT = "%"
LAYER = "parallel/migrate with ops/binning"
MOVES = "particles_per_s"
SOURCE = "program_span"


def read(ctx):
    n = ctx.trace.count("mig:step")
    fast = n - ctx.trace.count("mig:fallback")
    if n == 0 or fast <= 0:
        return None
    return 100.0 * fast / n
