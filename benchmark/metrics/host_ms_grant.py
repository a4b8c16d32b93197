"""Host time a step in the grant fixpoint: the host duration of the
program's ``mig:grant`` ranges (``parallel/migrate._grant_tables``, whose
``V`` Python iterations issue the grant tables' small ops) over the
steps."""

NAME = "host_ms.grant"
UNIT = "ms"
LAYER = "parallel/migrate with ops/binning"
MOVES = "particles_per_s"
SOURCE = "program_span"


def read(ctx):
    n = ctx.trace.count("mig:step")
    if n == 0 or ctx.trace.count("mig:grant") == 0:
        return None
    return ctx.trace.host_us("mig:grant") / n / 1e3
