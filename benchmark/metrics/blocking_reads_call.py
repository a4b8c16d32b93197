"""Blocking host reads of the overflow counters a traced call of the
one-shot cells: the growth of ``GridRedistribute.report()``'s
``blocking_fetches`` over the traced calls. Under ``on_overflow="grow"``
a calibrated instance reads them one window later without a wait, so the
count is 0 once the first calls have calibrated it."""

NAME = "blocking_reads.call"
UNIT = "reads"
LAYER = "api GridRedistribute"
MOVES = "particles_per_s"
SOURCE = "program_counter"


def read(ctx):
    if ctx.cell.entry != "redistribute" or not ctx.stats.get("calls"):
        return None
    return ctx.stats["blocking_fetches"] / ctx.stats["calls"]
