"""The span tables (``bench/knockout_stages.py``, ``bench/knockout_pipeline.py``,
``bench/knockout_deposit.py``) on the CPU: each reads the program's own
spans in one profiled run of the whole, uncut loop
(``telemetry.phases``). Every row of every table is there, in order, a
running sum with its roofline; the rows add up to the enclosing span's
time (``mig:init`` and ``mig:step`` for the migrate loop, the whole
call for the deposit and the pipelined chunk), read from the same trace
by another route; and the profiled call's outputs are bit-equal to an
unprofiled run's, so the reading measures the loop as it runs. The
loops themselves are held against the reference in
``tests/test_torch_migrate.py``, ``_migrate_sparse``, ``_pipeline`` and
``_deposit``."""

import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu_torch.bench import (
    knockout_deposit, knockout_pipeline, knockout_stages,
)
from mpi_grid_redistribute_tpu_torch.telemetry import phases as phases_lib

GRID = (2, 2, 2)
N = 512
STEPS = 3
MESH = 16  # the deposit's mesh cells per axis at the CPU's size
HBM = 3.35e12

# table -> (the spans it reads, the enclosing spans of its whole: None is
# the whole call)
TABLES = {
    "stages-auto": (knockout_stages.PHASES, ("mig:init", "mig:step")),
    "stages-planar": (knockout_stages.PLANAR_PHASES, ("mig:step",)),
    "deposit": (knockout_deposit.PHASES, (None,)),
    "pipeline": (knockout_pipeline.PHASES, (None,)),
}
# rows that open no span in these runs: the sparse guard holds every
# step (no dense fallback), and the pipelined chunk's probes are not armed
ZERO_ROWS = {("stages-auto", "mig:fallback"), ("pipeline", "pipe:probe")}


def _build(table):
    """``(loop, args, whole)`` of a table at the CPU's size."""
    if table.startswith("stages"):
        engine = table.split("-")[1]
        return (knockout_stages.make_loop(GRID, N, STEPS, engine, "cpu"),
                knockout_stages.make_state(GRID, N, "cpu"),
                knockout_stages.WHOLE)
    if table == "deposit":
        return (knockout_deposit.make_loop(2, MESH),
                knockout_deposit.make_state(GRID, N, "cpu"), None)
    st = knockout_pipeline.make_state(GRID, N, "cpu")
    return knockout_pipeline.make_loop(GRID, N, st, STEPS), st, None


_RUNS = {}


def _run(table):
    """``(out, trace, rows, steps)``: one profiled call of the table's
    loop (after its warm call) and its rows, once a module."""
    if table not in _RUNS:
        loop, args, whole = _build(table)
        out, trace = phases_lib.profile_call(loop, args, "cpu")
        steps = 2 if table == "deposit" else STEPS
        rows = phases_lib.phase_rows(trace, TABLES[table][0], whole=whole,
                                     steps=steps)
        _RUNS[table] = (out, trace, rows, steps)
    return _RUNS[table]


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def _u8(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("table,row", [
    (table, row) for table, (spans, _) in TABLES.items()
    for row in list(spans) + [phases_lib.REST]])
def test_every_span_row_is_read(table, row):
    """The row is the table's, in its place; its time is a share of a
    step, zero where its span never opened, and ``cumulative_s`` is the
    running sum."""
    _, _, rows, _ = _run(table)
    names = [r.phase for r in rows]
    assert names == list(TABLES[table][0]) + [phases_lib.REST]
    i = names.index(row)
    r = rows[i]
    if (table, row) in ZERO_ROWS:
        assert r.delta_s == 0.0
    elif row != phases_lib.REST:
        assert r.delta_s > 0.0
    else:
        assert r.delta_s >= 0.0
    assert r.cumulative_s == pytest.approx(
        sum(x.delta_s for x in rows[:i + 1]), rel=1e-12, abs=1e-15)


@pytest.mark.parametrize("table", list(TABLES))
def test_rows_add_up_and_the_outputs_are_an_unprofiled_runs(table):
    """The rows add up to the enclosing spans' time a step within 1%,
    that time read from the trace as the operations launched inside any
    of them; and the profiled call gave the bits an unprofiled one
    does."""
    out, trace, rows, steps = _run(table)
    whole = sum(trace.seconds_in(w) for w in TABLES[table][1]) / steps
    assert whole > 0
    assert sum(r.delta_s for r in rows) == pytest.approx(whole, rel=0.01)
    assert rows[-1].cumulative_s == pytest.approx(whole, rel=0.01)
    loop, args, _ = _build(table)
    want = _tensors(loop(*args))
    got = _tensors(out)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(_u8(g), _u8(w))


def test_stage_table_attributes_the_sparse_engine():
    """The cells' engine: every step of the profiled call took the
    sparse fast branch, and the table names its selection, the guard's
    one read a step and the fast branch's pack and unpack."""
    out, _, rows, _ = _run("stages-auto")
    stats = out[3]
    assert stats.fast_path is not None
    assert bool((stats.fast_path == 1).all())
    assert int(stats.sent.sum()) > 0  # rows did migrate
    by = {r.phase: r.delta_s for r in rows}
    for name in ("mig:select", "sync:sparse_guard", "mig:pack",
                 "mig:unpack"):
        assert by[name] > 0, name
    assert by["mig:fallback"] == 0.0


@pytest.mark.parametrize("mod", [knockout_stages, knockout_pipeline,
                                 knockout_deposit])
def test_attribution_rows_on_the_cpu(mod):
    kw = {"mesh_cells": MESH} if mod is knockout_deposit else {}
    rows = mod.run(256, GRID, device="cpu", steps=2, **kw)
    assert [r.phase for r in rows] == list(mod.PHASES) + [phases_lib.REST]
    assert all(isinstance(r, phases_lib.PhaseTiming) for r in rows)
    # the roofline column divides a row's logical bytes by HBM3's 3.35
    # TB/s, where the row has a count
    assert rows[0].logical_bytes is not None
    for r in rows:
        assert (r.logical_bytes is None) == (r.roofline_s is None)
        if r.logical_bytes is not None:
            assert r.roofline_s == pytest.approx(r.logical_bytes / HBM)
    assert np.isclose(rows[-1].cumulative_s, sum(x.delta_s for x in rows))
