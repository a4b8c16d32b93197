"""The port's spans and host-read counter (``telemetry.phases``): the
drift loop's ranges under ``torch.profiler`` at a toy size on the CPU
(``mig:init`` once a call; ``mig:grant`` and ``sync:sparse_guard`` once a
step inside ``mig:step``; the scan deposit's five phases inside
``dep:deposit``), the ``sync:*`` ranges against the ``HOST_SYNCS``
counters, the shared no-op when nothing records, and the ``costcount``
regions progcheck reads. The card case holds the ``sync:*`` count of a
step to what ``torch.cuda.set_sync_debug_mode("warn")`` reports.

This file imports no JAX, so its card case runs on a machine without it:

    python -m pytest tests/test_torch_spans.py -m cuda --noconftest
"""

import json
import warnings

import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu_torch.bench import common
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.models import nbody
from mpi_grid_redistribute_tpu_torch.ops import deposit
from mpi_grid_redistribute_tpu_torch.parallel import migrate
from mpi_grid_redistribute_tpu_torch.telemetry import phases
from mpi_grid_redistribute_tpu_torch.utils import costcount

GRID = (2, 2, 2)
DEP_PHASES = ("dep:keys", "dep:sort", "dep:bounds", "dep:prefix",
              "dep:place")


def _loop(steps, device="cpu", n_local=256, deposit_shape=(8, 8, 8)):
    """The benchmark's loop at a toy size: the sparse engine on 8 vranks
    of one device, 2% migration, a scan deposit after every step (none
    when ``deposit_shape`` is ``None``); and its first inputs, planar on
    ``device``."""
    v, cap, budget = common.drift_sizing(GRID, n_local, 0.9, 0.02)
    pos, vel, alive = common.uniform_state(
        GRID, n_local, 0.9, np.random.default_rng(7), vel_scale=v)
    cfg = nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True), grid=ProcessGrid((1, 1, 1)),
        dt=1.0, capacity=cap, n_local=n_local, local_budget=budget,
        deposit_shape=deposit_shape, deposit_method="scan",
    )
    loop = nbody.make_migrate_loop(
        cfg, steps, vgrid=ProcessGrid(GRID), device=device,
        deposit_each_step=deposit_shape is not None)
    state = tuple(torch.as_tensor(nbody.rows_to_planar(a, 1)).to(device)
                  for a in (pos, vel))
    return loop, state + (torch.as_tensor(alive).to(device),)


def _call(loop, state):
    out = loop(*state)
    return out, (out[0], out[1], out[2])


def _syncs():
    return (sum(migrate.HOST_SYNCS.values())
            + sum(deposit.HOST_SYNCS.values()))


def _ranges(prof, tmp_path):
    """``(name, start, end)`` of the trace's ``record_function`` ranges,
    by start (microseconds)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(out, key=lambda r: r[1])


def _inside(r, outer):
    return outer[1] <= r[1] and r[2] <= outer[2]


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def test_loop_spans_under_the_profiler(tmp_path):
    """Two calls of 3 steps: ``mig:init`` once a call before its steps;
    ``mig:grant`` and ``sync:sparse_guard`` once a step, each inside its
    ``mig:step``; every ``dep:deposit`` holds the five phase spans and
    every phase span lies in a ``dep:deposit``; the ``sync:*`` ranges
    number the reads ``HOST_SYNCS`` counted."""
    calls, steps = 2, 3
    loop, state = _loop(steps)
    _, state = _call(loop, state)  # warm: the device constants
    before = _syncs()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            _, state = _call(loop, state)
    reads = _syncs() - before
    rs = _ranges(prof, tmp_path)
    inits = _named(rs, "mig:init")
    mig_steps = _named(rs, "mig:step")
    assert len(inits) == calls and len(mig_steps) == calls * steps
    for c, init in enumerate(inits):
        assert init[2] <= mig_steps[c * steps][1]
    for name in ("mig:grant", "sync:sparse_guard"):
        got = _named(rs, name)
        assert len(got) == calls * steps, name
        assert all(any(_inside(r, s) for s in mig_steps) for r in got)
    syncs = [r for r in rs if r[0].startswith("sync:")]
    assert len(syncs) == reads == calls * steps
    deposits = _named(rs, "dep:deposit")
    assert len(deposits) == calls * steps
    phase_ranges = [r for r in rs if r[0] in DEP_PHASES]
    for d in deposits:
        assert {r[0] for r in phase_ranges if _inside(r, d)} == \
            set(DEP_PHASES)
    assert all(any(_inside(r, d) for d in deposits) for r in phase_ranges)
    assert all(r[0].startswith(phases.SPAN_PREFIXES) for r in rs)


def test_spans_are_one_noop_when_nothing_records():
    """No profiler and no recording: every span is the shared no-op, and
    a host read still counts and still reads."""
    assert not torch.autograd._profiler_enabled()
    assert phases.span("mig:step") is phases.span("dep:keys") is \
        phases._NOOP
    assert phases.traced_span("mig:fast") is phases._NOOP
    counter = {"guard": 0}
    assert phases.host_read(counter, "guard", torch.tensor(True)) is True
    assert phases.host_read(counter, "guard", torch.tensor(False)) is False
    assert counter == {"guard": 2}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert phases.span("mig:step") is not phases._NOOP
        assert phases.traced_span("mig:fast") is not phases._NOOP


def test_costcount_recording_keeps_its_regions():
    """With no profiler, a recording ``costcount`` block still gets the
    engine's ``mig:fast`` region (what progcheck's J003 reads), and the
    ranges open while it records."""
    loop, state = _loop(1, n_local=64, deposit_shape=None)
    _call(loop, state)
    with costcount.counting(record=True) as counter:
        assert phases.span("mig:step") is not phases._NOOP
        _call(loop, state)
    regions = [(e.kind, e.name) for e in counter.events
               if e.kind in ("enter", "exit")]
    assert ("enter", "mig:fast") in regions
    assert ("exit", "mig:fast") in regions
    assert phases.span("mig:step") is phases._NOOP


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sync_spans_match_sync_debug_mode_on_card(cuda, tmp_path):
    """One step with its deposit on the card: the reads the sync debug
    mode warns of equal the ``HOST_SYNCS`` delta, and a profiled step
    opens as many ``sync:*`` ranges: every read goes through
    ``telemetry.phases.host_read``."""
    loop, state = _loop(1, device=cuda, n_local=1 << 14,
                        deposit_shape=(32, 32, 32))
    for _ in range(2):  # the kernels' build and the device constants
        _, state = _call(loop, state)
    torch.cuda.synchronize()
    before = _syncs()
    # set outside the block: turning the mode on warns once by itself
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, state = _call(loop, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    warned = sum("synchroniz" in str(w.message) for w in caught)
    assert warned == _syncs() - before == 1
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, state = _call(loop, state)
        torch.cuda.synchronize()
    syncs = [r for r in _ranges(prof, tmp_path) if r[0].startswith("sync:")]
    assert [r[0] for r in syncs] == ["sync:sparse_guard"]
