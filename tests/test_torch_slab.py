"""Upstream config 3 as a benchmark cell: ``slab_8x8.m2_s4``, the (8, 8, 1)
slab grid held as 64 vranks on one device, run through the benchmark's
harness at a small width (the program against the plain reference, the
bfloat16 control, the slab table of the grid), the sparse engine's
``mig:fallback`` span, which opens exactly on the steps whose guard read
false, and the ``fast_share`` reader of it. The card case holds kernels 1
and 2 to the plain-version run at 2^16 slots a vrank.

This file imports no JAX, so its card case runs on a machine without it:

    python -m pytest tests/test_torch_slab.py -m cuda --noconftest
"""

import json
import types

import numpy as np
import pytest
import torch

from benchmark import reference, run, spec, state, trace
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.models import nbody

CONFIG, TRAFFIC = "slab_8x8", "m2_s4"
# the cell reports under the bare loop's metric names, and so its bounds, as
# the other cell of the drift loop without a deposit
SFX = ""
SEED = 2**31 + 22


def slab_cell(slots=4096):
    """The cell ``slab_8x8.m2_s4`` as its files give it, ``slots`` slots a
    vrank."""
    cfg = json.loads((spec.ROOT / "configs" / f"{CONFIG}.json").read_text())
    cfg["slots_per_vrank"] = slots
    tr = json.loads((spec.ROOT / "traffic" / f"{TRAFFIC}.json").read_text())
    return spec.make_cell(f"{CONFIG}.{TRAFFIC}", cfg, tr)


def measure(cell, seed, traced=0, control=None, seconds=0.3):
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=traced,
                                 control=control)
    res = run.run_local(args, cell, torch.device("cpu"))
    return run.assemble(cell, bool(traced), res, run.T0)


def test_cell_files_give_the_deployment():
    cell = spec.load_cell(f"{CONFIG}.{TRAFFIC}")
    assert (cell.grid, cell.dev_grid, cell.vgrid) == (
        (8, 8, 1), (1, 1, 1), (8, 8, 1))
    assert (cell.V, cell.chips, cell.metric_suffix) == (64, 1, SFX)
    assert cell.V * cell.n_local == 536_870_912
    assert cell.live_total == 483_183_808
    assert (cell.capacity, cell.budget) == (49_074, 196_294)
    assert cell.vel_scale == pytest.approx((0.0025,) * 3)
    assert cell.config["reduced"] == ["slots_per_vrank"]


def test_slab_cell_agrees_with_reference():
    """The timed path's output at 4096 slots a vrank: every particle on
    the slab owning it, none lost, duplicated or altered; the line's
    end-to-end metrics are the bare loop's, with no suffix."""
    line = measure(slab_cell(), SEED)
    assert line["correct"], line["checks"]
    for name in ("count_gap", "misplaced_rows", "slabs_differing"):
        assert line["checks"][name] == {"value": 0, "limit": 0}, name
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"particles_per_s" + SFX,
                                    "call_ms_p95" + SFX, "peak_mem_gib",
                                    "setup_s"}


def test_slab_traced_run_reads_fast_share():
    """A traced run: every traced step of the 64 vranks took the fast
    branch, so ``fast_share`` reads 100 beside the host spans."""
    line = measure(slab_cell(), SEED + 1, traced=1)
    assert line["correct"], line["checks"]
    got = line["metrics"]
    assert got["fast_share" + SFX] == {"value": 100.0, "unit": "%"}
    assert got["host_ms.grant" + SFX]["value"] > 0
    assert got["syncs.step" + SFX]["value"] == 1.0


@pytest.mark.parametrize("seed", [5, 2**31 + 99])
def test_slab_drift_bf16_control_fails(seed):
    line = measure(slab_cell(), seed, control="drift_bf16")
    assert not line["correct"]
    assert line["checks"]["slabs_differing"]["value"] > 0
    assert line["failed"] == line["attempted"]


def test_owner_slab_agrees_with_slab_table():
    """The reference's ownership, ``clip(floor(x * g))`` per axis, puts a
    point of each grid cell on the slab ``slab_of_cell_table`` gives that
    cell, and the rows the generator draws for slab ``s`` on ``s``."""
    cell = slab_cell(256)
    table = cell.slab_of_cell_table()
    assert sorted(table.tolist()) == list(range(64))
    g = np.asarray(cell.grid)
    cells = np.stack(np.meshgrid(*[np.arange(n) for n in g], indexing="ij"),
                     -1).reshape(-1, 3)
    flat = (cells * np.array([8, 1, 1])).sum(1)
    for frac in (0.0, 0.5, 0.999):
        pos = torch.tensor(((cells + frac) / g).T, dtype=torch.float32)
        owner = reference.owner_slab(cell, pos).numpy()
        assert np.array_equal(owner, table[flat]), frac
    assert np.array_equal(cell.slab_cells()[table[flat]], cells)
    pos, _, _ = state.card_state(cell, SEED, 0, "cpu")
    want = torch.arange(pos.shape[1]) // cell.n_local
    assert torch.equal(reference.owner_slab(cell, pos), want)


# --------------------------------------------------- mig:fallback and its reader


def _slab_loop(cell, steps, device="cpu", plain=False, **kw):
    """``make_migrate_loop`` as ``benchmark/program.build`` makes it for
    ``cell``, with ``kw`` over its ``DriftConfig``."""
    args = dict(domain=Domain(0.0, 1.0, periodic=True),
                grid=ProcessGrid(cell.dev_grid), dt=cell.dt,
                capacity=cell.capacity, n_local=cell.n_local,
                local_budget=cell.budget, engine="auto")
    args.update(kw)
    return nbody.make_migrate_loop(
        nbody.DriftConfig(**args), steps, vgrid=ProcessGrid(cell.vgrid),
        device=device, plain=plain)


def _case(name, cell):
    """``(pos, vel, alive, DriftConfig overrides, fast_path a step)``:
    ``bench``, the cell's own traffic; ``reshuffle``, every live row one
    slab over along x at rest, so the first step moves all of them past a
    mover block of 8 and the next two move nothing; ``tiny_cap``, the
    cell's traffic with a mover block of 4, too small every step."""
    pos, vel, alive = state.card_state(cell, SEED, 0, "cpu")
    if name == "bench":
        return pos, vel, alive, {}, [1, 1, 1]
    if name == "tiny_cap":
        return pos, vel, alive, {"mover_cap": 4}, [0, 0, 0]
    pos = pos.clone()
    reference.wrap_unit(pos[0].add_(1.0 / cell.grid[0]))
    return (pos, torch.zeros_like(vel), alive,
            {"mover_cap": 8, "capacity": cell.n_local, "local_budget": None},
            [0, 1, 1])


def metric(name):
    return {m.NAME: m for m in trace.load_metrics()}[name]


def _run(loop, pos, vel, alive):
    return loop(pos.reshape(-1), vel.reshape(-1), alive)


def _bits(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("case", ["bench", "reshuffle", "tiny_cap"])
def test_fallback_span_opens_on_the_fallback_steps(case):
    """Three steps under the profiler: a ``mig:fallback`` range lies in
    exactly the ``mig:step`` ranges whose step the guard sent to the dense
    step (``fast_path`` 0), none in a fast step; the output is bit-equal
    to ``engine="planar"``, and ``fast_share`` reads the trace."""
    cell = slab_cell(256)
    pos, vel, alive, kw, want = _case(case, cell)
    loop = _slab_loop(cell, 3, **kw)
    _run(loop, pos, vel, alive)  # warm: the device constants
    out, tr = trace.profile(lambda: _run(loop, pos, vel, alive))
    fp = out[3].fast_path.numpy()
    assert fp.shape == (3, 64) and (fp == fp[:, :1]).all()
    assert fp[:, 0].tolist() == want
    steps = [(s, e) for n, s, e in tr.ranges if n == "mig:step"]
    falls = [(s, e) for n, s, e in tr.ranges if n == "mig:fallback"]
    assert len(steps) == 3 and len(falls) == want.count(0)
    holds = [sum(s <= a and b <= e for a, b in falls) for s, e in steps]
    assert holds == [1 - w for w in want]
    ctx = trace.Context(cell=cell, kind="cpu", trace=tr, rank=0, stats={})
    share = metric("fast_share").read(ctx)
    assert share == (None if not any(want) else 100.0 * sum(want) / 3)
    ref = _run(_slab_loop(cell, 3, engine="planar", **kw), pos, vel, alive)
    for g, w in zip(out[:3], ref[:3]):
        assert torch.equal(_bits(g), _bits(w))
    for f in ("sent", "received", "population", "backlog", "dropped_recv",
              "flow"):
        assert torch.equal(getattr(out[3], f), getattr(ref[3], f)), f
    assert int(out[2].sum()) == int(alive.sum())


def _x(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": 1, "args": {}}


@pytest.mark.parametrize("steps,fallbacks,want", [
    (4, 0, 100.0), (4, 1, 75.0), (0, 0, None), (4, 4, None)])
def test_fast_share_on_a_canned_trace(steps, fallbacks, want):
    """``100 * (steps - fallbacks) / steps``; ``None`` with no step, and
    where every step fell back (a share never reads 0)."""
    ev = [_x("bench:window", 0, 1000 * steps + 10)]
    for i in range(steps):
        ev.append(_x("mig:step", 1000 * i, 900))
        if i >= steps - fallbacks:
            ev.append(_x("mig:fallback", 1000 * i + 100, 700))
    ctx = trace.Context(cell=slab_cell(), kind="cpu",
                        trace=trace.Trace.from_chrome({"traceEvents": ev}),
                        rank=0, stats={})
    assert metric("fast_share").read(ctx) == want


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_slab_kernels_on_card_match_plain_run(cuda):
    """The cell's loop at 2^16 slots a vrank on the card: kernels 1 and 2
    against the plain-version run, bit for bit, every step on the fast
    branch."""
    cell = slab_cell(1 << 16)
    pos, vel, alive = state.card_state(cell, SEED, 0, cuda)
    runs = [_run(_slab_loop(cell, 4, device=cuda, plain=p), pos, vel, alive)
            for p in (False, True)]
    torch.cuda.synchronize()
    a, b = runs
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(_bits(x), _bits(y))
    for f in ("sent", "received", "population", "backlog", "dropped_recv",
              "flow", "fast_path"):
        assert torch.equal(getattr(a[3], f), getattr(b[3], f)), f
    assert bool(a[3].fast_path.bool().all())
    assert int(a[3].sent.sum()) > 0 and int(a[2].sum()) == int(alive.sum())
