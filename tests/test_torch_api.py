"""The port's ``GridRedistribute`` (device="cpu") vs the JAX package's
``GridRedistribute(backend="numpy")`` (its oracle), vs the port's own
NumPy backend and vs the reference's vrank builders: bit level (uint8
views) on positions, fields, count and every stats leaf. Grids (1,1,1),
(2,1,1), (2,2,2), (3,2,1); every engine; ``GridEdges``; int16 and bool
fields; float64/int64 inputs (narrowed as JAX narrows them); NaN
payloads, -0.0 and denormals; count 0 and a tensor count; the overflow
policies with growth converging in <= 3 builds; the deferred-check
window; ``MoverCapacity``; and the arguments of planes not ported yet.

The reference's ``backend="jax"`` runs its mesh engines on the tests'
8-device CPU mesh (``"auto"`` is the count-driven sparse engine there),
so stats are held against its oracle and vrank builders instead."""

import types
import warnings

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import mpi_grid_redistribute_tpu as jgr
from mpi_grid_redistribute_tpu import api as japi
from mpi_grid_redistribute_tpu.parallel import exchange as jex
import mpi_grid_redistribute_tpu_torch as tgr
from mpi_grid_redistribute_tpu_torch import api, oracle

torch.set_num_threads(1)

JDOM = jgr.Domain(0.0, 1.0, periodic=True)
TDOM = tgr.Domain(0.0, 1.0, periodic=True)
GRIDS = [(1, 1, 1), (2, 1, 1), (2, 2, 2), (3, 2, 1)]
STATS = ("send_counts", "recv_counts", "dropped_send", "dropped_recv",
         "needed_capacity")


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.uint8),
                                  np.ascontiguousarray(want).view(np.uint8))


def _compare(got, want):
    _same(got.positions, want.positions)
    _same(got.count, want.count)
    assert len(got.fields) == len(want.fields)
    for g, w in zip(got.fields, want.fields):
        _same(g, w)
    for f in STATS:
        _same(getattr(got.stats, f), getattr(want.stats, f))


def _inputs(r, R=8, n_local=300, clustered=False):
    n = R * n_local
    if clustered:
        pos = (r.random((n, 3)) ** 4).astype(np.float32)
    else:
        pos = r.random((n, 3), dtype=np.float32)
    vel = r.standard_normal((n, 3)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    return pos, vel, ids


def _journal(rec):
    """A recorder's events as ``(kind, payload)`` without the random trace
    id of the call's step context."""
    return [(e.kind, {k: v for k, v in e.data.items() if k != "trace"})
            for e in rec.events()]


def _pair(grid, **kw):
    return (tgr.GridRedistribute(TDOM, grid, device="cpu", **kw),
            jgr.GridRedistribute(JDOM, grid, backend="numpy", **kw))


@pytest.mark.parametrize("engine", ["auto", "planar", "rowmajor"])
@pytest.mark.parametrize("grid", GRIDS)
def test_matches_reference_oracle(grid, engine):
    r = np.random.default_rng(sum(grid) * 3 + len(engine))
    R = int(np.prod(grid))
    pos, vel, ids = _inputs(r, R)
    count = r.integers(0, 301, R).astype(np.int32)
    t, j = _pair(grid, capacity_factor=3.0, engine=engine)
    _compare(t.redistribute(pos, vel, ids, count=count),
             j.redistribute(pos, vel, ids, count=count))


@pytest.mark.parametrize("engine", ["planar", "rowmajor"])
@pytest.mark.parametrize("grid", [(2, 2, 2), (3, 2, 1)])
def test_matches_reference_vrank_builders(grid, engine):
    """The reference's own single-device engines at the same capacities:
    positions, fields, count and every stats leaf."""
    r = np.random.default_rng(sum(grid))
    R, n = int(np.prod(grid)), 250
    pos, vel, ids = _inputs(r, R, n)
    count = r.integers(0, n + 1, R).astype(np.int32)
    cap, out_cap = 20, 300
    t = tgr.GridRedistribute(TDOM, grid, device="cpu", capacity=cap,
                             out_capacity=out_cap, on_overflow="ignore",
                             engine=engine)
    got = t.redistribute(pos, vel, ids, count=count)
    jg = jgr.ProcessGrid(grid)
    if engine == "planar":
        specs = japi._planar_specs(pos, (vel, ids))
        fused = japi._fuse_planar(pos, (vel, ids), R, n, specs, stacked=True)
        out, cnt, stats = jex.build_redistribute_planar_vranks(
            JDOM, jg, cap, out_cap)(fused, jnp.asarray(count))
        wpos, wfields = japi._unfuse_planar(out, specs, R, out_cap,
                                            stacked=True)
    else:
        out = jex.build_redistribute_vranks(JDOM, jg, cap, out_cap)(
            jnp.asarray(pos.reshape(R, n, 3)), jnp.asarray(count),
            jnp.asarray(vel.reshape(R, n, 3)), jnp.asarray(ids.reshape(R, n)))
        wpos = np.asarray(out[0]).reshape(R * out_cap, 3)
        wfields = (np.asarray(out[2]).reshape(R * out_cap, 3),
                   np.asarray(out[3]).reshape(R * out_cap))
        cnt, stats = out[1], out[-1]
    _same(got.positions, wpos)
    for g, w in zip(got.fields, wfields):
        _same(g, w)
    _same(got.count, cnt)
    for f in STATS:
        _same(getattr(got.stats, f), getattr(stats, f))
    assert int(_np(got.stats.dropped_send).sum()) > 0  # the clip is live


@pytest.mark.parametrize("assignment", [False, True])
@pytest.mark.parametrize("grid", [(2, 2, 2), (3, 2, 1)])
def test_grid_edges_match_reference_oracle(grid, assignment):
    """Non-uniform edges (axis 0 an exact linspace, so one uniform axis),
    with and without a fine-cell assignment; ownership holds under them."""
    r = np.random.default_rng(7 + assignment)
    R = int(np.prod(grid))
    axes = []
    for d, g in enumerate(grid):
        cells = g * (2 if assignment else 1)
        ax = (np.linspace(0.0, 1.0, cells + 1) if d == 0 else
              np.concatenate([[0.0], np.sort(r.random(cells - 1)), [1.0]]))
        axes.append(tuple(float(v) for v in ax))
    assign = None
    if assignment:
        n_fine = int(np.prod([len(a) - 1 for a in axes]))
        assign = tuple(int(v) for v in r.integers(0, R, n_fine))
    te, je = tgr.GridEdges(axes, assign), jgr.GridEdges(axes, assign)
    assert te.uniform_axes[0] and te.uniform_axes == je.uniform_axes
    pos, vel, ids = _inputs(r, R)
    t = tgr.GridRedistribute(TDOM, grid, device="cpu", edges=te,
                             capacity_factor=4.0)
    j = jgr.GridRedistribute(JDOM, grid, backend="numpy", edges=je,
                             capacity_factor=4.0)
    got = t.redistribute(pos, vel, ids)
    _compare(got, j.redistribute(pos, vel, ids))
    oc = got.positions.shape[0] // R
    shards = [_np(got.positions)[i * oc: i * oc + int(got.count[i])]
              for i in range(R)]
    oracle.assert_ownership(TDOM, tgr.ProcessGrid(grid), shards, edges=te)
    if not assignment:
        assert te.subdomain_of_rank(1, tgr.ProcessGrid(grid)) == \
            je.subdomain_of_rank(1, jgr.ProcessGrid(grid))
    else:
        assert te.rank_cells_of(1) == je.rank_cells_of(1)


def test_grid_edges_validation_and_balance():
    r = np.random.default_rng(3)
    grid = tgr.ProcessGrid((2, 2, 2))
    sample = (r.random((4000, 3)) ** 2).astype(np.float32)
    te = tgr.GridEdges.balanced_for(TDOM, grid, sample)
    je = jgr.GridEdges.balanced_for(JDOM, jgr.ProcessGrid((2, 2, 2)), sample)
    assert te.edges == je.edges and hash(te) == hash(tgr.GridEdges(te.edges))
    with pytest.raises(ValueError):
        tgr.GridEdges([(0.0, 0.5, 0.4, 1.0)] * 3)
    with pytest.raises(ValueError):
        tgr.GridEdges([(0.0, 0.5, 1.0)] * 3).validate_against(
            TDOM, tgr.ProcessGrid((3, 2, 2)))
    with pytest.raises(ValueError):
        tgr.GridEdges([(0.0, 0.5, 0.9)] * 3).validate_against(TDOM, grid)
    with pytest.raises(ValueError):
        tgr.GridEdges([(0.0, 0.5, 1.0)] * 3, assignment=(0,) * 7)
    for rank, axis, step, per in ((0, 0, -1, True), (0, 0, -1, False),
                                  (5, 2, 1, True), (3, 1, 3, False)):
        assert grid.neighbor_rank(rank, axis, step, per) == \
            jgr.ProcessGrid((2, 2, 2)).neighbor_rank(rank, axis, step, per)


def test_narrow_fields_take_the_rowmajor_engine():
    """int16 and bool fields are not 32-bit: ``"auto"`` runs the row-major
    engine, bit-equal to the oracle (bool stays bool; the reference's jax
    row-major engine returns it as int32, ROADMAP.md C6)."""
    r = np.random.default_rng(11)
    pos, vel, _ = _inputs(r, 6, 200)
    tag = r.integers(-2**15, 2**15 - 1, (1200, 2)).astype(np.int16)
    flag = r.random(1200) < 0.5
    t, j = _pair((3, 2, 1), capacity_factor=3.0)
    got = t.redistribute(pos, tag, flag, vel)
    assert got.fields[1].dtype == torch.bool
    _compare(got, j.redistribute(pos, tag, flag, vel))
    with pytest.raises(TypeError, match="32-bit"):
        tgr.GridRedistribute(TDOM, (3, 2, 1), device="cpu",
                             engine="planar").redistribute(pos, tag)


@pytest.mark.parametrize("wide", ["float64_positions", "int64_field",
                                  "int16_field"])
@pytest.mark.parametrize("engine", ["planar", "sparse", "neighbor",
                                    "hierarchical", "auto"])
def test_wide_inputs_choose_the_engine_as_the_reference_does(engine, wide):
    """Planar eligibility is decided on the caller's dtypes, before the
    narrowing: an array that is not 32-bit makes every explicit
    planar-family engine raise ``TypeError`` (``halo(engine="planar")``
    too), and ``"auto"`` take the row-major engine, as the reference's
    ``backend="jax"`` does. The (4, 2, 2) grid has more ranks than the
    tests' 8 devices, so the reference runs vranks, as the port does."""
    r = np.random.default_rng(17)
    grid = (4, 2, 2)
    pos, vel, ids = _inputs(r, 16, 100)
    if wide == "float64_positions":
        args = (pos.astype(np.float64), ids)
    elif wide == "int64_field":
        args = (pos, ids.astype(np.int64))
    else:
        args = (pos, (ids % 30000).astype(np.int16))
    kw = dict(engine=engine, capacity_factor=3.0)
    t = tgr.GridRedistribute(TDOM, grid, device="cpu", **kw)
    j = jgr.GridRedistribute(JDOM, grid, backend="jax", **kw)
    assert j._vranks
    if engine != "auto":
        with pytest.raises(TypeError, match="32-bit"):
            j.redistribute(*args)
        with pytest.raises(TypeError, match="32-bit"):
            t.redistribute(*args)
        return
    want, got = j.redistribute(*args), t.redistribute(*args)
    assert t._last_wire["engine"] == j._last_wire["engine"] == "rowmajor"
    for g, w in [(got.positions, want.positions), (got.count, want.count),
                 (got.fields[0], want.fields[0])]:
        _same(g, w)
    for f in STATS:
        _same(getattr(got.stats, f), getattr(want.stats, f))
    halo = dict(width=0.05, count=want.count)
    hp = dict(engine="planar")
    with pytest.raises(TypeError, match="32-bit"):
        jgr.GridRedistribute(JDOM, grid, backend="jax", **hp).halo(
            *args, **halo)
    with pytest.raises(TypeError, match="32-bit"):
        tgr.GridRedistribute(TDOM, grid, device="cpu", **hp).halo(
            *args, width=0.05, count=got.count)


def test_64_bit_inputs_are_narrowed_as_jax_narrows_them():
    """float64 positions bin at float32, as the reference's jax backend
    sees them (a row within a float32 ulp of a cell edge would otherwise
    land elsewhere); int64 ids arrive as int32. Tensors and arrays alike."""
    r = np.random.default_rng(12)
    pos = r.random((2400, 3))  # float64
    edge = np.float32(0.5)
    pos[:8, 0] = np.nextafter(edge, np.float32(0), dtype=np.float32) + \
        np.array([0.0, 1e-9, 2e-9, 3e-9, -1e-9, 5e-9, 6e-9, 7e-9])
    ids = np.arange(2400, dtype=np.int64)
    t, j = _pair((2, 2, 2), capacity_factor=3.0)
    want = j.redistribute(pos, ids)
    for args in ((pos, ids), (torch.from_numpy(pos), torch.from_numpy(ids))):
        got = t.redistribute(*args)
        assert got.positions.dtype == torch.float32
        assert got.fields[0].dtype == torch.int32
        _compare(got, want)
    n = tgr.GridRedistribute(TDOM, (2, 2, 2), backend="numpy",
                             capacity_factor=3.0).redistribute(pos, ids)
    _compare(n, want)


@pytest.mark.parametrize("engine", ["planar", "rowmajor"])
def test_every_bit_pattern_survives(engine):
    """NaN payloads, infinities, denormals and -0.0 in a float field, and
    int32 ids below 2^23 (denormal as float bits): the planar transport is
    an int32 view, the row-major one moves raw elements."""
    r = np.random.default_rng(13)
    n = 8 * 400
    pos = r.random((n, 3), dtype=np.float32)
    bits = (np.arange(n, dtype=np.uint64) * 2654435761 % (1 << 32)).astype(
        np.uint32)
    bits[:6] = [0x7FC00001, 0xFF800000, 0x00000001, 0x80000000, 0x007FFFFF,
                0xFFC0BEEF]
    weird = bits.view(np.float32)
    ids = np.arange(n, dtype=np.int32)
    t, j = _pair((2, 2, 2), capacity_factor=4.0, engine=engine)
    _compare(t.redistribute(pos, weird, ids), j.redistribute(pos, weird, ids))


def test_count_zero_and_tensor_counts():
    r = np.random.default_rng(14)
    pos, vel, ids = _inputs(r)
    t, j = _pair((2, 2, 2), capacity_factor=3.0)
    zero = t.redistribute(pos, vel, ids, count=np.zeros(8, np.int32))
    assert not zero.count.any() and not zero.positions.any()
    _compare(zero, j.redistribute(pos, vel, ids, count=np.zeros(8, np.int32)))
    # a tensor count (e.g. the previous call's result.count) is clipped
    # where it lives instead of read back and checked
    cnt = torch.tensor([0, 5, 300, 999, -4, 17, 299, 1], dtype=torch.int32)
    got = t.redistribute(pos, vel, ids, count=cnt)
    _compare(got, j.redistribute(pos, vel, ids,
                                 count=np.clip(cnt.numpy(), 0, 300)))
    with pytest.raises(ValueError, match="count entries"):
        t.redistribute(pos, vel, ids, count=cnt.numpy())
    with pytest.raises(ValueError, match="count must be"):
        t.redistribute(pos, vel, ids, count=torch.zeros(3, dtype=torch.int32))
    # chained: the result feeds the next call
    again = t.redistribute(got.positions, *got.fields, count=got.count)
    assert int(again.count.sum()) == int(got.count.sum())
    t.flush_overflow_checks()


def _count_builds(rd):
    builds = []
    orig = rd._run_once

    def counting(*args):
        builds.append((rd.capacity, rd.out_capacity))
        return orig(*args)

    rd._run_once = counting
    return builds


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_overflow_grows_like_the_reference(backend):
    """Clustered data at a tiny capacity: growth converges in <= 3 builds,
    to the reference's capacities and bits, and the grown capacities
    stick."""
    r = np.random.default_rng(15)
    pos, vel, ids = _inputs(r, clustered=True)
    t = tgr.GridRedistribute(TDOM, (2, 2, 2), backend=backend, device="cpu",
                             capacity=32)
    j = jgr.GridRedistribute(JDOM, (2, 2, 2), backend="numpy", capacity=32)
    tb, jb = _count_builds(t), _count_builds(j)
    got = t.redistribute(pos, vel, ids)
    _compare(got, j.redistribute(pos, vel, ids))
    assert tb == jb and 2 <= len(tb) <= 3
    assert int(_np(got.count).sum()) == pos.shape[0]
    assert (t.capacity, t.out_capacity) == (j.capacity, j.out_capacity)
    tb.clear()
    t.redistribute(pos, vel, ids)
    assert len(tb) == 1


def test_overflow_raise_and_ignore():
    r = np.random.default_rng(16)
    pos, vel, ids = _inputs(r, clustered=True)
    with pytest.raises(RuntimeError, match="dropped"):
        tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu", capacity=32,
                             on_overflow="raise").redistribute(pos, ids)
    t, j = _pair((2, 2, 2), capacity=32, on_overflow="ignore")
    got = t.redistribute(pos, vel, ids)
    _compare(got, j.redistribute(pos, vel, ids))
    dropped = int(got.stats.dropped_send.sum() + got.stats.dropped_recv.sum())
    assert dropped > 0
    assert int(got.count.sum()) + dropped == pos.shape[0]
    assert t._blocking_fetches == 0
    with pytest.raises(ValueError, match="on_overflow"):
        tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu",
                             on_overflow="retry")


def _placed_state(r, n_local=64):
    """Every row already on its owner shard (no sends) and the counts."""
    pos, _, _ = _inputs(r, 8, n_local)
    dest = oracle.rank_of_position(pos, TDOM, tgr.ProcessGrid((2, 2, 2)))
    counts = np.bincount(dest, minlength=8)
    rows = int(counts.max())
    placed = np.zeros((8 * rows, 3), np.float32)
    for k in range(8):
        placed[k * rows: k * rows + counts[k]] = pos[dest == k]
    return placed, counts.astype(np.int32)


def test_deferred_check_reads_nothing_in_steady_state():
    r = np.random.default_rng(17)
    pos, vel, ids = _inputs(r, n_local=64)
    rd = tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu",
                              capacity_factor=16.0, check_every=4)
    for _ in range(3):
        rd.redistribute(pos, vel, ids)
    assert rd._clean_checks >= 2
    fetches = rd._blocking_fetches
    for _ in range(8):
        rd.redistribute(pos, vel, ids)
    assert rd._blocking_fetches == fetches
    assert rd._pending_check is not None
    rd.flush_overflow_checks()
    assert not rd._has_unresolved_windows()


def test_deferred_check_catches_an_unsampled_spike():
    """A one-call overflow between sampled calls is in the cumulative
    counters: the next scheduled read raises and grows the capacity."""
    r = np.random.default_rng(18)
    placed, cnt = _placed_state(r)
    rd = tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu", capacity=1,
                              check_every=4)
    rd.redistribute(placed, count=cnt)
    rd.redistribute(placed, count=cnt)
    assert rd._clean_checks == 2
    clustered = np.full_like(placed, 0.1)
    rd.redistribute(clustered, count=cnt)  # lossy, not itself sampled
    with pytest.raises(RuntimeError, match="deferred overflow check"):
        for _ in range(8):
            rd.redistribute(placed, count=cnt)
    assert rd.capacity > 1
    rd.flush_overflow_checks()


def test_read_every_call_heals_a_calibrated_drop_in_the_same_call():
    """read_every_call=True: the same unsampled spike is read at once,
    grown and re-run on the same inputs; the windows stay clean."""
    r = np.random.default_rng(18)
    placed, cnt = _placed_state(r)
    rd = tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu", capacity=1,
                              check_every=4, read_every_call=True)
    for _ in range(4):
        rd.redistribute(placed, count=cnt)
    assert rd._clean_checks >= 2 and rd._cum_counters is not None
    fetches = rd._blocking_fetches
    clustered = np.full_like(placed, 0.1)
    res = rd.redistribute(clustered, count=cnt)
    assert int(res.stats.dropped_send.sum()) == 0
    assert int(res.stats.dropped_recv.sum()) == 0
    assert int(res.count.sum()) == int(cnt.sum())
    assert rd.capacity > 1
    assert [e.data["which"] for e in rd.telemetry.events("capacity_grow")]
    assert rd._blocking_fetches > fetches
    for _ in range(8):
        rd.redistribute(placed, count=cnt)
    rd.flush_overflow_checks()
    assert not rd.telemetry.events("overflow_window_loss")
    assert rd.telemetry.events("overflow_window_clean")


def test_flush_covers_the_partial_window_and_context_exit():
    r = np.random.default_rng(19)
    placed, cnt = _placed_state(r)
    clustered = np.full_like(placed, 0.1)
    rd = tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu", capacity=1,
                              check_every=100)
    rd.redistribute(placed, count=cnt)
    rd.redistribute(placed, count=cnt)
    rd.redistribute(clustered, count=cnt)
    with pytest.raises(RuntimeError, match="deferred overflow check"):
        rd.flush_overflow_checks()
    with pytest.raises(RuntimeError, match="deferred overflow check"):
        with tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu", capacity=1,
                                  check_every=100) as rd2:
            rd2.redistribute(placed, count=cnt)
            rd2.redistribute(placed, count=cnt)
            rd2.redistribute(clustered, count=cnt)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu",
                                  check_every=4) as rd3:
            for _ in range(6):
                rd3.redistribute(placed, count=cnt)
    assert not rd3._has_unresolved_windows()


def test_del_warns_on_unflushed_windows():
    r = np.random.default_rng(20)
    placed, cnt = _placed_state(r)
    rd = tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu", capacity=1,
                              check_every=100)
    for _ in range(3):
        rd.redistribute(placed, count=cnt)
    assert rd._has_unresolved_windows()
    with pytest.warns(RuntimeWarning, match="unresolved deferred"):
        rd.__del__()
    rd.flush_overflow_checks()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rd.__del__()


def test_engine_fn_runs_the_same_engine():
    r = np.random.default_rng(21)
    pos, vel, ids = _inputs(r)
    rd = tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu",
                              capacity_factor=3.0, on_overflow="ignore")
    want = rd.redistribute(pos, vel, ids)
    fn, cap, out_cap = rd.engine_fn(torch.from_numpy(pos),
                                    torch.from_numpy(vel),
                                    torch.from_numpy(ids))
    assert (cap, out_cap) == rd._capacities(300)
    p, c, f, s = fn(torch.from_numpy(pos), torch.full((8,), 300, dtype=torch.int32),
                    torch.from_numpy(vel), torch.from_numpy(ids))
    assert torch.equal(p, want.positions) and torch.equal(c, want.count)
    assert all(torch.equal(a, b) for a, b in zip(f, want.fields))


class _Stats:
    def __init__(self, sent, backlog):
        self.sent, self.backlog = sent, backlog


def test_mover_capacity_matches_reference():
    r = np.random.default_rng(22)
    seq = [_Stats(r.integers(0, hi, (4, 8)).astype(np.int32),
                  r.integers(0, 5, (4, 8)).astype(np.int32))
           for hi in (3, 40, 20, 300, 100, 1000)]
    from mpi_grid_redistribute_tpu import telemetry as jtel
    from mpi_grid_redistribute_tpu_torch import telemetry as ttel

    for max_cap in (None, 256):
        trec, jrec = ttel.StepRecorder(), jtel.StepRecorder()
        t = tgr.MoverCapacity(5, max_cap, recorder=trec)
        j = jgr.api.MoverCapacity(5, max_cap, recorder=jrec)
        for st in seq:
            tst = _Stats(torch.from_numpy(st.sent), torch.from_numpy(st.backlog))
            assert t.update(tst) == j.update(st)
            assert (t.value, t.grow_count) == (j.value, j.grow_count)
        # the growth journal: the same mover_cap_grow events
        assert [(e.kind, e.data) for e in trec.events()] == [
            (e.kind, e.data) for e in jrec.events()]
        assert trec.counts() == jrec.counts() and trec.counts()
    with pytest.raises(ValueError):
        tgr.MoverCapacity(0)


def test_unported_planes_raise():
    # nothing is refused any more: the telemetry arguments journal
    from mpi_grid_redistribute_tpu_torch.parallel import exchange as tex
    from mpi_grid_redistribute_tpu_torch.telemetry import StepRecorder

    rec = StepRecorder()
    mc = tgr.api.MoverCapacity(8, recorder=rec)
    assert mc.update(types.SimpleNamespace(
        sent=torch.tensor([[3, 20]]), backlog=torch.zeros(1, 2)))
    assert tex.resolve_engine("auto", canonical=True, recorder=rec) == "planar"
    tgr.api.reshard(np.zeros((4, 3), np.float32), domain=TDOM,
                    grid=(2, 2, 2), n_local=4, telemetry=rec)
    assert [e.kind for e in rec.events()] == [
        "mover_cap_grow", "engine_resolved", "redistribute"]
    assert rec.events()[0].data == dict(old=8, new=32, peak_movers=20)
    # the multi-rank plane, the count-driven and the hierarchical engines
    # are ported: a mesh must be a RankMesh, and "sparse"/"neighbor"/
    # "hierarchical" (with dcn_shape= and cross_cap=) build on one device
    with pytest.raises(TypeError, match="RankMesh"):
        tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu", mesh=object())
    for engine in ("sparse", "neighbor", "hierarchical"):
        tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu", engine=engine)
    rd = tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu",
                              dcn_shape=(2, 1, 1), cross_cap=4)
    assert rd.n_pods == 2 and rd._cross_cap == 4
    rd = tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tgr.GridRedistribute(TDOM, (2, 2, 2), backend="jax")
    with pytest.raises(ValueError, match="engine"):
        tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu", engine="fast")
    with pytest.raises(ValueError, match="divide"):
        rd.redistribute(np.zeros((9, 3), np.float32))


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_functional_redistribute_matches_reference(backend):
    """The package root's ``redistribute()`` builds an instance and runs
    one call: byte-equal to the reference's (numpy backend), stats too."""
    r = np.random.default_rng(31)
    pos, vel, ids = _inputs(r, 8, 200)
    count = r.integers(100, 201, 8).astype(np.int32)
    kw = dict(device="cpu") if backend == "torch" else {}
    got = tgr.redistribute(pos, vel, ids, domain=TDOM, grid=(2, 2, 2),
                           count=count, backend=backend,
                           capacity_factor=3.0, **kw)
    want = jgr.redistribute(pos, vel, ids, domain=JDOM, grid=(2, 2, 2),
                            count=count, backend="numpy",
                            capacity_factor=3.0)
    _compare(got, want)
    if backend == "torch":
        assert isinstance(got.positions, torch.Tensor)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("grid", [(1, 2, 2), (2, 2, 2), (4, 2, 2)])
def test_reshard_matches_reference(grid, backend):
    """``reshard`` routes unpadded live rows onto fewer or more ranks:
    byte-equal to the reference's (numpy backend), fields riding along,
    every live row kept and owned."""
    r = np.random.default_rng(5 + len(grid) + grid[0])
    n = 1500
    pos = r.random((n, 3), dtype=np.float32)
    vel = r.standard_normal((n, 3)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    R = int(np.prod(grid))
    n_local = 2 * n // R
    kw = dict(device="cpu") if backend == "torch" else {}
    got = api.reshard(pos, vel, ids, domain=TDOM, grid=grid, n_local=n_local,
                      backend=backend, **kw)
    want = japi.reshard(pos, vel, ids, domain=JDOM, grid=grid,
                        n_local=n_local)
    _compare(got, want)
    assert int(_np(got.count).sum()) == n
    shards = [_np(got.positions)[i * n_local: i * n_local + int(got.count[i])]
              for i in range(R)]
    oracle.assert_ownership(TDOM, tgr.ProcessGrid(grid), shards)
    # telemetry= journals the call into the caller's recorder, as the
    # reference's does (numpy backend: no engine resolution)
    from mpi_grid_redistribute_tpu import telemetry as jtel
    from mpi_grid_redistribute_tpu_torch import telemetry as ttel

    trec, jrec = ttel.StepRecorder(), jtel.StepRecorder()
    api.reshard(pos, domain=TDOM, grid=grid, n_local=n_local, telemetry=trec)
    japi.reshard(pos, domain=JDOM, grid=grid, n_local=n_local,
                 telemetry=jrec)
    assert _journal(trec) == _journal(jrec)
    with pytest.raises(ValueError, match="n_local"):
        api.reshard(pos, domain=TDOM, grid=grid, n_local=0)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_apply_assignment_matches_reference(backend):
    """Re-home a redistributed state under balanced edges: byte-equal to
    the reference replaying the same two-stage sequence; the edges stick
    (the next call routes by them) and ``None`` reverts to uniform
    cells."""
    r = np.random.default_rng(17)
    pos, vel, ids = _inputs(r, 8, 250, clustered=True)
    kw = dict(device="cpu") if backend == "torch" else {}
    t = tgr.GridRedistribute(TDOM, (2, 2, 2), backend=backend,
                             capacity_factor=8.0, out_capacity=1200, **kw)
    j = jgr.GridRedistribute(JDOM, (2, 2, 2), backend="numpy",
                             capacity_factor=8.0, out_capacity=1200)
    a, b = t.redistribute(pos, vel, ids), j.redistribute(pos, vel, ids)
    _compare(a, b)
    te = tgr.GridEdges.balanced_for(TDOM, tgr.ProcessGrid((2, 2, 2)), pos)
    je = jgr.GridEdges.balanced_for(JDOM, jgr.ProcessGrid((2, 2, 2)), pos)
    got = t.apply_assignment(te, a.positions, *a.fields, count=a.count)
    want = j.apply_assignment(je, b.positions, *b.fields, count=b.count)
    _compare(got, want)
    assert t.edges == te
    c, c0 = _np(got.count), _np(a.count)
    assert c.sum() == 2000 and c.max() / c.mean() < c0.max() / c0.mean()
    _compare(t.redistribute(pos, vel, ids), j.redistribute(pos, vel, ids))
    got = t.apply_assignment(te.edges, a.positions, *a.fields, count=a.count)
    _compare(got, want)  # raw edge tuples are wrapped in GridEdges
    got = t.apply_assignment(None, a.positions, *a.fields, count=a.count)
    want = j.apply_assignment(None, b.positions, *b.fields, count=b.count)
    _compare(got, want)
    assert t.edges is None
    with pytest.raises(ValueError):
        t.apply_assignment([(0.0, 0.5, 0.9)] * 3, pos)


def test_config1_bench_matches_the_reference_loop():
    """The config-1 twin at a small width: the oracle check passes on the
    CPU, and its canonical drift loop is bit-equal to the reference's
    ``make_loop_planar`` body (``lax.scan`` of the planar vrank engine)."""
    import jax
    from jax import lax
    from mpi_grid_redistribute_tpu.ops import binning as jbin
    from mpi_grid_redistribute_tpu_torch.bench import config1_oracle as c1

    res, _, _ = c1.oracle_check(8 * 1500, device="cpu")
    assert int(res.count.sum()) == 8 * 1500
    n_loc, steps = 1024, 3
    slots, cap = c1.loop_sizing(n_loc)
    fused, count = c1.drift_state(n_loc)
    f, c, drops = c1.make_loop_planar(n_loc)(
        torch.from_numpy(fused), torch.from_numpy(count), steps)
    xfn = jex.vrank_redistribute_planar_fn(JDOM, jgr.ProcessGrid((2, 2, 2)),
                                           cap, slots)

    @jax.jit
    def ref(fu, co):
        def body(carry, _):
            fu, co = carry
            p = jbin.wrap_periodic_planar(
                fu[:, :3, :] + fu[:, 3:6, :] * jnp.float32(1.0), JDOM)
            fu, co, st = xfn(jnp.concatenate([p, fu[:, 3:6, :]], axis=1), co)
            return (fu, co), st.dropped_send + st.dropped_recv
        (fu, co), d = lax.scan(body, (fu, co), None, length=steps)
        return fu, co, d

    wf, wc, wd = ref(jnp.asarray(fused), jnp.asarray(count))
    _same(f, wf)
    _same(c, wc)
    assert int(drops) == int(np.asarray(wd).sum()) == 0
    assert int(c.sum()) == 8 * n_loc


def test_unsigned_and_complex_fields_match_reference_oracle():
    """uint64 and complex128 fields arrive narrowed (uint32, complex64) as
    on the reference's backends, and ride the row-major engine as
    integer words (PyTorch's gathers take no uint32)."""
    r = np.random.default_rng(23)
    pos = r.random((800, 3), dtype=np.float32)
    u = np.arange(800, dtype=np.uint64) * np.uint64(2**40 + 3)
    c = r.standard_normal(800) + 1j * r.standard_normal(800)
    h = r.standard_normal(800).astype(np.float16)
    t, j = _pair((2, 2, 2), capacity_factor=4.0)
    got = t.redistribute(pos, u, c, h)
    assert [f.dtype for f in got.fields] == [torch.uint32, torch.complex64,
                                             torch.float16]
    _compare(got, j.redistribute(pos, u, c, h))


def test_journaling_reads_nothing_off_the_device():
    """The journal is fed host values only: the same call sequence (a
    growing capacity, the deferred windows, the count-driven block's
    growth, a halo and a sparse migrate loop) with the journal on and with
    a disabled recorder gives the same blocking stat fetches, the same
    sparse-guard reads (``parallel.migrate.HOST_SYNCS``) and the same
    scalar reads off tensors, and every payload handed to the recorder
    holds plain host values."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from mpi_grid_redistribute_tpu_torch.bench import common
    from mpi_grid_redistribute_tpu_torch.models import nbody
    from mpi_grid_redistribute_tpu_torch.parallel import migrate
    from mpi_grid_redistribute_tpu_torch.telemetry import StepRecorder

    payloads = []

    class Spy(StepRecorder):
        def record(self, kind, **data):
            payloads.append(data)
            super().record(kind, **data)

    class ScalarReads(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                ScalarReads.n += 1
            return func(*args, **(kwargs or {}))

    r = np.random.default_rng(41)
    calls = [_inputs(r, 8, 200, clustered=(i == 5)) for i in range(7)]
    v, cap, budget = common.drift_sizing((2, 2, 2), 512, 0.9, 0.02)
    state = common.uniform_state((2, 2, 2), 512, 0.9,
                                 np.random.default_rng(0), vel_scale=v)
    cfg = nbody.DriftConfig(domain=TDOM, grid=tgr.ProcessGrid((1, 1, 1)),
                            dt=1.0, capacity=cap, n_local=512,
                            local_budget=budget)

    def run(rec):
        ScalarReads.n = 0
        guard = migrate.HOST_SYNCS["sparse_guard"]
        rd = tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu",
                                  engine="sparse", capacity_factor=0.5,
                                  check_every=2, mover_cap=2)
        rd.telemetry = rec
        with ScalarReads():
            for args in calls:
                try:
                    res = rd.redistribute(*args)
                except RuntimeError:  # the deferred window's loss
                    pass
            try:
                rd.flush_overflow_checks()
            except RuntimeError:
                pass
            rd.halo(res.positions, width=0.05, count=res.count,
                    headroom=0.05)
            loop = nbody.make_migrate_loop(
                cfg, 3, vgrid=tgr.ProcessGrid((2, 2, 2)), device="cpu")
            stats = loop(*state)[3]
            tgr.MoverCapacity(4, recorder=rec).update(stats)
        return (rd._blocking_fetches,
                migrate.HOST_SYNCS["sparse_guard"] - guard, ScalarReads.n)

    on = run(Spy())
    assert len(payloads) > 10 and on[0] > 0 and on[1] == 3 and on[2] > 0
    assert run(StepRecorder(enabled=False)) == on
    host = (bool, int, float, str, type(None))
    for data in payloads:
        for v in data.values():
            assert type(v) in host or (
                type(v) is list and all(type(x) in host for x in v)), data
