"""Port drift/migrate loop (mpi_grid_redistribute_tpu_torch) vs the JAX
package's make_migrate_loop(engine="planar") with 2x2x2 vranks on one
CPU device, and one shard_migrate_vranks_fn step fed through convert.py.
Everything must be BIT-equal: planar pos/vel/alive, every MigrateStats
leaf, and the free-slot stack.

dt is 1.0 or 0.0625 where positions drift: a jitted JAX function on the
CPU contracts ``p + v*dt`` into a fused multiply-add and the port does
not; with a power-of-two dt the product is exact and the two agree (at
dt = 0.05 one drift in ~26 differs by an ulp, enough to re-home it).

With the CIC deposit fused in (config 5), the state and stats stay
bit-equal; the density is bit-equal for ``deposit_method="scan"`` (same
stable order, same double-float sequence) and within ``rtol = atol =
2e-5`` for ``"mxu"``, whose reference sort is unstable, so its per-cell
summation order is not a contract (2e-5 is the reference's own
float64-oracle tolerance for the deposit engines)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from mpi_grid_redistribute_tpu import compat
from mpi_grid_redistribute_tpu import domain as jdomain
from mpi_grid_redistribute_tpu.bench import common as jcommon
from mpi_grid_redistribute_tpu.models import nbody as jnbody
from mpi_grid_redistribute_tpu.parallel import mesh as mesh_lib
from mpi_grid_redistribute_tpu.parallel import migrate as jmig
from mpi_grid_redistribute_tpu_torch import convert
from mpi_grid_redistribute_tpu_torch import domain as tdomain
from mpi_grid_redistribute_tpu_torch.bench import common as tcommon
from mpi_grid_redistribute_tpu_torch.models import nbody as tnbody
from mpi_grid_redistribute_tpu_torch.parallel import migrate as tmig

# the inputs are small: one intra-op thread is as fast here and keeps
# these tests from competing for cores with the other test workers
torch.set_num_threads(1)

GRID = (2, 2, 2)


def _assert_bits(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got = np.ascontiguousarray(got)
    want = np.ascontiguousarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype.itemsize == want.dtype.itemsize
    np.testing.assert_array_equal(
        got.view(np.uint8), want.view(np.uint8)
    )


def _assert_stats(got, want):
    for f in jmig.MigrateStats._fields:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
            continue
        assert g.dtype == torch.int32, f
        _assert_bits(g, w)


def _run_both(vgrid_shape, n_local, dt, capacity, budget, pos, vel, alive,
              n_steps, lo=0.0, hi=1.0, port_inputs=None, periodic=True,
              deposit=None, deposit_each_step=False):
    """The JAX loop on numpy ``pos, vel, alive`` and the port's loop on
    the same arrays (or on ``port_inputs``, tensors of the same bits).
    ``deposit`` is ``(deposit_shape, deposit_method)`` or None."""
    dev_grid = jdomain.ProcessGrid((1,) * len(vgrid_shape))
    mesh = mesh_lib.make_mesh(dev_grid, devices=jax.devices()[:1])
    dep = {} if deposit is None else dict(
        deposit_shape=deposit[0], deposit_method=deposit[1]
    )
    jcfg = jnbody.DriftConfig(
        domain=jdomain.Domain(lo, hi, periodic=periodic), grid=dev_grid,
        dt=dt, capacity=capacity, n_local=n_local, local_budget=budget,
        engine="planar", **dep,
    )
    want = jax.tree.map(
        np.asarray,
        jnbody.make_migrate_loop(
            jcfg, mesh, n_steps, vgrid=jdomain.ProcessGrid(vgrid_shape),
            deposit_each_step=deposit_each_step,
        )(pos, vel, alive),
    )
    tcfg = tnbody.DriftConfig(
        domain=tdomain.Domain(lo, hi, periodic=periodic),
        grid=tdomain.ProcessGrid((1,) * len(vgrid_shape)), dt=dt,
        capacity=capacity, n_local=n_local, local_budget=budget,
        engine="planar", **dep,
    )
    got = tnbody.make_migrate_loop(
        tcfg, n_steps, vgrid=tdomain.ProcessGrid(vgrid_shape), device="cpu",
        deposit_each_step=deposit_each_step,
    )(*(port_inputs or (pos, vel, alive)))
    return got, want


@pytest.mark.parametrize("dt", [1.0, 0.0625])
@pytest.mark.parametrize("n_local", [64, 4096])
def test_loop_bit_equal_to_jax_planar(n_local, dt):
    v, cap, budget = tcommon.drift_sizing(GRID, n_local, 0.9, 0.02)
    assert (cap, budget) == jcommon.drift_sizing(GRID, n_local, 0.9, 0.02)[1:]
    # 4x the sized speed per unit dt: enough traffic that some steps
    # hit the budget and backlog at the small width
    pos, vel, alive = tcommon.uniform_state(
        GRID, n_local, 0.9, np.random.default_rng(n_local),
        vel_scale=4 * v / dt,
    )
    got, want = _run_both(GRID, n_local, dt, cap, budget, pos, vel, alive, 5)
    for g, w in zip(got[:3], want[:3]):
        _assert_bits(g, w)
    _assert_stats(got[3], want[3])
    assert int(got[3].sent.sum()) > 0
    assert int(got[2].sum()) == int(alive.sum())


def test_uniform_state_matches_jax():
    a = tcommon.uniform_state(GRID, 32, 0.9, np.random.default_rng(3), 0.1)
    b = jcommon.uniform_state(GRID, 32, 0.9, np.random.default_rng(3), 0.1)
    for x, y in zip(a, b):
        _assert_bits(x, y)


def test_full_swap_bit_equal_and_lossless():
    """Two full vranks exchanging every particle (the reference's
    test_migrate_vranks_full_swap_is_lossless case)."""
    n_local = 8
    n = 2 * n_local
    r = np.random.default_rng(1234)
    pos = r.random((n, 3), dtype=np.float32)
    pos[:n_local, 0] = 0.75
    pos[n_local:, 0] = 0.25
    vel = np.zeros((n, 3), dtype=np.float32)
    alive = np.ones(n, dtype=bool)
    got, want = _run_both(
        (2, 1, 1), n_local, 0.0, n_local, None, pos, vel, alive, 1
    )
    for g, w in zip(got[:3], want[:3]):
        _assert_bits(g, w)
    _assert_stats(got[3], want[3])
    assert int(got[3].sent.sum()) == n and int(got[3].backlog.sum()) == 0
    rows = tnbody.planar_to_rows(got[0], 3, 1)
    assert (rows[:n_local, 0] < 0.5).all() and (rows[n_local:, 0] >= 0.5).all()


def test_rotation_cycle_rescue_bit_equal():
    """Four full vranks in a rotation cycle (no pairwise swaps, no free
    slots): only the cycle rescue moves rows, one per member per step."""
    n_local = 6
    V = 4
    r = np.random.default_rng(5)
    pos = r.random((V * n_local, 3), dtype=np.float32)
    for v in range(V):
        pos[v * n_local : (v + 1) * n_local, 0] = ((v + 1) % V + 0.5) / V
    vel = np.zeros_like(pos)
    alive = np.ones(V * n_local, dtype=bool)
    got, want = _run_both(
        (V, 1, 1), n_local, 0.0, n_local, None, pos, vel, alive, 3
    )
    for g, w in zip(got[:3], want[:3]):
        _assert_bits(g, w)
    _assert_stats(got[3], want[3])
    assert got[3].sent.numpy().tolist() == [[1] * V] * 3


def _jax_step(domain, vgrid, capacity, budget):
    dev_grid = jdomain.ProcessGrid((1, 1, 1))
    mesh = mesh_lib.make_mesh(dev_grid, devices=jax.devices()[:1])
    axes = dev_grid.axis_names
    fn = jmig.shard_migrate_vranks_fn(
        domain, dev_grid, vgrid, capacity, local_budget=budget
    )

    def body(f, fs, nf):
        st, stats = fn(jmig.MigrateState(f, fs, nf))
        return tuple(st), stats

    specs = (P(None, axes), P(axes), P(axes))
    stats_spec = jmig.MigrateStats(
        *([P(axes)] * 5), flow=P(axes, None), fast_path=None
    )
    return jax.jit(compat.shard_map(
        body, mesh=mesh, in_specs=specs, out_specs=(specs, stats_spec),
    ))


def test_single_step_through_convert_bit_equal():
    """A mid-run MigrateState (holes scattered, stack reordered by two
    earlier steps) crosses over through convert.py; one engine step on
    each side must agree on fused, free_stack, n_free and every stat."""
    n_local = 512
    v, cap, budget = tcommon.drift_sizing(GRID, n_local, 0.8, 0.05)
    pos, vel, alive = tcommon.uniform_state(
        GRID, n_local, 0.8, np.random.default_rng(8), vel_scale=3 * v
    )
    # pre-drifted positions: this step's movers are already displaced
    pos = (pos + vel) % np.float32(1.0)
    pos = np.where(pos >= 1.0, np.float32(0.0), pos).astype(np.float32)
    fused = np.concatenate(
        [pos.T.view(np.int32), vel.T.view(np.int32),
         alive.astype(np.int32)[None]], axis=0,
    )
    jd = jdomain.Domain(0.0, 1.0, periodic=True)
    jstep = _jax_step(jd, jdomain.ProcessGrid(GRID), cap, budget)
    st0 = jmig.init_state(jnp.asarray(fused), vranks=8, batched=True)
    st1, _ = jstep(*st0)
    # shift every live row once more so the next step has movers again
    f1 = np.asarray(st1[0]).copy()
    p1 = f1[:3].view(np.float32)
    p1[:] = np.mod(p1 + 0.3 * vel.T, np.float32(1.0))
    p1[p1 >= 1.0] = 0.0
    st1 = (jnp.asarray(f1), st1[1], st1[2])
    st2, jstats = jstep(*st1)

    tstep = tmig.shard_migrate_vranks_fn(
        tdomain.Domain(0.0, 1.0, periodic=True),
        tdomain.ProcessGrid((1, 1, 1)), tdomain.ProcessGrid(GRID), cap,
        local_budget=budget,
    )
    tstate = convert.migrate_state_to_torch(
        *[np.asarray(x) for x in st1], device="cpu"
    )
    out, tstats = tstep(tstate)
    for g, w in zip(convert.migrate_state_to_numpy(out), st2):
        _assert_bits(g, w)
    _assert_stats(tstats, jax.tree.map(np.asarray, jstats))
    assert int(tstats.sent.sum()) > 0


def test_planar_state_handed_over_through_convert():
    """JAX runs 2 steps, its planar pos/vel/alive cross over through
    convert.py and the port runs 3 more; the JAX loop continued from the
    same state for 3 steps gives the same bits. The row/planar helpers
    match the reference's too."""
    n_local = 256
    v, cap, budget = tcommon.drift_sizing(GRID, n_local, 0.9, 0.02)
    pos, vel, alive = tcommon.uniform_state(
        GRID, n_local, 0.9, np.random.default_rng(21), vel_scale=4 * v
    )
    _assert_bits(tnbody.rows_to_planar(pos, 1), jnbody.rows_to_planar(pos, 1))
    _, mid = _run_both(GRID, n_local, 1.0, cap, budget, pos, vel, alive, 2)
    got, want = _run_both(
        GRID, n_local, 1.0, cap, budget, *mid[:3], 3,
        port_inputs=convert.planar_to_torch(*mid[:3], device="cpu"),
    )
    for g, w in zip(convert.planar_to_numpy(*got[:3]), want[:3]):
        _assert_bits(g, w)
    _assert_stats(got[3], want[3])
    assert int(got[3].sent.sum()) > 0
    rows = tnbody.planar_to_rows(got[0], 3, 1)
    _assert_bits(rows, jnbody.planar_to_rows(np.asarray(want[0]), 3, 1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grant_helpers_match_jax(seed):
    r = np.random.default_rng(seed)
    V = 8
    desired = r.integers(0, 50, (V, V)).astype(np.int32)
    cap = r.integers(0, 120, V).astype(np.int32)
    _assert_bits(
        tmig._greedy_alloc(torch.from_numpy(desired), torch.from_numpy(cap)),
        jax.jit(jmig._greedy_alloc)(desired, cap),
    )
    pending = (r.random((V, V)) < 0.3).astype(np.int32) * r.integers(
        1, 5, (V, V)
    ).astype(np.int32)
    pending[np.arange(V), (np.arange(V) + 1) % V] = 1  # a full cycle
    sends_zero = r.random(V) < 0.8
    ok = r.random(V) < 0.9
    for okv in (None, ok):
        want = jax.jit(jmig._cycle_rescue)(pending, sends_zero, okv)
        got = tmig._cycle_rescue(
            torch.from_numpy(pending), torch.from_numpy(sends_zero),
            None if okv is None else torch.from_numpy(okv),
        )
        _assert_bits(got, want)


@pytest.mark.parametrize("with_rows", [False, True])
def test_plan_rows_batched_matches_jax(with_rows):
    r = np.random.default_rng(4)
    V, n, length = 8, 300, 90
    counts = r.integers(0, 20, (V, V)).astype(np.int32)
    starts = np.sort(r.integers(0, n, (V, V)), axis=1).astype(np.int32)
    order = np.stack([r.permutation(n) for _ in range(V)]).astype(np.int32)
    rows = np.arange(V, dtype=np.int32) if with_rows else None
    want = jax.jit(
        lambda s, c, o: jmig._plan_rows_batched(
            s, c, o, length, seg_rows=rows
        )
    )(starts.T if with_rows else starts, counts, order)
    got = tmig._plan_rows_batched(
        torch.from_numpy(starts.T if with_rows else starts),
        torch.from_numpy(counts), torch.from_numpy(order), length,
        seg_rows=None if rows is None else torch.from_numpy(rows),
    )
    tot = counts.sum(axis=1)
    valid = np.arange(length)[None, :] < tot[:, None]
    np.testing.assert_array_equal(
        np.where(valid, got[0].numpy(), -1),
        np.where(valid, np.asarray(want[0]), -1),
    )
    _assert_bits(got[1], want[1])


def test_stack_push_pop_matches_jax():
    r = np.random.default_rng(6)
    V, n, Pw = 8, 64, 24
    stack = np.stack([r.permutation(n) for _ in range(V)]).astype(np.int32)
    n_free = r.integers(0, n, V).astype(np.int32)
    n_in = r.integers(0, Pw // 2, V).astype(np.int32)
    n_sent = r.integers(0, Pw // 2, V).astype(np.int32)
    n_pop = np.minimum(np.maximum(n_in - n_sent, 0), n_free).astype(np.int32)
    n_push = np.maximum(n_sent - n_in, 0).astype(np.int32)
    n_free = np.minimum(n_free, n - n_push).astype(np.int32)
    vacated = r.integers(0, n, (V, Pw)).astype(np.int32)
    want = jax.jit(jax.vmap(jmig._stack_push_pop))(
        stack, n_free, n_pop, n_push, vacated, n_in
    )
    got = tmig._stack_push_pop(
        *[torch.from_numpy(x) for x in
          (stack, n_free, n_pop, n_push, vacated, n_in)]
    )
    _assert_bits(got[0], want[0])
    _assert_bits(got[1], want[1])


def test_init_state_and_fuse_fields_match_jax():
    r = np.random.default_rng(7)
    pos = r.random((40, 3), dtype=np.float32)
    ids = r.integers(0, 2**31 - 1, 40).astype(np.int32)
    alive = r.random(40) < 0.6
    jf, jspecs = jmig.fuse_fields([jnp.asarray(pos), jnp.asarray(ids)],
                                  jnp.asarray(alive))
    tf, tspecs = tmig.fuse_fields(
        [torch.from_numpy(pos), torch.from_numpy(ids)], torch.from_numpy(alive)
    )
    _assert_bits(tf, jf)
    (p2, i2), a2 = tmig.unfuse_fields(tf, tspecs)
    _assert_bits(p2, pos)
    _assert_bits(i2, ids)
    _assert_bits(a2, alive)
    js = jmig.init_state(jf, vranks=4, batched=True)
    ts = tmig.init_state(tf, vranks=4, batched=True)
    _assert_bits(ts.free_stack, js.free_stack)
    _assert_bits(ts.n_free, js.n_free)


def test_segment_of_matches_jax():
    cum = np.array([0, 3, 3, 7, 10], np.int32)
    k = np.arange(13, dtype=np.int32)
    _assert_bits(
        tmig._segment_of(torch.from_numpy(k), torch.from_numpy(cum)),
        jmig._segment_of(jnp.asarray(k), jnp.asarray(cum)),
    )


@pytest.mark.parametrize("engine,exc", [
    ("rowmajor", ValueError), ("neighbor", ValueError),
    ("hierarchical", ValueError), ("warp", ValueError),
])
def test_unported_engines_raise(engine, exc):
    """The canonical-exchange engines have no migrate-loop meaning (the
    reference raises too); "auto" and "sparse" run
    (tests/test_torch_migrate_sparse.py)."""
    cfg = tnbody.DriftConfig(
        domain=tdomain.Domain(0.0, 1.0, periodic=True),
        grid=tdomain.ProcessGrid((1, 1, 1)), dt=1.0, capacity=8,
        n_local=8, engine=engine,
    )
    with pytest.raises(exc):
        tnbody.make_migrate_loop(
            cfg, 1, vgrid=tdomain.ProcessGrid(GRID), device="cpu"
        )


def _check_deposit(got, want, method, alive_total):
    for g, w in zip(got[:3], want[:3]):
        _assert_bits(g, w)
    _assert_stats(got[3], want[3])
    rho = got[4]
    assert rho.dtype == torch.float32 and rho.shape == want[4].shape
    if method == "scan":
        _assert_bits(rho, want[4])
    else:
        np.testing.assert_allclose(rho.numpy(), want[4], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(rho.double().sum()), alive_total,
                               rtol=1e-5)


@pytest.mark.parametrize("method", ["scan", "mxu"])
@pytest.mark.parametrize("n_local,shape", [
    (256, (8, 8, 8)), (4096, (16, 16, 16)),
])
def test_fused_deposit_loop_matches_jax(n_local, shape, method):
    """Config 5 at a small width: 2x2x2 vranks, 3 steps, the deposit
    fused into every step."""
    v, cap, budget = tcommon.drift_sizing(GRID, n_local, 0.9, 0.02)
    pos, vel, alive = tcommon.uniform_state(
        GRID, n_local, 0.9, np.random.default_rng(n_local + 1),
        vel_scale=4 * v,
    )
    got, want = _run_both(GRID, n_local, 1.0, cap, budget, pos, vel, alive,
                          3, deposit=(shape, method), deposit_each_step=True)
    _check_deposit(got, want, method, int(got[2].sum()))
    assert int(got[3].sent.sum()) > 0


@pytest.mark.parametrize("method", ["scan", "mxu"])
def test_deposit_on_final_state_matches_jax(method):
    """Without deposit_each_step the loop deposits once, on the final
    state; on a mixed-periodic domain the density is the global node
    mesh (one clamp-edge plane on the open axis)."""
    n_local = 256
    v, cap, budget = tcommon.drift_sizing(GRID, n_local, 0.9, 0.02)
    pos, vel, alive = tcommon.uniform_state(
        GRID, n_local, 0.9, np.random.default_rng(3), vel_scale=4 * v
    )
    for periodic in (True, (True, False, True)):
        got, want = _run_both(
            GRID, n_local, 1.0, cap, budget, pos, vel, alive, 2,
            periodic=periodic, deposit=((8, 8, 8), method),
        )
        _check_deposit(got, want, method, int(got[2].sum()))
    assert tuple(got[4].shape) == (8, 9, 8)


def test_zero_steps_returns_the_zero_mesh():
    cfg = tnbody.DriftConfig(
        domain=tdomain.Domain(0.0, 1.0, periodic=True),
        grid=tdomain.ProcessGrid((1, 1, 1)), dt=1.0, capacity=8, n_local=8,
        deposit_shape=(4, 4, 4), engine="planar",
    )
    r = np.random.default_rng(0)
    out = tnbody.make_migrate_loop(
        cfg, 0, vgrid=tdomain.ProcessGrid(GRID), device="cpu",
        deposit_each_step=True,
    )(r.random((64, 3), dtype=np.float32), np.zeros((64, 3), np.float32),
      np.ones(64, bool))
    assert torch.equal(out[4], torch.zeros((4, 4, 4)))


@pytest.mark.parametrize("method,exc", [("bogus", ValueError)])
def test_unported_deposit_methods_raise(method, exc):
    cfg = tnbody.DriftConfig(
        domain=tdomain.Domain(0.0, 1.0, periodic=True),
        grid=tdomain.ProcessGrid((1, 1, 1)), dt=1.0, capacity=8, n_local=8,
        deposit_shape=(8, 8, 8), deposit_method=method, engine="planar",
    )
    with pytest.raises(exc):
        tnbody.make_migrate_loop(
            cfg, 1, vgrid=tdomain.ProcessGrid(GRID), device="cpu"
        )


@pytest.mark.parametrize("each_step", [True, False])
@pytest.mark.parametrize("periodic", [True, (True, False, True)])
def test_segment_deposit_loop_matches_jax(periodic, each_step):
    """The ``"segment"`` route: the planar state as ``[V, n, D]`` rows,
    unit mass, each vrank's scatter-add block, the ghost fold (or the
    dense assembly). BIT-equal on the CPU (the port reproduces XLA's
    corner order, ``ops.deposit.cic_deposit_vranks_segment``)."""
    n_local = 512
    v, cap, budget = tcommon.drift_sizing(GRID, n_local, 0.9, 0.02)
    pos, vel, alive = tcommon.uniform_state(
        GRID, n_local, 0.9, np.random.default_rng(21), vel_scale=4 * v
    )
    got, want = _run_both(GRID, n_local, 1.0, cap, budget, pos, vel, alive,
                          3, periodic=periodic,
                          deposit=((8, 8, 8), "segment"),
                          deposit_each_step=each_step)
    for g, w in zip(got[:3], want[:3]):
        _assert_bits(g, w)
    _assert_stats(got[3], want[3])
    _assert_bits(got[4], want[4])
    np.testing.assert_allclose(float(got[4].double().sum()),
                               int(got[2].sum()), rtol=1e-5)
    assert int(got[3].sent.sum()) > 0


def test_deposit_each_step_needs_a_deposit_shape():
    cfg = tnbody.DriftConfig(
        domain=tdomain.Domain(0.0, 1.0, periodic=True),
        grid=tdomain.ProcessGrid((1, 1, 1)), dt=1.0, capacity=8, n_local=8,
        engine="planar",
    )
    with pytest.raises(ValueError, match="deposit_shape"):
        tnbody.make_migrate_loop(
            cfg, 1, vgrid=tdomain.ProcessGrid(GRID), device="cpu",
            deposit_each_step=True,
        )
