"""Port mover-sparse migrate engine (the default ``engine="auto"`` on one
device with vranks) against the JAX package.

The sparse engine is an engine, not a semantic: its output must equal the
planar engine's bits, slot order, free stack and every stat included
(``fast_path`` aside, which the planar engine does not have). The JAX
sparse loop does not trace on this jax (ROADMAP.md C1), so the port's
sparse loop is held against the JAX PLANAR loop bit for bit, which is the
reference's own contract for the engine (``tests/test_migrate_sparse.py``).
The selection front end (``binning.sorted_mover_block``) and the engine
resolution are held against the reference's functions directly. dt is a
power of two or 1.0 where positions drift (see ``test_torch_migrate``)."""

import numpy as np
import pytest

import jax
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from mpi_grid_redistribute_tpu import domain as jdomain
from mpi_grid_redistribute_tpu.models import nbody as jnbody
from mpi_grid_redistribute_tpu.ops import binning as jbinning
from mpi_grid_redistribute_tpu.parallel import exchange as jexchange
from mpi_grid_redistribute_tpu.parallel import mesh as mesh_lib
from mpi_grid_redistribute_tpu_torch import domain as tdomain
from mpi_grid_redistribute_tpu_torch.bench import common as tcommon
from mpi_grid_redistribute_tpu_torch.models import nbody as tnbody
from mpi_grid_redistribute_tpu_torch.ops import binning as tbinning
from mpi_grid_redistribute_tpu_torch.parallel import exchange as texchange
from mpi_grid_redistribute_tpu_torch.parallel import migrate as tmig

torch.set_num_threads(1)

GRID = (2, 2, 2)
STAT_FIELDS = ("sent", "received", "population", "backlog", "dropped_recv",
               "flow")


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x).view(np.uint8)


# ------------------------------------------------------------ selection


@pytest.mark.parametrize("n", [8, 16, 64, 100, 256, 4096, 5000, 1 << 20])
def test_sparse_select_params_match_jax(n):
    for block in (1, 2, 7, 16, 64, 200, 1000, 24537, n):
        for chunk in (4096, 1024):
            assert tbinning.sparse_select_params(n, block, chunk=chunk) == \
                jbinning.sparse_select_params(n, block, chunk=chunk)


@pytest.mark.parametrize("flat_env", [False, True])
def test_sparse_select_feasible_matches_jax(monkeypatch, flat_env):
    if flat_env:
        monkeypatch.setenv("MPI_GRID_SELECT", "flat")
    else:
        monkeypatch.delenv("MPI_GRID_SELECT", raising=False)
    seen = set()
    for n in (16, 64, 256, 4096, 5000, 1 << 20, 1 << 27):
        for n_dest in (1, 8, 64, 1 << 10, 1 << 14):
            for chunk, cap in ((4096, 512), (2048, 1024), (1000, 8),
                               (128, 32)):
                got = tbinning.sparse_select_feasible(
                    n, n_dest, chunk=chunk, cap=cap
                )
                assert got == jbinning.sparse_select_feasible(
                    n, n_dest, chunk=chunk, cap=cap
                ), (n, n_dest, chunk, cap)
                seen.add(got)
    assert seen == ({False} if flat_env else {False, True})


def _keys(r, V, n, n_dest, frac, hot_chunk=None, chunk=4096):
    dest = np.full((V, n), n_dest, np.int32)
    leave = r.random((V, n)) < frac
    if hot_chunk is not None:  # one chunk of row 0 full of leavers
        leave[0, hot_chunk * chunk : (hot_chunk + 1) * chunk] = True
    dest[leave] = r.integers(0, n_dest, int(leave.sum()))
    return dest


@pytest.mark.parametrize("case", ["ok", "chunk_over_cap", "over_block",
                                  "zero_pad", "ragged"])
def test_sorted_mover_block_matches_jax(case):
    r = np.random.default_rng(["ok", "chunk_over_cap", "over_block",
                               "zero_pad", "ragged"].index(case))
    V, n, n_dest, block, chunk, cap = 8, 4096, 8, 200, 512, 64
    if case == "ok":
        dest = _keys(r, V, n, n_dest, 0.02)
    elif case == "chunk_over_cap":
        dest = _keys(r, V, n, n_dest, 0.01, hot_chunk=3, chunk=chunk)
    elif case == "over_block":
        dest = _keys(r, V, n, n_dest, 0.08)  # ~330 leavers > 200
    elif case == "zero_pad":
        block = 700  # > nc * cap = 512: the block is zero padded
        chunk, cap = 1024, 128
        dest = _keys(r, V, n, n_dest, 0.02)
    else:
        n, chunk, cap = 5000, 1024, 64  # a padded last chunk
        dest = _keys(r, V, n, n_dest, 0.02)
    want = jax.jit(
        lambda d: jbinning.sorted_mover_block(
            d, n_dest, block, chunk=chunk, cap=cap
        )
    )(dest)
    got = tbinning.sorted_mover_block(
        torch.from_numpy(dest), n_dest, block, chunk=chunk, cap=cap
    )
    assert got[0].shape == (V, block) and got[0].dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert bool(got[3]) == (case in ("ok", "zero_pad", "ragged"))


def test_sorted_mover_block_infeasible_raises():
    dest = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="infeasible"):
        tbinning.sorted_mover_block(dest, 2, 16, chunk=32, cap=32)


# ------------------------------------------------------ engine resolution


def test_resolve_engine_matches_jax():
    cases = 0
    for engine in texchange.ENGINES + ("warp",):
        for vranks in (False, True):
            for n_devices in (1, 8):
                for canonical in (False, True):
                    for planar_ok in (True, False):
                        for n_pods in (1, 2):
                            kw = dict(vranks=vranks, n_devices=n_devices,
                                      canonical=canonical,
                                      planar_ok=planar_ok, n_pods=n_pods)
                            try:
                                want = jexchange.resolve_engine(engine, **kw)
                            except ValueError as e:
                                with pytest.raises(ValueError) as got:
                                    texchange.resolve_engine(engine, **kw)
                                assert str(got.value) == str(e)
                            else:
                                assert texchange.resolve_engine(
                                    engine, **kw) == want, (engine, kw)
                            cases += 1
    assert texchange.ENGINES == jexchange.ENGINES and cases == 7 * 32


def test_resolve_engine_recorder_is_not_ported():
    with pytest.raises(NotImplementedError, match="telemetry"):
        texchange.resolve_engine("auto", vranks=True, recorder=object())


# ------------------------------------------------------ the sparse loop


def _drift_inputs(v_shape, n_local, r, hole_frac=0.125):
    """Legal start state (the reference test's): uniform positions, live
    only on the slab that owns them."""
    vgrid = jdomain.ProcessGrid(v_shape)
    n = vgrid.nranks * n_local
    pos = r.random((n, 3), dtype=np.float32)
    vel = (0.6 * (r.random((n, 3), dtype=np.float32) - 0.5)).astype(
        np.float32
    )
    alive = r.random(n) > hole_frac
    domain = jdomain.Domain(0.0, 1.0, periodic=True)
    dest = jbinning.rank_of_position(pos, domain, vgrid, xp=np)
    alive &= dest == np.repeat(np.arange(vgrid.nranks), n_local)
    return pos, vel, alive


def _jax_planar(v_shape, pos, vel, alive, *, n_local, capacity, budget,
                dt, steps):
    dev_grid = jdomain.ProcessGrid((1, 1, 1))
    mesh = mesh_lib.make_mesh(dev_grid, devices=jax.devices()[:1])
    cfg = jnbody.DriftConfig(
        domain=jdomain.Domain(0.0, 1.0, periodic=True), grid=dev_grid,
        dt=dt, capacity=capacity, n_local=n_local, local_budget=budget,
        engine="planar",
    )
    return jax.tree.map(np.asarray, jnbody.make_migrate_loop(
        cfg, mesh, steps, vgrid=jdomain.ProcessGrid(v_shape)
    )(pos, vel, alive))


def _port(v_shape, pos, vel, alive, *, n_local, capacity, budget, dt,
          steps, **engine):
    cfg = tnbody.DriftConfig(
        domain=tdomain.Domain(0.0, 1.0, periodic=True),
        grid=tdomain.ProcessGrid((1, 1, 1)), dt=dt, capacity=capacity,
        n_local=n_local, local_budget=budget, **engine,
    )
    return tnbody.make_migrate_loop(
        cfg, steps, vgrid=tdomain.ProcessGrid(v_shape), device="cpu"
    )(pos, vel, alive)


def _assert_bitexact(got, want):
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    for f in STAT_FIELDS:
        np.testing.assert_array_equal(
            _bits(getattr(got[3], f)), _bits(getattr(want[3], f)), f
        )


def _both(v_shape, pos, vel, alive, steps, **kw):
    engine = {k: kw.pop(k) for k in ("engine", "mover_cap") if k in kw}
    want = _jax_planar(v_shape, pos, vel, alive, steps=steps, **kw)
    got = _port(v_shape, pos, vel, alive, steps=steps, **kw, **engine)
    _assert_bitexact(got, want)
    return got


def test_default_engine_bit_equal_to_jax_planar_reference_mesh():
    """The reference test's single-device mesh and sizing (capacity =
    n_local, no budget), the DriftConfig default engine."""
    n_local = 64
    pos, vel, alive = _drift_inputs(GRID, n_local, np.random.default_rng(1234))
    got = _both(GRID, pos, vel, alive, 5, n_local=n_local, capacity=n_local,
                budget=None, dt=0.0625)
    fp = got[3].fast_path.numpy()
    assert fp.shape == (5, 8) and fp.dtype == np.int32
    assert (fp == fp[:, :1]).all()  # one branch per step, all vranks
    assert int(got[3].sent.sum()) > 0


@pytest.mark.parametrize("n_local", [256, 4096])
def test_bench_sizing_takes_the_fast_path_every_step(n_local):
    """The bench's sizing at a small width: ~2% movers per step, every
    step on the fast branch (asserted, so the equality is not vacuous)."""
    v, cap, budget = tcommon.drift_sizing(GRID, n_local, 0.9, 0.02)
    pos, vel, alive = tcommon.uniform_state(
        GRID, n_local, 0.9, np.random.default_rng(n_local), vel_scale=v
    )
    got = _both(GRID, pos, vel, alive, 5, n_local=n_local, capacity=cap,
                budget=budget, dt=1.0, engine="auto")
    assert got[3].fast_path.numpy().all()
    assert int(got[3].sent.sum()) > 0
    assert int(got[2].sum()) == int(alive.sum())


def test_zero_movers_fast_path_every_step():
    n_local = 64
    pos, vel, alive = _drift_inputs(GRID, n_local, np.random.default_rng(7))
    got = _both(GRID, pos, vel, alive, 4, n_local=n_local, capacity=n_local,
                budget=None, dt=0.0, engine="sparse")
    assert int(got[3].sent.sum()) == 0
    assert got[3].fast_path.numpy().all()


def test_full_swap_falls_back_bit_exact():
    """Every row of two full vranks moves: the candidate cap cannot hold
    it, so the step runs dense and stays bit-exact."""
    n_local = 64
    n = 2 * n_local
    r = np.random.default_rng(1234)
    pos = r.random((n, 3), dtype=np.float32)
    pos[:n_local, 0] = 0.75
    pos[n_local:, 0] = 0.25
    vel = np.zeros((n, 3), dtype=np.float32)
    alive = np.ones(n, dtype=bool)
    got = _both((2, 1, 1), pos, vel, alive, 1, n_local=n_local,
                capacity=n_local, budget=None, dt=0.0, engine="sparse",
                mover_cap=8)
    assert int(got[3].sent.sum()) == n
    assert not got[3].fast_path.numpy().any()


def test_select_flat_env_runs_dense(monkeypatch):
    monkeypatch.setenv("MPI_GRID_SELECT", "flat")
    n_local = 64
    pos, vel, alive = _drift_inputs(GRID, n_local, np.random.default_rng(3))
    syncs = tmig.HOST_SYNCS["sparse_guard"]
    got = _both(GRID, pos, vel, alive, 3, n_local=n_local, capacity=n_local,
                budget=None, dt=0.0625, engine="sparse")
    fp = got[3].fast_path.numpy()
    assert fp.shape == (3, 8) and not fp.any()
    assert tmig.HOST_SYNCS["sparse_guard"] == syncs  # no guard to read


def _bench_state(n_local, seed=5):
    v, cap, budget = tcommon.drift_sizing(GRID, n_local, 0.9, 0.02)
    state = tcommon.uniform_state(
        GRID, n_local, 0.9, np.random.default_rng(seed), vel_scale=v
    )
    return state, dict(n_local=n_local, capacity=cap, budget=budget, dt=1.0)


def test_one_host_read_per_step():
    (pos, vel, alive), kw = _bench_state(256)
    before = tmig.HOST_SYNCS["sparse_guard"]
    out = _port(GRID, pos, vel, alive, steps=6, **kw)
    assert tmig.HOST_SYNCS["sparse_guard"] - before == 6
    assert out[3].fast_path.shape == (6, 8)
    before = tmig.HOST_SYNCS["sparse_guard"]
    _port(GRID, pos, vel, alive, steps=3, engine="planar", **kw)
    assert tmig.HOST_SYNCS["sparse_guard"] == before


@pytest.mark.parametrize("mover_cap,budget,want", [
    (16, 100, 16), (None, 100, 100), (None, None, 8 * 64),
])
def test_mover_cap_resolution(monkeypatch, mover_cap, budget, want):
    """cfg.mover_cap, then cfg.local_budget, then V * capacity, as the
    reference's make_migrate_loop resolves it; planar builds none."""
    seen = []
    real = tmig.shard_migrate_vranks_fn

    def spy(*a, **kw):
        seen.append(kw["mover_cap"])
        return real(*a, **kw)

    monkeypatch.setattr(tmig, "shard_migrate_vranks_fn", spy)
    for engine in ("auto", "planar"):
        cfg = tnbody.DriftConfig(
            domain=tdomain.Domain(0.0, 1.0, periodic=True),
            grid=tdomain.ProcessGrid((1, 1, 1)), dt=1.0, capacity=64,
            n_local=64, local_budget=budget, mover_cap=mover_cap,
            engine=engine,
        )
        tnbody.make_migrate_loop(cfg, 1, vgrid=tdomain.ProcessGrid(GRID),
                                 device="cpu")
    assert seen == [want, None]


def test_zero_steps_stacks_an_empty_fast_path():
    (pos, vel, alive), kw = _bench_state(64)
    out = _port(GRID, pos, vel, alive, steps=0, **kw)
    assert tuple(out[3].fast_path.shape) == (0, 8)
    out = _port(GRID, pos, vel, alive, steps=0, engine="planar", **kw)
    assert out[3].fast_path is None


class _OpLog(TorchDispatchMode):
    """Every ATen op with the tensors it returns."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((func, [t for t in tree_leaves(out)
                                if isinstance(t, torch.Tensor)]))
        return out


def test_fast_branch_runs_no_resident_scale_op(monkeypatch):
    """The counterpart of the reference's jaxpr cost contract: inside the
    fast branch no op sorts, and none returns a new tensor of n or more
    elements per vrank; only the in-place updates of the state (the
    landing on ``flat``, the free-stack window) touch resident-sized
    storage."""
    (pos, vel, alive), kw = _bench_state(256)
    calls = []
    real = tmig._fast_step

    def logged(flat, free_stack, *rest):
        log = _OpLog()
        with log:
            out = real(flat, free_stack, *rest)
        calls.append((log.ops, flat, free_stack))
        return out

    monkeypatch.setattr(tmig, "_fast_step", logged)
    out = _port(GRID, pos, vel, alive, steps=3, engine="sparse",
                mover_cap=16, **kw)
    assert out[3].fast_path.numpy().all() and len(calls) == 3
    V, n = 8, 256
    for ops, flat, stack in calls:
        state = {flat.untyped_storage().data_ptr(),
                 stack.untyped_storage().data_ptr()}
        assert ops
        for func, outs in ops:
            assert str(func).split(".")[1] not in ("sort", "argsort"), func
            for t in outs:
                if t.untyped_storage().data_ptr() in state:
                    continue  # an in-place update of the state
                assert t.numel() < V * n, (func, tuple(t.shape))
