"""Port load-balanced decomposition (``cells``/``assignment`` on the
drift/migrate loop) against the JAX package on one CPU device.

``balanced_assignment`` returns the reference's tuple exactly (ties
included). The port's dense planar engine with an assignment is BIT-equal
to the reference's ``engine="planar"`` loop in position, velocity, alive
flags and every stats leaf, backlog included (the reference's default
engine does not trace under an assignment on this jax: ROADMAP C1), and
the port's sparse engine equals the port's planar engine. Under an
assignment the loop never runs the drift-bin kernel (its key is the
canonical vrank's) and the mxu deposit takes the flat position-keyed
engine. dt is 1.0 or 0 (a jitted JAX drift on the CPU contracts
``p + v*dt`` into a fused multiply-add; see ``test_torch_migrate``)."""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from mpi_grid_redistribute_tpu import domain as jdomain
from mpi_grid_redistribute_tpu.models import nbody as jnbody
from mpi_grid_redistribute_tpu.ops import binning as jbinning
from mpi_grid_redistribute_tpu.parallel import mesh as mesh_lib
from mpi_grid_redistribute_tpu.parallel import migrate as jmig
from mpi_grid_redistribute_tpu_torch import domain as tdomain
from mpi_grid_redistribute_tpu_torch.models import nbody as tnbody
from mpi_grid_redistribute_tpu_torch.ops import binning as tbinning
from mpi_grid_redistribute_tpu_torch.ops import deposit as tdep
from mpi_grid_redistribute_tpu_torch.ops import driftbin
from mpi_grid_redistribute_tpu_torch.parallel import migrate as tmig

torch.set_num_threads(1)

STAT_FIELDS = ("sent", "received", "population", "backlog", "dropped_recv",
               "flow")


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x).view(np.uint8)


def _assert_same(got, want, fields=STAT_FIELDS):
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    for f in fields:
        np.testing.assert_array_equal(
            _bits(getattr(got[3], f)), _bits(getattr(want[3], f)), f
        )


# ---- balanced_assignment -------------------------------------------------


@pytest.mark.parametrize("kind", ["lognormal", "ties", "zeros", "few",
                                  "uniform_counts"])
@pytest.mark.parametrize("n_ranks", [1, 3, 8])
def test_balanced_assignment_matches_jax(kind, n_ranks):
    r = np.random.default_rng(n_ranks)
    loads = {
        "lognormal": (r.lognormal(0.0, 1.5, 64) * 100).astype(np.int64),
        "ties": np.repeat(np.asarray([5, 9, 5, 1]), 16),
        "zeros": np.zeros(16, np.int64),
        "few": r.integers(0, 3, n_ranks),
        "uniform_counts": r.integers(900, 1100, 27),
    }[kind]
    got = tmig.balanced_assignment(loads, n_ranks)
    assert isinstance(got, tuple) and all(type(g) is int for g in got)
    assert got == jmig.balanced_assignment(loads, n_ranks)


def test_balanced_assignment_raises_like_jax():
    for loads, n in ((np.ones(4), 8), (np.ones((8, 8)), 8)):
        with pytest.raises(ValueError, match="cells"):
            tmig.balanced_assignment(loads, n)
        with pytest.raises(ValueError, match="cells"):
            jmig.balanced_assignment(loads, n)


# ---- validation (the reference's tests/test_migrate.py cases) -------------


def test_migrate_assignment_validation():
    domain = tdomain.Domain(0.0, 1.0, periodic=True)
    dev_grid = tdomain.ProcessGrid((1, 1, 1))
    vgrid = tdomain.ProcessGrid((2, 1, 1))
    cells = tdomain.ProcessGrid((4, 1, 1))
    with pytest.raises(ValueError, match="together"):
        tmig.shard_migrate_vranks_fn(domain, dev_grid, vgrid, 8,
                                     assignment=(0, 1, 0, 1))
    with pytest.raises(ValueError, match="together"):
        tmig.shard_migrate_vranks_fn(domain, dev_grid, vgrid, 8,
                                     cells=cells)
    with pytest.raises(ValueError, match="entries"):
        tmig.shard_migrate_vranks_fn(domain, dev_grid, vgrid, 8,
                                     cells=cells, assignment=(0, 1))
    with pytest.raises(ValueError, match="outside"):
        tmig.shard_migrate_vranks_fn(domain, dev_grid, vgrid, 8,
                                     cells=cells, assignment=(0, 1, 2, 1))
    with pytest.raises(ValueError, match="outside"):
        tmig.shard_migrate_vranks_fn(domain, dev_grid, vgrid, 8,
                                     cells=cells, assignment=(0, -1, 0, 1))
    cfg = tnbody.DriftConfig(
        domain=domain, grid=dev_grid, dt=0.0, capacity=8, n_local=16,
        cells=cells, assignment=(0, 1, 0, 1),
    )
    with pytest.raises(ValueError, match="vrank path"):
        tnbody.make_migrate_loop(cfg, 1, device="cpu")  # no vgrid
    # the scan and mxu deposits key by position, so they compose with an
    # assignment on one device...
    for method in ("scan", "mxu"):
        tnbody.make_migrate_loop(
            dataclasses.replace(cfg, deposit_shape=(4, 4, 4),
                                deposit_method=method),
            1, vgrid=vgrid, device="cpu",
        )
    # ...the per-vrank block deposit and any multi-device grid do not
    cfg3 = dataclasses.replace(cfg, deposit_shape=(4, 4, 4),
                               deposit_method="segment")
    with pytest.raises(ValueError, match="deposit"):
        tnbody.make_migrate_loop(cfg3, 1, vgrid=vgrid, device="cpu")
    cfg4 = dataclasses.replace(
        cfg, deposit_shape=(4, 4, 4), grid=tdomain.ProcessGrid((2, 1, 1)),
        cells=tdomain.ProcessGrid((2, 2, 1)), assignment=(0, 1, 0, 1),
    )
    with pytest.raises(ValueError, match="deposit"):
        tnbody.make_migrate_loop(cfg4, 1, vgrid=tdomain.ProcessGrid((1, 2, 1)),
                                 device="cpu")
    # without a deposit a multi-device grid runs one device a process:
    # it needs a process group (or a mesh) to be one of the ranks
    with pytest.raises(ValueError, match="torch.distributed"):
        tnbody.make_migrate_loop(
            dataclasses.replace(cfg4, deposit_shape=None), 1,
            vgrid=tdomain.ProcessGrid((1, 2, 1)), device="cpu",
        )


# ---- the loop against the reference ---------------------------------------


def _balanced_inputs(cells, vgrid_shape, total, seed, headroom=1.5,
                     v=0.1, fill_holes=False):
    """Log-normal clustered rows placed on their ASSIGNED vranks (the
    reference test's set-up): ``(assign, n_local, pos, vel, alive)``."""
    r = np.random.default_rng(seed)
    domain = jdomain.Domain(0.0, 1.0, periodic=True)
    V = int(np.prod(vgrid_shape))
    pos = (r.lognormal(-1.0, 1.2, size=(total, 3)) % 1.0).astype(np.float32)
    cell = jbinning.rank_of_position(pos, domain,
                                     jdomain.ProcessGrid(cells), xp=np)
    assign = jmig.balanced_assignment(
        np.bincount(cell, minlength=int(np.prod(cells))), V
    )
    owner = np.asarray(assign)[cell]
    bins = np.bincount(owner, minlength=V)
    n_local = int(bins.max() * headroom)
    pos_p = np.zeros((V * n_local, 3), np.float32)
    vel_p = np.zeros((V * n_local, 3), np.float32)
    if fill_holes:  # hole slots hold garbage the engine must ignore
        pos_p[:] = np.nan
    alive = np.zeros((V * n_local,), bool)
    vel = (v * (r.random((total, 3), dtype=np.float32) - 0.5)).astype(
        np.float32
    )
    for w in range(V):
        m = owner == w
        k = int(m.sum())
        pos_p[w * n_local : w * n_local + k] = pos[m]
        vel_p[w * n_local : w * n_local + k] = vel[m]
        alive[w * n_local : w * n_local + k] = True
    return assign, n_local, pos_p, vel_p, alive


def _run_both(cells, vgrid_shape, assign, n_local, capacity, budget, dt,
              steps, pos, vel, alive, deposit=None, **engine):
    dev_grid = jdomain.ProcessGrid((1, 1, 1))
    mesh = mesh_lib.make_mesh(dev_grid, devices=jax.devices()[:1])
    dep = {} if deposit is None else dict(deposit_shape=deposit[0],
                                          deposit_method=deposit[1])
    jcfg = jnbody.DriftConfig(
        domain=jdomain.Domain(0.0, 1.0, periodic=True), grid=dev_grid,
        dt=dt, capacity=capacity, n_local=n_local, local_budget=budget,
        cells=jdomain.ProcessGrid(cells), assignment=assign,
        engine="planar", **dep,
    )
    want = jax.tree.map(np.asarray, jnbody.make_migrate_loop(
        jcfg, mesh, steps, vgrid=jdomain.ProcessGrid(vgrid_shape)
    )(pos, vel, alive))
    got = _port(cells, vgrid_shape, assign, n_local, capacity, budget, dt,
                steps, pos, vel, alive, engine="planar", **dep)
    return got, want


def _port(cells, vgrid_shape, assign, n_local, capacity, budget, dt, steps,
          pos, vel, alive, **kw):
    cfg = tnbody.DriftConfig(
        domain=tdomain.Domain(0.0, 1.0, periodic=True),
        grid=tdomain.ProcessGrid((1, 1, 1)), dt=dt, capacity=capacity,
        n_local=n_local, local_budget=budget,
        cells=tdomain.ProcessGrid(cells), assignment=assign, **kw,
    )
    return tnbody.make_migrate_loop(
        cfg, steps, vgrid=tdomain.ProcessGrid(vgrid_shape), device="cpu"
    )(pos, vel, alive)


def _assert_owned(cells, assign, n_local, out):
    """Every live row sits on the vrank its cell is assigned to (binned
    independently of the port, by the reference's NumPy path)."""
    pos = tnbody.planar_to_rows(out[0], 3, 1)
    alive = out[2].numpy()
    cell = jbinning.rank_of_position(
        pos, jdomain.Domain(0.0, 1.0, periodic=True),
        jdomain.ProcessGrid(cells), xp=np,
    )
    owner = np.asarray(assign)[cell]
    slot = np.arange(pos.shape[0]) // n_local
    assert (owner[alive] == slot[alive]).all()


# (cells, vgrid, total rows, budget as a share of n_local, seed): the
# tight budgets leave a backlog that drains over the steps
LAYOUTS = [
    ((4, 4, 4), (2, 2, 2), 2048, 1.0, 0),
    ((4, 4, 4), (2, 2, 2), 2048, 0.05, 1),
    ((4, 2, 2), (2, 1, 1), 1500, 1.0, 2),
    ((4, 2, 2), (2, 1, 1), 1500, 0.04, 3),
]


@pytest.mark.parametrize("cells,vgrid_shape,total,budget_share,seed",
                         LAYOUTS)
def test_assignment_loop_bit_equal_to_jax_planar(cells, vgrid_shape, total,
                                                 budget_share, seed):
    assign, n_local, pos, vel, alive = _balanced_inputs(
        cells, vgrid_shape, total, seed, fill_holes=seed % 2 == 1
    )
    budget = max(8, int(budget_share * n_local))
    got, want = _run_both(cells, vgrid_shape, assign, n_local, n_local,
                          budget, 1.0, 5, pos, vel, alive)
    _assert_same(got, want)
    stats = got[3]
    assert int(stats.sent.sum()) > 0
    assert int(stats.dropped_recv.sum()) == 0
    assert int(got[2].sum()) == total
    if budget_share < 1:
        assert int(stats.backlog.sum()) > 0  # the budget did clip
    if int(stats.backlog[-1].sum()) == 0:
        _assert_owned(cells, assign, n_local, got)
    # the sparse engine (the default) equals the planar one
    sparse = _port(cells, vgrid_shape, assign, n_local, n_local, budget,
                   1.0, 5, pos, vel, alive)
    _assert_same(sparse, got)
    assert sparse[3].fast_path is not None


def test_assignment_sparse_engine_takes_the_fast_path():
    """At a sizing like the bench's (~2% movers a step) the guard holds on
    every step, and the state still equals the planar engine's."""
    cells, vgrid_shape = (4, 4, 4), (2, 2, 2)
    assign, n_local, pos, vel, alive = _balanced_inputs(
        cells, vgrid_shape, 8192, 5, headroom=1.3, v=0.01
    )
    budget = max(256, int(n_local * 0.04))
    args = (cells, vgrid_shape, assign, n_local, budget, budget, 1.0, 4,
            pos, vel, alive)
    sparse = _port(*args)
    planar = _port(*args, engine="planar")
    _assert_same(sparse, planar)
    assert sparse[3].fast_path.numpy().all()
    assert int(sparse[3].sent.sum()) > 0
    _assert_owned(cells, assign, n_local, sparse)


def test_assignment_loop_never_runs_the_driftbin_kernel(monkeypatch):
    """Kernel 1's key is the canonical vrank's: under an assignment it
    would land rows on the wrong slabs. The loop must not call it."""
    cells, vgrid_shape = (4, 4, 4), (2, 2, 2)
    assign, n_local, pos, vel, alive = _balanced_inputs(
        cells, vgrid_shape, 2048, 6
    )
    want = _port(cells, vgrid_shape, assign, n_local, n_local, n_local,
                 1.0, 3, pos, vel, alive)

    def boom(*a, **k):
        raise AssertionError("drift_wrap_bin ran under an assignment")

    monkeypatch.setattr(driftbin, "drift_wrap_bin", boom)
    monkeypatch.setattr(driftbin, "drift_wrap_bin_plain", boom)
    got = _port(cells, vgrid_shape, assign, n_local, n_local, n_local,
                1.0, 3, pos, vel, alive)
    _assert_same(got, want, STAT_FIELDS + ("fast_path",))
    _assert_owned(cells, assign, n_local, got)


def test_canonical_key_would_misplace_rows():
    """The ownership check catches the canonical vrank key: binning the
    same state with the vrank grid instead of the table routes rows
    elsewhere."""
    cells, vgrid_shape = (4, 4, 4), (2, 2, 2)
    assign, n_local, pos, vel, alive = _balanced_inputs(
        cells, vgrid_shape, 2048, 7
    )
    p = torch.from_numpy(tnbody.rows_to_planar(pos, 1)).reshape(3, -1)
    a = torch.from_numpy(alive)
    domain = tdomain.Domain(0.0, 1.0, periodic=True)
    table = torch.tensor(assign, dtype=torch.int32)
    key = tbinning.dest_key_planar(p, a, domain, tdomain.ProcessGrid(cells),
                                   8, 8, assignment=table)
    canon = tbinning.dest_key_planar(p, a, domain,
                                     tdomain.ProcessGrid(vgrid_shape), 8, 8)
    # the rows sit on their assigned vranks: nobody leaves...
    assert bool((key == 8).all())
    # ...but the canonical key would move most of them
    assert int((canon[a.reshape(8, -1)] != 8).sum()) > alive.sum() // 2


def test_placement_64_vranks_drains_bit_equal_to_jax():
    """The config-2 placement at a small width: 64 vranks, rows not on
    their owners, dt = 0, a small per-pair capacity. Dense steps with a
    backlog until the rows drain, nothing dropped."""
    from mpi_grid_redistribute_tpu.bench import common as jcommon

    from mpi_grid_redistribute_tpu_torch.bench import common as tcommon

    n_base = 256
    grid = (4, 4, 4)
    pos, alive = tcommon.lognormal_state(grid, n_base, 0.5,
                                         np.random.default_rng(7))
    jpos, jalive = jcommon.lognormal_state(grid, n_base, 0.5,
                                           np.random.default_rng(7))
    np.testing.assert_array_equal(_bits(pos), _bits(jpos))
    np.testing.assert_array_equal(alive, jalive)
    vel = np.zeros_like(pos)
    cap = max(64, -(-n_base // 16))
    dev_grid = jdomain.ProcessGrid((1, 1, 1))
    mesh = mesh_lib.make_mesh(dev_grid, devices=jax.devices()[:1])
    jcfg = jnbody.DriftConfig(
        domain=jdomain.Domain(0.0, 1.0, periodic=True), grid=dev_grid,
        dt=0.0, capacity=cap, n_local=n_base, local_budget=cap // 2,
        engine="planar",
    )
    steps = 12
    want = jax.tree.map(np.asarray, jnbody.make_migrate_loop(
        jcfg, mesh, steps, vgrid=jdomain.ProcessGrid(grid)
    )(pos, vel, alive))
    tcfg = tnbody.DriftConfig(
        domain=tdomain.Domain(0.0, 1.0, periodic=True),
        grid=tdomain.ProcessGrid((1, 1, 1)), dt=0.0, capacity=cap,
        n_local=n_base, local_budget=cap // 2,
    )
    got = tnbody.make_migrate_loop(
        tcfg, steps, vgrid=tdomain.ProcessGrid(grid), device="cpu"
    )(pos, vel, alive)
    _assert_same(got, want)
    st = got[3]
    assert int(st.dropped_recv.sum()) == 0
    assert int(st.backlog[0].sum()) > 0  # the budget clipped step 1
    assert int(st.sent[-1].sum()) == 0 and int(st.backlog[-1].sum()) == 0
    # a step that leaves a backlog fails the sparse guard and runs dense
    clipped = st.backlog.sum(dim=1) > 0
    assert bool(clipped[0]) and not st.fast_path[clipped].any()


# ---- deposits under an assignment ------------------------------------------


def test_assignment_scan_deposit_bit_equal_to_jax():
    cells, vgrid_shape = (4, 4, 4), (2, 2, 2)
    assign, n_local, pos, vel, alive = _balanced_inputs(
        cells, vgrid_shape, 2048, 8
    )
    got, want = _run_both(cells, vgrid_shape, assign, n_local, n_local,
                          n_local, 1.0, 3, pos, vel, alive,
                          deposit=((8, 8, 8), "scan"))
    _assert_same(got, want)
    np.testing.assert_array_equal(_bits(got[4]), _bits(want[4]))
    np.testing.assert_allclose(float(got[4].double().sum()), 2048, rtol=1e-5)


def test_assignment_mxu_deposit_takes_the_flat_engine(monkeypatch):
    """LPT vranks break the slab partition: the slab-keyed engine (and its
    residence guard) must not run; the flat position-keyed one does, and
    the density is within 2e-5 of the reference's."""
    cells, vgrid_shape = (4, 4, 4), (2, 2, 2)
    assign, n_local, pos, vel, alive = _balanced_inputs(
        cells, vgrid_shape, 2048, 9
    )
    calls = {"flat": 0}
    flat = tdep.cic_deposit_device_mxu

    def count_flat(*a, **k):
        calls["flat"] += 1
        return flat(*a, **k)

    def boom(*a, **k):
        raise AssertionError("the slab engine ran under an assignment")

    monkeypatch.setattr(tdep, "cic_deposit_device_mxu", count_flat)
    monkeypatch.setattr(tdep, "_slab_keys_mxu", boom)
    got, want = _run_both(cells, vgrid_shape, assign, n_local, n_local,
                          n_local, 1.0, 3, pos, vel, alive,
                          deposit=((8, 8, 8), "mxu"))
    _assert_same(got, want)
    assert calls["flat"] == 1
    np.testing.assert_allclose(got[4].numpy(), want[4], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(got[4].double().sum()), 2048, rtol=1e-5)
