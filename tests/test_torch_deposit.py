"""Port CIC deposit (mpi_grid_redistribute_tpu_torch.ops.deposit) vs the
JAX package's ``ops/deposit.py`` on one CPU device, module by module.

Contracts held here, and why:
  * ``bounds_dense``: exact integers;
  * the scan engine (``cic_deposit_vranks_planar``,
    ``cic_deposit_device_planar``, the per-device wrapper): BIT-equal on
    unit mass -- the same stable order, the same double-float sequence;
    with mass also within ``2e-5`` of a float64 oracle (the reference's
    own tolerance, ``tests/test_deposit.py``);
  * the mxu engine (``cic_deposit_device_mxu``,
    ``cic_deposit_vranks_mxu``): within ``rtol = atol = 2e-5`` of the
    JAX result and of the float64 oracle -- the reference's sort is
    unstable, so its per-cell summation order is not a contract;
  * ``fold_ghosts`` / ``assemble_dense`` on one device: BIT-equal, for a
    periodic and a mixed-periodic domain;
  * the slab engine's residence guard routes slab-resident rows to the
    slab branch and mis-slabbed rows to the flat branch (observed by
    poisoning each branch in turn, as the reference's test does)."""

import itertools

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
from mpi_grid_redistribute_tpu.ops import binning as jbinning
from mpi_grid_redistribute_tpu.ops import deposit as jdep
from mpi_grid_redistribute_tpu.parallel import mesh as mesh_lib
from mpi_grid_redistribute_tpu_torch import domain as tdomain
from mpi_grid_redistribute_tpu_torch.bench import config5_deposit
from mpi_grid_redistribute_tpu_torch.models import nbody as tnbody
from mpi_grid_redistribute_tpu_torch.ops import binning as tbinning
from mpi_grid_redistribute_tpu_torch.ops import deposit as tdep

torch.set_num_threads(1)

GRID1 = (1, 1, 1)


def _bits(got, want):
    got = np.ascontiguousarray(got.numpy())
    want = np.ascontiguousarray(np.asarray(want))
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _oracle(rel, mass, valid, block):
    """float64 CIC onto the +1-ghost mesh of ``block`` (no fold) from
    float64 block-local coordinates ``rel [n, D]``."""
    D = len(block)
    i0 = np.clip(np.floor(rel).astype(np.int64), 0, np.asarray(block) - 1)
    frac = np.clip(rel - i0, 0.0, 1.0)
    out = np.zeros(tuple(b + 1 for b in block))
    for corner in itertools.product((0, 1), repeat=D):
        off = np.asarray(corner)
        w = np.prod(np.where(off == 1, frac, 1.0 - frac), axis=1)
        idx = i0 + off
        np.add.at(out, tuple(idx[:, d] for d in range(D)),
                  np.where(valid, mass.astype(np.float64) * w, 0.0))
    return out


def _slab_state(r, vgrid_shape, n, legal=True):
    """``[D, V*n]`` planar positions: slab ``v`` inside vrank ``v``'s block
    of the unit box (``legal``) or one block further along every axis."""
    V = int(np.prod(vgrid_shape))
    g = np.asarray(vgrid_shape)
    pos = np.empty((V * n, 3), np.float32)
    for v, vc in enumerate(itertools.product(*[range(s) for s in g])):
        cell = np.asarray(vc) if legal else (np.asarray(vc) + 1) % g
        pos[v * n : (v + 1) * n] = (
            (cell + r.random((n, 3))) / g
        ).astype(np.float32)
    return np.ascontiguousarray(pos.T)


# ---- bounds_dense ------------------------------------------------------


@pytest.mark.parametrize("n,n_edges,hi", [
    (1000, 65, 64), (5000, 513, 512), (7, 300, 299), (0, 10, 9),
])
def test_bounds_dense_matches_jax(n, n_edges, hi):
    r = np.random.default_rng(n + n_edges)
    keys = np.sort(r.integers(0, hi + 1, n)).astype(np.int32)  # hi = sentinel
    got = tbinning.bounds_dense(_t(keys), n_edges)
    want = jax.jit(
        lambda k: jbinning.bounds_dense(k, n_edges, key_bound=hi)
    )(jnp.asarray(keys))
    assert got.dtype == torch.int32
    _bits(got, want)


def test_bounds_dense_strided_and_overflow():
    keys = np.sort(np.random.default_rng(1).integers(0, 4096, 3000)).astype(
        np.int32
    )
    got = tbinning.bounds_dense(_t(keys), 33, stride=128)
    want = jbinning.bounds_dense(jnp.asarray(keys), 33, stride=128,
                                 key_bound=4096)
    _bits(got, want)
    with pytest.raises(ValueError, match="int32"):
        tbinning.bounds_dense(_t(keys), 2**20, stride=2**12)


# ---- scan engine -------------------------------------------------------


@pytest.mark.parametrize("with_mass", [False, True])
@pytest.mark.parametrize("n,block,tile", [
    (20_000, (16, 16, 16), 256), (3000, (8, 8, 8), 64), (500, (8, 8), 256),
])
def test_device_planar_matches_jax(n, block, tile, with_mass):
    D = len(block)
    r = np.random.default_rng(n + D)
    pos = r.random((D, n)).astype(np.float32)
    valid = r.random(n) > 0.1
    mass = (r.uniform(0.5, 2.0, n) if with_mass else np.ones(n)).astype(
        np.float32
    )
    inv_h = np.asarray(block, np.float32)
    lo = np.zeros(D, np.float32)
    got = tdep.cic_deposit_device_planar(
        _t(pos), _t(mass), _t(valid), _t(lo), _t(inv_h), block, tile=tile
    )
    want = jax.jit(
        lambda p, m, v: jdep.cic_deposit_device_planar(
            p, m, v, jnp.asarray(lo), jnp.asarray(inv_h), block, tile=tile
        )
    )(pos, mass, valid)
    _bits(got, want)
    np.testing.assert_allclose(
        got.numpy(),
        _oracle(pos.T.astype(np.float64) * inv_h, mass, valid, block),
        rtol=2e-5, atol=2e-5,
    )


@pytest.mark.parametrize("channel_group", [None, 2, 3])
def test_sorted_per_segment_channel_groups_bit_equal(channel_group):
    """Grouping channels changes only packing, never a channel's sums."""
    r = np.random.default_rng(3)
    n, block = 4000, (8, 8, 8)
    rel = (r.random((3, n)) * 8).astype(np.float32)
    strides = np.array([64, 8, 1])[:, None]
    key = (np.floor(rel).astype(np.int32) * strides).sum(0)
    key = np.where(r.random(n) < 0.9, key, 512).astype(np.int32)
    mass = np.where(key < 512, r.random(n), 0).astype(np.float32)
    got = tdep._sorted_per_segment_planar(
        _t(key), _t(rel), _t(mass), 512, block, 256,
        channel_group=channel_group,
    )
    want = jax.jit(lambda k, rl, m: jdep._sorted_per_segment_planar(
        k, rl, m, 512, block, 256, channel_group=channel_group
    ))(key, rel, mass)
    _bits(got, want)


@pytest.mark.parametrize("vgrid_shape", [(2, 2, 2), (2, 1, 1)])
def test_vranks_planar_matches_jax(vgrid_shape):
    r = np.random.default_rng(sum(vgrid_shape))
    V = int(np.prod(vgrid_shape))
    n = 2000
    vblock = tuple(16 // g for g in vgrid_shape)
    pos = _slab_state(r, vgrid_shape, n)
    valid = r.random(V * n) > 0.2
    mass = np.ones(V * n, np.float32)
    vcells = np.asarray(list(itertools.product(
        *[range(g) for g in vgrid_shape])), np.float32)
    lo_all = (vcells / np.asarray(vgrid_shape, np.float32)).astype(np.float32)
    inv_h = np.full(3, 16.0, np.float32)
    got = tdep.cic_deposit_vranks_planar(
        _t(pos), _t(mass), _t(valid), _t(lo_all), _t(inv_h), vblock
    )
    want = jax.jit(lambda p, m, v: jdep.cic_deposit_vranks_planar(
        p, m, v, jnp.asarray(lo_all), jnp.asarray(inv_h), vblock
    ))(pos, mass, valid)
    _bits(got, want)
    assert abs(float(got.double().sum()) - valid.sum()) <= 1e-5 * valid.sum()


def test_vranks_planar_bound_raises():
    z = torch.zeros((3, 8))
    with pytest.raises(ValueError, match="2\\*\\*27"):
        tdep.cic_deposit_vranks_planar(
            z, torch.ones(8), torch.ones(8, dtype=torch.bool),
            torch.zeros((2, 3)), torch.ones(3), (512, 512, 512),
        )


# ---- mxu engine --------------------------------------------------------


@pytest.mark.parametrize("with_mass", [False, True])
def test_device_mxu_matches_jax_and_oracle(with_mass):
    r = np.random.default_rng(11)
    n, block = 60_000, (16, 16, 16)
    pos = r.random((3, n)).astype(np.float32)
    valid = r.random(n) > 0.1
    mass = r.random(n).astype(np.float32)
    inv_h = np.full(3, 16.0, np.float32)
    lo = np.zeros(3, np.float32)
    got = tdep.cic_deposit_device_mxu(
        _t(pos), _t(mass) if with_mass else None, _t(valid), _t(lo),
        _t(inv_h), block,
    ).numpy()
    want = np.asarray(jax.jit(lambda p, m, v: jdep.cic_deposit_device_mxu(
        p, m, v, jnp.asarray(lo), jnp.asarray(inv_h), block
    ))(pos, mass if with_mass else None, valid))
    m64 = mass if with_mass else np.ones(n, np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got, _oracle(pos.T.astype(np.float64) * 16, m64, valid, block),
        rtol=2e-5, atol=2e-5,
    )
    np.testing.assert_allclose(got.sum(), m64[valid].sum(), rtol=1e-5)


@pytest.mark.parametrize("with_mass", [False, True])
@pytest.mark.parametrize("vgrid_shape", [(2, 2, 1), (2, 2, 2)])
def test_vranks_mxu_matches_jax_and_flat_engine(vgrid_shape, with_mass):
    r = np.random.default_rng(int(np.prod(vgrid_shape)) + with_mass)
    V = int(np.prod(vgrid_shape))
    n = 8000
    dev_block = (16, 16, 16)
    vblock = tuple(b // g for b, g in zip(dev_block, vgrid_shape))
    pos = _slab_state(r, vgrid_shape, n)
    valid = r.random(V * n) > 0.1
    mass = r.uniform(0.5, 2.0, V * n).astype(np.float32)
    vcells = np.asarray(list(itertools.product(
        *[range(g) for g in vgrid_shape])), np.float32)
    lo_all = (vcells / np.asarray(vgrid_shape, np.float32)).astype(np.float32)
    inv_h = np.full(3, 16.0, np.float32)
    m_t = _t(mass) if with_mass else None
    got = tdep.cic_deposit_vranks_mxu(
        _t(pos), m_t, _t(valid), _t(lo_all), _t(inv_h), vblock, vgrid_shape
    ).numpy()
    want = np.asarray(jax.jit(lambda p, m, v: jdep.cic_deposit_vranks_mxu(
        p, m, v, jnp.asarray(lo_all), jnp.asarray(inv_h), vblock,
        vgrid_shape,
    ))(pos, mass if with_mass else None, valid))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    flat = tdep.cic_deposit_device_mxu(
        _t(pos), m_t, _t(valid), torch.zeros(3), _t(inv_h), dev_block
    ).numpy()
    np.testing.assert_allclose(got, flat, rtol=2e-5, atol=2e-5)
    m64 = mass if with_mass else np.ones(V * n, np.float32)
    np.testing.assert_allclose(
        got, _oracle(pos.T.astype(np.float64) * 16, m64, valid, dev_block),
        rtol=2e-5, atol=2e-5,
    )


# ---- ghost fold, dense assembly, per-device wrappers --------------------


def _one_device_mesh():
    grid = jdomain.ProcessGrid(GRID1)
    return grid, mesh_lib.make_mesh(grid, devices=jax.devices()[:1])


@pytest.mark.parametrize("periodic", [
    (True, True, True), (True, False, True), (False, False, False),
])
def test_fold_and_assemble_bit_equal(periodic):
    r = np.random.default_rng(sum(periodic))
    rho = r.standard_normal((9, 5, 7)).astype(np.float32)
    jgrid, mesh = _one_device_mesh()
    jd = jdomain.Domain(0.0, 1.0, periodic=periodic)
    tgrid = tdomain.ProcessGrid(GRID1)
    td = tdomain.Domain(0.0, 1.0, periodic=periodic)
    if all(periodic):
        want = jax.jit(lambda x: jdep.fold_ghosts(x, jgrid))(rho)
        got = tdep.fold_ghosts(_t(rho), tgrid)
    else:
        want = jax.jit(compat.shard_map(
            lambda x: jdep.assemble_dense(x, jgrid, jd), mesh=mesh,
            in_specs=P(), out_specs=P(),
        ))(rho)
        got = tdep.assemble_dense(_t(rho), tgrid, td)
    _bits(got, want)
    assert tdep.global_node_shape(td, (8, 4, 6)) == jdep.global_node_shape(
        jd, (8, 4, 6)
    )


@pytest.mark.parametrize("periodic", [True, (True, False, True)])
@pytest.mark.parametrize("method", ["scan", "mxu"])
def test_per_device_wrappers_match_jax(method, periodic):
    r = np.random.default_rng(5)
    n = 8 * 3000
    vgrid_shape = (2, 2, 2)
    jgrid, mesh = _one_device_mesh()
    jd = jdomain.Domain(0.0, 1.0, periodic=periodic)
    td = tdomain.Domain(0.0, 1.0, periodic=periodic)
    pos = _slab_state(r, vgrid_shape, n // 8)
    valid = r.random(n) > 0.1
    mass = np.ones(n, np.float32)
    shape = (8, 8, 8)
    if method == "scan":
        jfn = jdep.shard_deposit_device_planar_fn(jd, jgrid, shape)
        tfn = tdep.shard_deposit_device_planar_fn(
            td, tdomain.ProcessGrid(GRID1), shape
        )
        args = (pos, mass, valid)
    else:
        jfn = jdep.shard_deposit_device_mxu_fn(
            jd, jgrid, shape, vgrid=jdomain.ProcessGrid(vgrid_shape)
        )
        tfn = tdep.shard_deposit_device_mxu_fn(
            td, tdomain.ProcessGrid(GRID1), shape,
            vgrid=tdomain.ProcessGrid(vgrid_shape),
        )
        args = (pos, None, valid)
    axes = jgrid.axis_names
    want = np.asarray(jax.jit(compat.shard_map(
        lambda p, v: jfn(p, None if args[1] is None else jnp.ones(
            p.shape[1], jnp.float32), v),
        mesh=mesh, in_specs=(P(None, axes), P(axes)),
        out_specs=jdep.deposit_out_spec(jd, jgrid),
    ))(pos, valid))
    got = tfn(_t(pos), None if args[1] is None else _t(mass), _t(valid))
    assert tuple(got.shape) == want.shape
    if method == "scan":
        _bits(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.double().sum().item(), valid.sum(),
                               rtol=1e-5)


def test_multi_device_deposit_raises():
    # a multi-device deposit runs one rank a process: without a process
    # group (or a mesh) there is no rank to be
    g = tdomain.ProcessGrid((2, 1, 1))
    with pytest.raises(ValueError, match="torch.distributed"):
        tdep.shard_deposit_device_planar_fn(
            tdomain.Domain(0.0, 1.0, periodic=True), g, (8, 8, 8)
        )
    with pytest.raises(ValueError, match="torch.distributed"):
        tdep.fold_ghosts(torch.zeros((5, 5, 5)), g)


# ---- the residence guard -------------------------------------------------


@pytest.mark.parametrize("legal", [True, False])
def test_residence_guard_takes_the_right_branch(monkeypatch, legal):
    r = np.random.default_rng(7 + legal)
    vgrid = tdomain.ProcessGrid((2, 2, 2))
    pos = _t(_slab_state(r, (2, 2, 2), 1500, legal=legal))
    valid = torch.from_numpy(r.random(pos.shape[1]) > 0.1)
    dom = tdomain.Domain(0.0, 1.0, periodic=True)
    orig_flat = tdep.cic_deposit_device_mxu
    orig_slab = tdep._slab_deposit_from_keys

    def run():
        fn = tdep.shard_deposit_device_mxu_fn(
            dom, tdomain.ProcessGrid(GRID1), (8, 8, 8), vgrid=vgrid
        )
        return fn(pos, None, valid)

    syncs = tdep.HOST_SYNCS["residence_guard"]
    base = run()
    assert tdep.HOST_SYNCS["residence_guard"] == syncs + 1
    monkeypatch.setattr(tdep, "cic_deposit_device_mxu",
                        lambda *a, **k: orig_flat(*a, **k) + 1000.0)
    flat_poisoned = run()
    monkeypatch.setattr(tdep, "cic_deposit_device_mxu", orig_flat)
    monkeypatch.setattr(tdep, "_slab_deposit_from_keys",
                        lambda *a, **k: orig_slab(*a, **k) + 1000.0)
    slab_poisoned = run()
    if legal:
        assert torch.equal(base, flat_poisoned)
        assert (slab_poisoned - base).abs().max() > 100.0
    else:
        assert torch.equal(base, slab_poisoned)
        assert (flat_poisoned - base).abs().max() > 100.0


def test_mis_slabbed_loop_takes_the_flat_branch(monkeypatch):
    """A uniform-over-the-box start with tight capacity leaves backlogged
    rows on the wrong slab: those steps must take the flat engine, and
    the density still matches the JAX loop (whose lax.cond routes the
    same way)."""
    n_local, cap = 256, 16
    r = np.random.default_rng(9)
    pos = r.random((8 * n_local, 3), dtype=np.float32)
    vel = ((r.random((8 * n_local, 3), dtype=np.float32) - 0.5)
           * 0.0625).astype(np.float32)
    alive = r.random(8 * n_local) > 0.2
    flat_calls = []
    orig_flat = tdep.cic_deposit_device_mxu

    def counting(*a, **k):
        flat_calls.append(1)
        return orig_flat(*a, **k)

    monkeypatch.setattr(tdep, "cic_deposit_device_mxu", counting)
    tcfg = tnbody.DriftConfig(
        domain=tdomain.Domain(0.0, 1.0, periodic=True),
        grid=tdomain.ProcessGrid(GRID1), dt=1.0, capacity=cap,
        n_local=n_local, deposit_shape=(8, 8, 8), deposit_method="mxu",
        engine="planar",
    )
    syncs = tdep.HOST_SYNCS["residence_guard"]
    got = tnbody.make_migrate_loop(
        tcfg, 3, vgrid=tdomain.ProcessGrid((2, 2, 2)), device="cpu",
        deposit_each_step=True,
    )(pos, vel, alive)
    assert tdep.HOST_SYNCS["residence_guard"] == syncs + 3
    assert len(flat_calls) >= 1
    assert int(got[3].backlog.sum()) > 0
    jgrid, mesh = _one_device_mesh()
    jcfg = jnbody.DriftConfig(
        domain=jdomain.Domain(0.0, 1.0, periodic=True), grid=jgrid, dt=1.0,
        capacity=cap, n_local=n_local, deposit_shape=(8, 8, 8),
        deposit_method="mxu", engine="planar",
    )
    want = jnbody.make_migrate_loop(
        jcfg, mesh, 3, vgrid=jdomain.ProcessGrid((2, 2, 2)),
        deposit_each_step=True,
    )(pos, vel, alive)
    _bits(got[0], want[0])
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=2e-5, atol=2e-5)


def test_config5_build_matches_reference_sizing():
    cfg, vgrid, (pos, vel, alive) = config5_deposit.build(n_local=4096)
    v, cap, budget = jcommon.drift_sizing((2, 2, 2), 4096, 0.9, 0.02)
    assert (cfg.capacity, cfg.local_budget) == (cap, budget)
    assert cfg.deposit_shape == (128, 128, 128) and cfg.dt == 1.0
    # the reference's default engine ("auto": sparse on this layout)
    assert cfg.deposit_method == "mxu" and cfg.engine == "auto"
    assert vgrid.shape == (2, 2, 2)
    jpos, jvel, jalive = jcommon.uniform_state(
        (2, 2, 2), 4096, 0.9, np.random.default_rng(0), vel_scale=v
    )
    _bits(_t(pos), jpos)
    _bits(_t(vel), jvel)
    _bits(_t(alive), jalive)


# ---- the "segment" and row-major "scan" deposits -------------------------
#
# ``cic_deposit_local`` and the segment route of ``shard_deposit_vranks_fn``
# are BIT-equal on the CPU: XLA's CPU scatter-add adds the updates in row
# order, and the port reproduces the order in which XLA's CPU compiler
# combines the eight corners (see ``cic_deposit_vranks_segment``). The
# row-major scan engine is bit-equal as the planar one is.


def _vrank_slabs(r, vgrid_shape, n, with_mass):
    """Row-major ``[V, n, 3]`` slabs inside their vranks' blocks, a few
    NaN holes among the invalid rows, mass random or unit."""
    V = int(np.prod(vgrid_shape))
    pos = _slab_state(r, vgrid_shape, n).T.reshape(V, n, 3).copy()
    valid = r.random((V, n)) > 0.1
    pos[~valid] = np.where(r.random(((~valid).sum(), 1)) < 0.3, np.nan,
                           pos[~valid])
    mass = ((r.random((V, n)) + 0.5).astype(np.float32) if with_mass
            else np.ones((V, n), np.float32))
    return pos, mass, valid


@pytest.mark.parametrize("with_mass", [False, True])
@pytest.mark.parametrize("n,block", [(3000, (4, 4, 4)), (777, (3, 5, 2)),
                                     (500, (6, 4))])
def test_cic_deposit_local_matches_jax(n, block, with_mass):
    r = np.random.default_rng(n + with_mass)
    D = len(block)
    pos = (r.random((n, D)) * np.asarray(block)).astype(np.float32)
    mass = ((r.random(n) + 0.5).astype(np.float32) if with_mass
            else np.ones(n, np.float32))
    valid = r.random(n) > 0.1
    lo = np.zeros(D, np.float32)
    inv_h = np.ones(D, np.float32)
    want = jax.jit(lambda p, m, v: jdep.cic_deposit_local(
        p, m, v, jnp.asarray(lo), jnp.asarray(inv_h), block))(pos, mass, valid)
    got = tdep.cic_deposit_local(_t(pos), _t(mass), _t(valid), _t(lo),
                                 _t(inv_h), block)
    _bits(got, want)
    np.testing.assert_allclose(
        got.numpy(), _oracle(pos.astype(np.float64), mass, valid, block),
        rtol=2e-5, atol=2e-5,
    )


@pytest.mark.parametrize("with_mass", [False, True])
def test_cic_deposit_local_sorted_matches_jax(with_mass):
    r = np.random.default_rng(11 + with_mass)
    n, block = 2000, (4, 4, 4)
    pos = (r.random((n, 3)) * 4).astype(np.float32)
    mass = ((r.random(n) + 0.5).astype(np.float32) if with_mass
            else np.ones(n, np.float32))
    valid = r.random(n) > 0.1
    lo = np.zeros(3, np.float32)
    inv_h = np.ones(3, np.float32)
    want = jax.jit(lambda p, m, v: jdep.cic_deposit_local_sorted(
        p, m, v, jnp.asarray(lo), jnp.asarray(inv_h), block,
        tile=64))(pos, mass, valid)
    got = tdep.cic_deposit_local_sorted(_t(pos), _t(mass), _t(valid),
                                        _t(lo), _t(inv_h), block, tile=64)
    _bits(got, want)


@pytest.mark.parametrize("periodic", [True, (True, False, True)])
@pytest.mark.parametrize("with_mass", [False, True])
@pytest.mark.parametrize("method", ["segment", "scan"])
@pytest.mark.parametrize("vgrid_shape", [(2, 2, 2), (2, 1, 1)])
def test_shard_deposit_vranks_fn_matches_jax(vgrid_shape, method, with_mass,
                                             periodic):
    r = np.random.default_rng(len(vgrid_shape) + with_mass)
    n = 1500
    jgrid, mesh = _one_device_mesh()
    jd = jdomain.Domain(0.0, 1.0, periodic=periodic)
    td = tdomain.Domain(0.0, 1.0, periodic=periodic)
    pos, mass, valid = _vrank_slabs(r, vgrid_shape, n, with_mass)
    shape = (8, 8, 8)
    jfn = jdep.shard_deposit_vranks_fn(
        jd, jgrid, jdomain.ProcessGrid(vgrid_shape), shape, method=method
    )
    axes = jgrid.axis_names
    want = np.asarray(jax.jit(compat.shard_map(
        jfn, mesh=mesh, in_specs=(P(axes), P(axes), P(axes)),
        out_specs=jdep.deposit_out_spec(jd, jgrid),
    ))(pos, mass, valid))
    tfn = tdep.shard_deposit_vranks_fn(
        td, tdomain.ProcessGrid(GRID1), tdomain.ProcessGrid(vgrid_shape),
        shape, method=method,
    )
    got = tfn(_t(pos), _t(mass), _t(valid))
    _bits(got, want)
    np.testing.assert_allclose(
        got.double().sum().item(),
        float(mass.astype(np.float64)[valid].sum()), rtol=1e-5,
    )


def test_shard_deposit_vranks_fn_raises():
    td = tdomain.Domain(0.0, 1.0, periodic=True)
    with pytest.raises(ValueError, match="method"):
        tdep.shard_deposit_vranks_fn(td, tdomain.ProcessGrid(GRID1),
                                     tdomain.ProcessGrid((2, 2, 2)),
                                     (8, 8, 8), method="mxu")
    with pytest.raises(ValueError, match="divisible"):
        tdep.shard_deposit_vranks_fn(td, tdomain.ProcessGrid(GRID1),
                                     tdomain.ProcessGrid((3, 1, 1)),
                                     (8, 8, 8), method="segment")
    with pytest.raises(ValueError, match="torch.distributed"):
        tdep.shard_deposit_vranks_fn(td, tdomain.ProcessGrid((2, 1, 1)),
                                     tdomain.ProcessGrid((1, 1, 1)),
                                     (8, 8, 8))
