"""The migrate loop and the CIC deposit across ranks (one device a process,
gloo on the CPU), held rank for rank against the JAX package on its
8-virtual-device CPU mesh: the flat engine (``vgrid=None``) and the vrank
engine at ``Dev > 1``, with and without the deposit each step, and the
deposit functions themselves (ghost fold across ranks, dense assembly).

Rank ``r``'s state is the reference's shard ``r`` byte for byte; the
stats gathered on every rank are the reference's global stats. Densities
are bit-equal except the ``"mxu"`` engine's, which the reference sorts
unstably (the 2e-5 stated for it on one device). The dense assembly's sum
over ranks in rank order reproduces the reference's ``psum`` bits.

One world of 8 ranks runs every case once a session, smaller grids on
subgroups of its first ranks (``torch_rank_cases.run_migrate``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_rank_cases as cases
from mpi_grid_redistribute_tpu.compat import shard_map
from mpi_grid_redistribute_tpu_torch.convert import (
    split_flat, split_grid, split_lanes, split_rows,
)
from mpi_grid_redistribute_tpu.domain import Domain as JDomain
from mpi_grid_redistribute_tpu.domain import ProcessGrid as JGrid
from mpi_grid_redistribute_tpu.models import nbody as jnbody
from mpi_grid_redistribute_tpu.ops import deposit as jdep
from mpi_grid_redistribute_tpu.parallel import mesh as jmesh
from mpi_grid_redistribute_tpu.parallel import migrate as jmig


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return cases.shared_world(tmp_path_factory, "migrate",
                              "torch_rank_cases:run_migrate", 8)


def _mesh(shape):
    n = int(np.prod(shape))
    return jmesh.make_mesh(JGrid(shape), jax.devices()[:n])


def _ref_loop(name, deposit=None):
    dev_shape, v_shape, n_local, cap, dt, steps, _, extra = (
        cases.MIGRATE_CASES[name])
    kw = dict(extra)
    if deposit is not None:
        kw.update(deposit_method=deposit[0], deposit_shape=deposit[1])
    cfg = jnbody.DriftConfig(
        domain=JDomain(0.0, 1.0, periodic=True), grid=JGrid(dev_shape),
        dt=dt, capacity=cap, n_local=n_local, **kw)
    vgrid = None if v_shape is None else JGrid(v_shape)
    loop = jnbody.make_migrate_loop(cfg, _mesh(dev_shape), steps,
                                    vgrid=vgrid,
                                    deposit_each_step=deposit is not None)
    return jax.tree.map(np.asarray, loop(*cases.migrate_inputs(name)))


def _check_loop(world, key, want, dev_shape, rho_tol=None):
    Dev = int(np.prod(dev_shape))
    w_pos, w_vel, w_alive = (split_flat(a, Dev) for a in want[:3])
    w_rho = None if len(want) < 5 else split_grid(want[4], dev_shape)
    for r in range(Dev):
        (pos, vel, alive), stats, rho = world[r][key]
        assert pos.tobytes() == w_pos[r].tobytes(), r
        assert vel.tobytes() == w_vel[r].tobytes(), r
        np.testing.assert_array_equal(alive, w_alive[r])
        for f in ("sent", "received", "population", "backlog",
                  "dropped_recv", "flow"):
            np.testing.assert_array_equal(
                stats[f], np.asarray(getattr(want[3], f)), err_msg=f)
        if rho is not None:
            block = w_rho[r]
            if rho_tol is None:
                assert rho.tobytes() == block.tobytes(), r
            else:
                np.testing.assert_allclose(rho, block, rtol=rho_tol,
                                           atol=rho_tol)


@pytest.mark.parametrize("name", list(cases.MIGRATE_CASES))
def test_migrate_loop_matches_reference(world, name):
    want = _ref_loop(name)
    dev_shape = cases.MIGRATE_CASES[name][0]
    _check_loop(world, name, want, dev_shape)
    stats = want[3]
    assert stats.dropped_recv.sum() == 0
    assert want[2].sum() == cases.migrate_inputs(name)[2].sum()
    start = cases.MIGRATE_CASES[name][6]
    if start in ("cycle3", "xcycle"):
        # the rotation cycle drains through the (global) cycle rescue
        assert stats.backlog.sum(axis=1)[-1] == 0
    if start == "lossless":
        assert stats.sent.sum() == 4  # only the 4 holes could be granted
    if start == "legal":
        assert stats.backlog.sum() == 0
    # rows crossed devices: the flow leaves each device's diagonal block
    V = want[3].flow.shape[1] // int(np.prod(dev_shape))
    flow = want[3].flow.reshape(want[3].flow.shape[0], -1, V,
                                want[3].flow.shape[2] // V, V)
    cross = flow.sum(axis=(0, 2, 4))
    assert (cross - np.diag(np.diag(cross))).sum() > 0


@pytest.mark.parametrize("key", list(cases.DEPOSIT_LOOP_CASES))
def test_migrate_loop_with_deposit_matches_reference(world, key):
    base, method, shape = cases.DEPOSIT_LOOP_CASES[key]
    want = _ref_loop(base, (method, shape))
    _check_loop(world, key, want, cases.MIGRATE_CASES[base][0],
                rho_tol=2e-5 if method == "mxu" else None)
    np.testing.assert_allclose(want[4].sum(), want[2].sum(), rtol=1e-5)


@pytest.mark.parametrize("name", list(cases.DEPOSIT_CASES))
def test_shard_deposit_matches_reference(world, name):
    """``shard_deposit_fn`` (the flat loop's masked row deposit with a
    count prefix): the ghost fold across ranks on a periodic domain, the
    dense assembly (rank-order sum) on open and mixed ones."""
    shape, periodic, method, ms, n = cases.DEPOSIT_CASES[name]
    R = int(np.prod(shape))
    i = list(cases.DEPOSIT_CASES).index(name)
    pos, mass, count = cases.deposit_inputs(900 + i, R, n, shape)
    dom = JDomain(0.0, 1.0, periodic=periodic)
    want = np.asarray(jdep.build_deposit(_mesh(shape), dom, JGrid(shape), ms,
                                         method=method)(pos, mass, count))
    blocks = split_grid(want, shape)
    for r in range(R):
        got = world[r][("dep", name)]
        if periodic is True:
            assert got.tobytes() == blocks[r].tobytes(), r
        else:
            assert got.tobytes() == want.tobytes(), r


@pytest.mark.parametrize("name", list(cases.DEVICE_DEPOSIT_CASES))
def test_device_deposit_matches_reference(world, name):
    """The loop's per-device deposits across ranks: the device-keyed scan
    and mxu engines (flat and slab-keyed) and the per-vrank block
    deposit."""
    shape, v_shape, periodic, method, ms, n = cases.DEVICE_DEPOSIT_CASES[name]
    Dev = int(np.prod(shape))
    V = 1 if v_shape is None else int(np.prod(v_shape))
    i = list(cases.DEVICE_DEPOSIT_CASES).index(name)
    pos, mass = cases.device_deposit_inputs(950 + i, name)
    valid = mass > 0.05
    dom = JDomain(0.0, 1.0, periodic=periodic)
    grid = JGrid(shape)
    axes = grid.axis_names
    vgrid = None if v_shape is None else JGrid(v_shape)
    if method in ("scan", "mxu"):
        fn = (jdep.shard_deposit_device_mxu_fn(dom, grid, ms, vgrid=vgrid)
              if method == "mxu"
              else jdep.shard_deposit_device_planar_fn(dom, grid, ms))
        want = jax.jit(shard_map(
            fn, mesh=_mesh(shape), in_specs=(P(None, axes), P(axes),
                                             P(axes)),
            out_specs=jdep.deposit_out_spec(dom, grid),
        ))(jnp.asarray(pos.T), jnp.asarray(mass), jnp.asarray(valid))
    else:
        fn = jdep.shard_deposit_vranks_fn(dom, grid, vgrid, ms,
                                          method=method.split("-")[0])
        want = jax.jit(shard_map(
            fn, mesh=_mesh(shape), in_specs=(P(axes), P(axes), P(axes)),
            out_specs=jdep.deposit_out_spec(dom, grid),
        ))(jnp.asarray(pos.reshape(Dev * V, n, 3)),
           jnp.asarray(mass.reshape(Dev * V, n)),
           jnp.asarray(valid.reshape(Dev * V, n)))
    want = np.asarray(want)
    blocks = split_grid(want, shape)
    for r in range(Dev):
        got = world[r][("devdep", name)]
        w = blocks[r] if periodic else want
        if method == "mxu":
            np.testing.assert_allclose(got, w, rtol=2e-5, atol=2e-5)
        else:
            assert got.tobytes() == w.tobytes(), r


@pytest.mark.parametrize("case", cases.STEP_CASES, ids=lambda c: c[0])
def test_migrate_step_matches_reference(world, case):
    """``make_migrate_step`` (the flat engine's per-field wrapper, a fresh
    free stack each call): rank ``r``'s row-major shard of the new state,
    the global stats and the density (the masked row deposit) bit-equal
    to the reference's ``make_migrate_step`` on its mesh."""
    key, dt, dep = case
    pos, vel, alive = cases.migrate_inputs("flat-222")
    _, _, n_local, cap, _, _, _, _ = cases.MIGRATE_CASES["flat-222"]
    kw = {} if dep is None else dict(deposit_method=dep[0],
                                     deposit_shape=dep[1])
    cfg = jnbody.DriftConfig(
        domain=JDomain(0.0, 1.0, periodic=True), grid=JGrid((2, 2, 2)),
        dt=dt, capacity=cap, n_local=n_local, **kw)
    want = jax.tree.map(np.asarray, jnbody.make_migrate_step(
        cfg, _mesh((2, 2, 2)))(pos, vel, alive))
    w_rows = [split_rows(a, 8) for a in want[:3]]
    w_rho = None if dep is None else split_grid(want[4], (2, 2, 2))
    for r in range(8):
        (p, v, a), stats, rho = world[r][("step", key)]
        assert p.tobytes() == w_rows[0][r].tobytes(), r
        assert v.tobytes() == w_rows[1][r].tobytes(), r
        np.testing.assert_array_equal(a, w_rows[2][r])
        for f in ("sent", "received", "population", "backlog",
                  "dropped_recv", "flow"):
            np.testing.assert_array_equal(
                stats[f], np.asarray(getattr(want[3], f)), err_msg=f)
        if dep is not None:
            assert rho.tobytes() == w_rho[r].tobytes(), r
    if dt == 0.0:
        # a legal start with no drift: nothing moves
        assert want[3].sent.sum() == 0
    else:
        assert want[3].sent.sum() > 0


def _ref_flat_split():
    """The reference's flat engine on its 8-device mesh, one step of case
    ``flat-222`` from the drifted rows, run as its two halves
    (``fn.complete(state, fn.issue(state))``) under ``shard_map``."""
    _, _, n_local, cap, dt, _, _, _ = cases.MIGRATE_CASES["flat-222"]
    pos, vel, alive = cases.migrate_inputs("flat-222")
    pos = (pos + vel * np.float32(dt)) % np.float32(1.0)
    grid = JGrid((2, 2, 2))
    fused, _ = jmig.fuse_fields((jnp.asarray(pos), jnp.asarray(vel)),
                                jnp.asarray(alive))
    fn = jmig.shard_migrate_fused_fn(JDomain(0.0, 1.0, periodic=True), grid,
                                     cap)
    axes = grid.axis_names

    def split(f):
        st = jmig.init_state(f)
        st2, stats = fn.complete(st, fn.issue(st))
        return st2.fused, st2.free_stack, st2.n_free[None], stats

    run = shard_map(split, mesh=_mesh((2, 2, 2)), in_specs=(P(None, axes),),
                    out_specs=(P(None, axes), P(axes), P(axes), P(axes)))
    return jax.tree.map(np.asarray, jax.jit(run)(fused))


def test_flat_engine_split_bit_equal_to_whole_and_reference(world):
    """``shard_migrate_fused_fn``'s halves (``fn.issue``/``fn.complete``,
    and through ``exchange.start_exchange``/``finish_exchange``) give
    the whole step's bits on every rank, and the reference's split on
    its 8-device mesh: rank r's state columns, free stack and free
    count, and its stats row."""
    fused, stack, n_free, stats = _ref_flat_split()
    w_fused = split_lanes(fused, 8)
    w_stack = split_rows(stack, 8)
    assert int(stats.sent.sum()) > 0
    for r in range(8):
        whole = world[r][("split", "whole")]
        for how in ("halves", "surface"):
            got = world[r][("split", how)]
            for g, w in zip(got[0], whole[0]):
                assert g.tobytes() == w.tobytes(), (r, how)
            assert got[1].keys() == whole[1].keys()
            for k in got[1]:
                np.testing.assert_array_equal(got[1][k], whole[1][k])
        (f, s, nf), st = whole
        assert f.tobytes() == w_fused[r].tobytes(), r
        assert s.tobytes() == w_stack[r].tobytes(), r
        assert int(nf) == int(n_free[r]), r
        for k, v in st.items():
            np.testing.assert_array_equal(
                v, np.asarray(getattr(stats, k))[r:r + 1], err_msg=k)


def test_pipelined_chunk_degrades_across_ranks_as_the_reference(world):
    """``make_pipelined_chunk_fn`` on a rank mesh of 8 degrades with the
    reference's multi-device reason (its 8-rank grid on 8 devices), and
    the sequential chunk it hands back runs rank for rank as the
    reference's degraded macro on its mesh: each rank's rows, count and
    the gathered per-step stats."""
    from mpi_grid_redistribute_tpu import api as japi
    from mpi_grid_redistribute_tpu.service import pipeline as jpipeline

    grid = JGrid((2, 2, 2))
    jrd = japi.GridRedistribute(grid=grid, lo=(0.0,) * 3, hi=(1.0,) * 3,
                                periodic=(True,) * 3, engine="auto",
                                mesh=_mesh((2, 2, 2)))
    state = cases.service_state((2, 2, 2), 32)
    macro, jcap, jout = jpipeline.make_pipelined_chunk_fn(
        jrd, cases.SERVICE_DT, 4, *(jnp.asarray(a) for a in state[:3]))
    want = jax.tree.map(np.asarray, macro(*(jnp.asarray(a) for a in state)))
    reasons = [e.data["reason"] for e in jrd.telemetry.events(
        "engine_resolved") if e.data["reason"].startswith("pipeline:")]
    assert reasons == ["pipeline: multi-device topology — sequential body"]
    w_rows = [split_rows(a, 8) for a in want[0]]
    for r in range(8):
        got = world[r]["service_degrade"]
        assert got["reasons"] == reasons
        assert got["caps"] == (jcap, jout)
        for g, w in zip(got["state"], w_rows):
            assert g.tobytes() == w[r].tobytes(), r
        np.testing.assert_array_equal(got["count"][:, 0],
                                      want[1]["count"][:, r])
        assert "pipeline" not in got["stats"]
        for k, v in got["stats"].items():
            np.testing.assert_array_equal(
                v, np.asarray(getattr(want[1]["stats"], k)), err_msg=k)
