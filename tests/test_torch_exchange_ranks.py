"""The multi-rank canonical exchange (``parallel.exchange`` shard engines
and ``GridRedistribute(mesh=)``), one rank a process over gloo on the CPU,
held rank for rank against the JAX package's ``shard_map`` engines on its
8-virtual-device CPU mesh: rank ``r``'s output is the reference's shard
``r``, byte for byte, and the stats gathered on every rank are the
reference's global stats.

One world of 8 ranks runs every case once a session
(``torch_rank_cases.run_exchange``); the tests read its results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_rank_cases as cases
from mpi_grid_redistribute_tpu import api as japi
from mpi_grid_redistribute_tpu_torch.convert import (
    join_lanes, split_lanes, split_rows, split_stats,
)
from mpi_grid_redistribute_tpu.domain import Domain as JDomain
from mpi_grid_redistribute_tpu.domain import ProcessGrid as JGrid
from mpi_grid_redistribute_tpu.parallel import exchange as jex
from mpi_grid_redistribute_tpu.parallel import mesh as jmesh

R = 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    results = cases.shared_world(tmp_path_factory, "exchange",
                                 "torch_rank_cases:run_exchange", R)
    return results


def _mesh(shape):
    return jmesh.make_mesh(JGrid(shape), jax.devices()[:R])


def _assert_stats(got, want, names=("send_counts", "recv_counts",
                                    "dropped_send", "dropped_recv",
                                    "needed_capacity")):
    for name in names:
        np.testing.assert_array_equal(got[name], np.asarray(
            getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("engine", ["planar", "sparse", "neighbor"])
@pytest.mark.parametrize("name", list(cases.EXCHANGE_CASES))
def test_shard_engines_match_reference(world, name, engine):
    shape, periodic, B, n, cap, out_cap, drift = cases.EXCHANGE_CASES[name]
    _, _, fused, count = cases.exchange_inputs(name)
    K = fused.shape[1]
    dom = JDomain((0.0,) * 3, (1.0,) * 3, periodic)
    grid = JGrid(shape)
    fused_g = jnp.asarray(np.transpose(fused, (1, 0, 2)).reshape(K, R * n))
    if engine == "planar":
        fn = jex.build_redistribute_planar(_mesh(shape), dom, grid, cap,
                                           out_cap, 3)
    else:
        fn = jex.build_redistribute_count_driven(
            _mesh(shape), dom, grid, cap, out_cap, B, 3, engine=engine)
    out, cnt, st = fn(fused_g, jnp.asarray(count))
    out_r = split_lanes(np.asarray(out), R)
    cnt_r = split_rows(np.asarray(cnt), R)
    for r in range(R):
        got_out, got_cnt, got_st = world[r][(name, engine)]
        assert got_out.tobytes() == out_r[r].tobytes(), r
        np.testing.assert_array_equal(got_cnt, cnt_r[r])
        _assert_stats(got_st, st)
        if engine != "planar":
            np.testing.assert_array_equal(got_st["fallback"],
                                          np.asarray(st.fallback))
    # the ranks' shards join back into the reference's global array
    joined = join_lanes([world[r][(name, engine)][0] for r in range(R)])
    assert joined.tobytes() == np.asarray(out).tobytes()
    if engine == "planar":
        # the per-rank function returns the reference's rows of the stats
        rows = split_stats(jax.tree.map(np.asarray, st), R)
        for r in range(R):
            for f, v in world[r][(name, "planar-rows")].items():
                np.testing.assert_array_equal(v, getattr(rows[r], f),
                                              err_msg=f)
    if engine != "planar":
        fb = np.asarray(st.fallback)
        if drift == 0.45:
            assert fb.all()
        elif drift == 0.0:
            assert not fb.any()


@pytest.mark.parametrize("name", list(cases.EXCHANGE_CASES))
def test_rowmajor_shard_engine_matches_reference(world, name):
    shape, periodic, B, n, cap, out_cap, drift = cases.EXCHANGE_CASES[name]
    _, _, fused, count = cases.exchange_inputs(name)
    dom = JDomain((0.0,) * 3, (1.0,) * 3, periodic)
    pos = np.transpose(fused[:, :3], (0, 2, 1)).reshape(R * n, 3)
    rest = np.transpose(fused[:, 3:], (0, 2, 1)).reshape(R * n, -1)
    tag = np.concatenate([
        (np.arange(n, dtype=np.int16) * (r + 3)).astype(np.int16)
        for r in range(R)])
    fn = jex.build_redistribute(_mesh(shape), dom, JGrid(shape), cap,
                                out_cap, 2)
    res = fn(jnp.asarray(pos), jnp.asarray(count), jnp.asarray(rest),
             jnp.asarray(tag))
    want = [split_rows(np.asarray(a), R) for a in res[:-1]]
    for r in range(R):
        got, got_st = world[r][(name, "rowmajor")]
        for g, w in zip(got, want):
            assert g.tobytes() == w[r].tobytes(), r
        _assert_stats(got_st, res[-1])


API_KW = {
    "auto": (0.02, False, dict()),
    "planar": (0.02, False, dict(engine="planar")),
    "neighbor": (0.02, False, dict(engine="neighbor")),
    "grow": (0.0, True, dict(capacity_factor=1.0)),
    "sparse-fallback": (0.45, False, dict(
        engine="sparse", mover_cap=1, capacity=96, out_capacity=256,
        on_overflow="ignore")),
    "sparse-ratchet": (0.05, False, dict(
        engine="sparse", mover_cap=1, capacity=96, out_capacity=256)),
}


@pytest.mark.parametrize("key", list(API_KW))
def test_grid_redistribute_mesh_matches_reference(world, key):
    """``GridRedistribute(mesh=)`` against the reference's instance on its
    8-device mesh: the same engine resolution (``"auto"`` is the sparse
    engine across devices), the same grown capacities and mover block,
    and rank ``r``'s shard of every output."""
    drift, clustered, kw = API_KW[key]
    n = 96
    pos, vel, ids, _ = cases.rows_inputs(R, n, drift, 5, clustered)
    rd = japi.GridRedistribute(
        grid=(2, 2, 2), lo=(0.0,) * 3, hi=(1.0,) * 3, periodic=(True,) * 3,
        mesh=_mesh((2, 2, 2)), **kw)
    res = rd.redistribute(pos, vel, ids)
    w_pos = split_rows(np.asarray(res.positions), R)
    w_fields = [split_rows(np.asarray(f), R) for f in res.fields]
    w_cnt = split_rows(np.asarray(res.count), R)
    for r in range(R):
        g_pos, g_fields, g_cnt, g_st, g_rd = world[r][("api", key)]
        assert g_pos.tobytes() == w_pos[r].tobytes()
        for g, w in zip(g_fields, w_fields):
            assert g.tobytes() == w[r].tobytes()
        np.testing.assert_array_equal(g_cnt, w_cnt[r])
        _assert_stats(g_st, res.stats)
        assert g_rd["capacity"] == rd.capacity
        assert g_rd["out_capacity"] == rd.out_capacity
        assert g_rd["mover_cap"] == rd._mover_cap
        assert g_rd["engine"] == rd._last_wire["engine"]
        # the same attempts: each a blocking read of the gathered stats
        assert g_rd["fetches"] == rd._blocking_fetches
    if key == "grow":
        # the clustered start overflowed, and every rank rebuilt at the
        # same grown capacities before the clean attempt
        assert rd._blocking_fetches >= 2
        assert rd.capacity is not None or rd.out_capacity is not None
    if key == "sparse-fallback":
        assert np.asarray(res.stats.fallback).all()
    if key == "sparse-ratchet":
        assert rd._mover_cap > 1


def test_grid_redistribute_mesh_rowmajor_for_narrow_fields(world):
    """An int16 field is not planar-eligible: ``"auto"`` takes the
    row-major engine, and the clipped output grows ``out_capacity`` on
    every rank together."""
    pos, _, _, tag = cases.rows_inputs(R, 96, 0.02, 6)
    rd = japi.GridRedistribute(
        grid=(2, 2, 2), lo=(0.0,) * 3, hi=(1.0,) * 3, periodic=(True,) * 3,
        mesh=_mesh((2, 2, 2)))
    res = rd.redistribute(pos, tag)
    assert rd._last_wire["engine"] == "rowmajor"
    out_cap = rd.out_capacity
    assert out_cap > 96
    w_pos = split_rows(np.asarray(res.positions), R)
    w_tag = split_rows(np.asarray(res.fields[0]), R)
    for r in range(R):
        g_pos, g_fields, g_cnt, g_st, g_rd = world[r][("api", "rowmajor")]
        assert g_rd == dict(out_capacity=out_cap, engine="rowmajor")
        assert g_pos.tobytes() == w_pos[r].tobytes()
        assert g_fields[0].tobytes() == w_tag[r].tobytes()
        assert g_fields[0].dtype == np.int16
        _assert_stats(g_st, res.stats)


# ---- the count-driven vrank twins (one device, no world) ----------------

import torch  # noqa: E402

from mpi_grid_redistribute_tpu_torch import api as tapi  # noqa: E402
from mpi_grid_redistribute_tpu_torch.domain import Domain as TDomain  # noqa
from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid as TGrid  # noqa
from mpi_grid_redistribute_tpu_torch.parallel import exchange as tex  # noqa


@pytest.mark.parametrize("engine", ["sparse", "neighbor"])
@pytest.mark.parametrize("name", list(cases.EXCHANGE_CASES))
def test_count_driven_vrank_twins_match_reference(name, engine):
    """The single-device twins of the count-driven engines: bit-equal to
    the reference's twins (and so to its planar vrank engine), with the
    same ``fallback`` verdict."""
    shape, periodic, B, n, cap, out_cap, drift = cases.EXCHANGE_CASES[name]
    _, _, fused, count = cases.exchange_inputs(name)
    jfn = jex.build_redistribute_count_driven_vranks(
        JDomain((0.0,) * 3, (1.0,) * 3, periodic), JGrid(shape), cap,
        out_cap, B, 3, engine=engine)
    want = jfn(jnp.asarray(fused), jnp.asarray(count))
    got = tex.build_redistribute_count_driven_vranks(
        TDomain((0.0,) * 3, (1.0,) * 3, periodic), TGrid(shape), cap,
        out_cap, B, 3, engine=engine)(torch.from_numpy(fused),
                                      torch.from_numpy(count))
    assert got[0].numpy().tobytes() == np.asarray(want[0]).tobytes()
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for f in ("send_counts", "recv_counts", "dropped_send", "dropped_recv",
              "needed_capacity", "fallback"):
        np.testing.assert_array_equal(getattr(got[2], f).numpy(),
                                      np.asarray(getattr(want[2], f)),
                                      err_msg=f)


def test_api_vranks_auto_planar_explicit_sparse():
    """On one device ``"auto"`` keeps the planar engine (no wire to
    shrink) and explicit ``"sparse"``/``"neighbor"`` run the count-driven
    twins, byte-equal to the reference's instance (27 vranks)."""
    n = 40
    rng = np.random.default_rng(3)
    pos = rng.random((27 * n, 3)).astype(np.float32)
    ids = np.arange(27 * n, dtype=np.int32)
    for engine, resolved in (("auto", "planar"), ("sparse", "sparse"),
                             ("neighbor", "neighbor")):
        kw = dict(grid=(3, 3, 3), lo=(0.0,) * 3, hi=(1.0,) * 3,
                  periodic=(True,) * 3, engine=engine, capacity=16)
        jrd = japi.GridRedistribute(**kw)
        want = jrd.redistribute(pos, ids)
        trd = tapi.GridRedistribute(device="cpu", **kw)
        got = trd.redistribute(pos, ids)
        assert trd._last_wire["engine"] == resolved == jrd._last_wire["engine"]
        assert got.positions.numpy().tobytes() == np.asarray(
            want.positions).tobytes()
        assert got.fields[0].numpy().tobytes() == np.asarray(
            want.fields[0]).tobytes()
        assert trd._mover_cap == jrd._mover_cap


def test_functional_redistribute_and_reshard_with_mesh(world):
    """``redistribute(..., mesh=)`` and ``reshard(..., mesh=)`` (every rank
    passing the same live rows) against the reference's on its mesh, and
    ``engine_fn`` handing out the engine a call runs."""
    n = 96
    pos, vel, ids, _ = cases.rows_inputs(R, n, 0.02, 7)
    dom = JDomain(0.0, 1.0, periodic=True)
    want = japi.redistribute(pos, vel, ids, domain=dom, grid=(2, 2, 2),
                             mesh=_mesh((2, 2, 2)))
    live = pos[: 8 * n - 37]
    want_rs = japi.reshard(live, ids[: 8 * n - 37], domain=dom,
                           grid=(2, 2, 2), n_local=n + 32, backend="jax",
                           mesh=_mesh((2, 2, 2)))
    jrd = japi.GridRedistribute(grid=(2, 2, 2), lo=0.0, hi=1.0,
                                periodic=True, mesh=_mesh((2, 2, 2)))
    e_ref = jrd.engine_fn(jnp.asarray(pos), jnp.asarray(vel))
    e_out = jax.tree.map(np.asarray, e_ref[0](
        jnp.asarray(pos), jnp.full((R,), n, jnp.int32), jnp.asarray(vel)))
    w_fn = [split_rows(np.asarray(a), R) for a in (want.positions,
                                                    want.count)]
    w_rs = [split_rows(np.asarray(a), R) for a in (
        want_rs.positions, want_rs.fields[0], want_rs.count)]
    e_pos_r = split_rows(e_out[0], R)
    e_cnt_r = split_rows(e_out[1], R)
    for r in range(R):
        g_pos, g_cnt, g_st = world[r][("api", "functional")]
        assert g_pos.tobytes() == w_fn[0][r].tobytes()
        np.testing.assert_array_equal(g_cnt, w_fn[1][r])
        _assert_stats(g_st, want.stats)
        p, f, c, st = world[r][("api", "reshard")]
        assert p.tobytes() == w_rs[0][r].tobytes()
        assert f.tobytes() == w_rs[1][r].tobytes()
        np.testing.assert_array_equal(c, w_rs[2][r])
        _assert_stats(st, want_rs.stats)
        # engine_fn at the instance's first capacities (no growth: an
        # overflow there is the caller's to read), as the reference's
        e_pos, e_cnt, cap, out_cap, engine = world[r][("api", "engine_fn")]
        assert (engine, cap, out_cap) == ("sparse", e_ref[1], e_ref[2])
        assert e_pos.tobytes() == e_pos_r[r].tobytes()
        np.testing.assert_array_equal(e_cnt, e_cnt_r[r])
