"""The hierarchical two-level exchange (``parallel.exchange``'s
hierarchical engines, ``parallel.mesh.HierarchicalMesh`` and
``GridRedistribute(dcn_shape=, cross_cap=)``), held against the JAX
package: across ranks (one world of 8 gloo processes on the CPU,
``torch_rank_cases.run_hier``) rank ``r``'s output is the reference's
shard ``r`` on its 8-virtual-device mesh, byte for byte, and the
gathered stats are its global stats; on one device the vrank engine is
byte-equal to the reference's vrank engine. On every step that clips no
cross-pod row, both are also byte-equal to the port's planar engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_cases as cases
from mpi_grid_redistribute_tpu import api as japi
from mpi_grid_redistribute_tpu.domain import Domain as JDomain
from mpi_grid_redistribute_tpu.domain import ProcessGrid as JGrid
from mpi_grid_redistribute_tpu.parallel import exchange as jex
from mpi_grid_redistribute_tpu.parallel import mesh as jmesh
from mpi_grid_redistribute_tpu_torch import api as tapi
from mpi_grid_redistribute_tpu_torch.convert import split_lanes, split_rows
from mpi_grid_redistribute_tpu_torch.domain import Domain as TDomain
from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid as TGrid
from mpi_grid_redistribute_tpu_torch.parallel import exchange as tex
from mpi_grid_redistribute_tpu_torch.parallel import mesh as tmesh

R = 8
STATS = ("send_counts", "recv_counts", "dropped_send", "dropped_recv",
         "needed_capacity")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return cases.shared_world(tmp_path_factory, "hier",
                              "torch_rank_cases:run_hier", R)


def _assert_stats(got, want, names=STATS):
    for name in names:
        np.testing.assert_array_equal(got[name], np.asarray(
            getattr(want, name)), err_msg=name)


# ------------------------------------------------------------ the tables

TABLE_CASES = [
    ((2, 2, 2), (2, 1, 1)), ((2, 2, 2), (1, 2, 2)), ((2, 2, 4), (1, 1, 2)),
    ((3, 3, 3), (3, 1, 1)), ((2, 2, 2), (2, 2, 2)), ((2, 2, 2), None),
    ((2, 2, 2), (1, 1, 1)), ((4, 2, 1), (2, 1, 1)),
]


@pytest.mark.parametrize("shape,dcn", TABLE_CASES)
def test_hierarchical_mesh_tables_match_reference(shape, dcn):
    """``pod_of``, ``local_of``, ``rank_table``, the pod grid and the
    pod sizes equal the reference's for every ``dcn_shape`` its tests
    use; the groups are the pods' ranks and each slot's ranks."""
    want = jmesh.HierarchicalMesh(JGrid(shape), dcn)
    got = tmesh.HierarchicalMesh(TGrid(shape), dcn)
    for name in ("pod_of", "local_of", "rank_table"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    for name in ("dcn_shape", "ici_shape", "n_pods", "pod_size"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.local_grid.shape == want.local_grid.shape
    for periodic in ((True,) * 3, (False, True, True), (True, False, True)):
        assert got.local_periodic(periodic) == want.local_periodic(periodic)
    # ici/dcn groups: the pods' ranks and each pod-local slot's ranks
    assert got.ici_groups() == tuple(map(tuple, want.rank_table.tolist()))
    assert got.dcn_groups() == tuple(map(tuple, want.rank_table.T.tolist()))
    for r in range(got.grid.nranks):
        assert got.ici_group(r) == got.ici_groups()[got.pod_of[r]]
    assert got == tmesh.HierarchicalMesh(TGrid(shape), dcn)
    assert hash(got) == hash(tmesh.HierarchicalMesh(TGrid(shape), dcn))


def test_dcn_shape_validation_matches_reference():
    grid_j, grid_t = JGrid((2, 2, 2)), TGrid((2, 2, 2))
    for bad in ((3, 1, 1), (2, 1), (0, 1, 1)):
        with pytest.raises(ValueError) as want:
            jmesh.HierarchicalMesh(grid_j, bad)
        with pytest.raises(ValueError) as got:
            tmesh.HierarchicalMesh(grid_t, bad)
        assert str(got.value) == str(want.value)
        # make_hybrid_mesh validates before it needs a process group
        with pytest.raises(ValueError, match=str(want.value)[:12]):
            tmesh.make_hybrid_mesh(grid_t, bad)
    # a one-rank grid needs no process group
    m = tmesh.make_hybrid_mesh(TGrid((1, 1, 1)), (1, 1, 1))
    assert (m.size, m.rank, m.group) == (1, 0, None)


# ------------------------------------------------- the engine across ranks


def _ref_case(name):
    shape, dcn, periodic, n, cap, oc, B, B2, _ = cases.HIER_CASES[name]
    fused, count = cases.hier_inputs(name)
    K = fused.shape[1]
    grid = JGrid(shape)
    dom = JDomain((0.0,) * 3, (1.0,) * 3, periodic)
    hier = jmesh.HierarchicalMesh(grid, dcn)
    fused_g = jnp.asarray(np.transpose(fused, (1, 0, 2)).reshape(K, R * n))
    emesh = hier.build_mesh(list(jax.devices()[:R]))
    f = jex.shard_redistribute_hierarchical_sharded(
        emesh, dom, grid, hier, cap, oc, B, B2, 3)
    out, cnt, st = jax.jit(f)(fused_g, jnp.asarray(count))
    planar = jex.build_redistribute_planar(
        jmesh.make_mesh(grid, jax.devices()[:R]), dom, grid, cap, oc, 3)(
            fused_g, jnp.asarray(count))
    return out, cnt, st, planar


@pytest.mark.parametrize("name", list(cases.HIER_CASES))
def test_shard_engine_matches_reference(world, name):
    """Rank ``r`` of the port's hierarchical engine is the reference's
    shard ``r``, byte for byte, with its global stats (``fallback`` and
    ``needed_cross`` included); where nothing is clipped, both are the
    planar engine's bytes (the port's planar ranks and the reference's
    planar shards)."""
    out, cnt, st, (p_out, p_cnt, p_st) = _ref_case(name)
    out_r = split_lanes(np.asarray(out), R)
    cnt_r = split_rows(np.asarray(cnt), R)
    clipped = int(np.asarray(st.dropped_send).sum()) > 0
    for r in range(R):
        g_out, g_cnt, g_st, _ = world[r][(name, "hier")]
        assert g_out.tobytes() == out_r[r].tobytes(), r
        np.testing.assert_array_equal(g_cnt, cnt_r[r])
        _assert_stats(g_st, st, STATS + ("fallback", "needed_cross"))
        if not clipped:
            pl_out, pl_cnt, _ = world[r][(name, "planar")]
            assert g_out.tobytes() == pl_out.tobytes(), r
            assert g_out.tobytes() == split_lanes(
                np.asarray(p_out), R)[r].tobytes()
            np.testing.assert_array_equal(g_cnt, pl_cnt)
            _assert_stats(g_st, p_st)
    fb, dropped = np.asarray(st.fallback), np.asarray(st.dropped_send)
    if name == "fallback":
        assert fb.all()  # the dense intra-pod pool ran
    else:
        assert not fb.any()
    if name == "clip":
        # the cross block clipped rows, and needed_cross says how many
        assert dropped.sum() > 0
        assert int(np.asarray(st.needed_cross).max()) > 2
    elif name != "fallback":
        assert dropped.sum() == 0


def test_cross_stage_has_no_dense_all_to_all(world):
    """Every ``torch.distributed`` call that sends a rank's data into
    another pod is a point-to-point hop of at most one condensed ``[K,
    cross_cap]`` block (exactly ``n_pods - 1`` hops carry one) or carries
    counts (at most ``R`` elements a rank); the payload all-to-alls stay
    inside the pod. Read off the split sizes each call was given
    (``torch_rank_cases.wire_recording``)."""
    shape, dcn, _, _, _, _, _, B2, _ = cases.HIER_CASES["2pods-122"]
    hier = tmesh.HierarchicalMesh(TGrid(shape), dcn)
    K = 7
    for r in range(R):
        wires = world[r][("2pods-122", "hier")][3]
        home = int(hier.pod_of[r])
        blocks = 0
        for w in wires:
            out = {d: n for d, n in w.sent.items()
                   if int(hier.pod_of[d]) != home}
            if not out:
                continue
            if w.op == "all_to_all_single" and set(w.sent) - {r} == set(out) \
                    and len(out) == 1:  # a point-to-point hop
                (n,) = out.values()
                assert n <= K * B2, w
                blocks += n == K * B2
            else:
                assert max(out.values()) <= R, w
        assert blocks == hier.n_pods - 1, r
        # the payload all-to-alls: the caller's pod only
        pod = set(hier.ici_group(r))
        wide = [w for w in wires if w.op == "all_to_all_single"
                and len(w.sent) > 1 and max(w.sent.values()) > R]
        assert wide and all(set(w.sent) <= pod for w in wide)


@pytest.mark.parametrize("dcn", [(2, 1, 1), (1, 2, 2)])
def test_subaxis_collectives_are_one_world_call(world, dcn):
    """``all_to_all(..., group=)`` over a pod and ``ppermute`` of a
    ``lift_perm``-ed pod shift give what ``lax.all_to_all`` over the ici
    axes and ``lax.ppermute`` over the dcn axes give (modelled here with
    NumPy), and exchange data only with the ranks of the group."""
    hier = tmesh.HierarchicalMesh(TGrid((2, 2, 2)), dcn)
    L, P = hier.pod_size, hier.n_pods
    x = [np.arange(L * 3, dtype=np.int32) + 100 * r for r in range(R)]
    for r in range(R):
        a2a, pp, wires = world[r][("subaxis", dcn)]
        group = hier.ici_group(r)
        want = np.concatenate([x[g][3 * group.index(r):3 * group.index(r)
                                    + 3] for g in group])
        np.testing.assert_array_equal(a2a, want)
        p, l = int(hier.pod_of[r]), int(hier.local_of[r])
        src = int(hier.rank_table[(p - 1) % P, l])
        assert pp.dtype == np.int16
        np.testing.assert_array_equal(pp, x[src].astype(np.int16))
        dst = int(hier.rank_table[(p + 1) % P, l])
        # two world calls; the int16 ppermute travels as its bytes
        assert [w.op for w in wires] == ["all_to_all_single"] * 2
        assert wires[0].sent == wires[0].recv == {g: 3 for g in group}
        assert wires[1].sent == {dst: 2 * L * 3}
        assert wires[1].recv == {src: 2 * L * 3}


# ------------------------------------------------- the engine on one device

VRANK_CASES = {
    "16vr-cubic-pod": ((2, 2, 4), (1, 1, 2), 48, 32, 128, 8, 8, 0.01),
    "27vr-133-pod": ((3, 3, 3), (3, 1, 1), 48, 32, 128, 8, 8, 0.01),
    "2pods-122": ((2, 2, 2), (2, 1, 1), 120, 60, 300, 16, 16, 0.01),
    "4pods-211": ((2, 2, 2), (1, 2, 2), 120, 60, 300, 16, 16, 0.01),
    "clip": ((2, 2, 2), (2, 1, 1), 120, 60, 300, 16, 2, 0.05),
    "fallback": ((2, 2, 2), (2, 1, 1), 120, 60, 300, 2, 64, 0.3),
    "8pods": ((2, 2, 2), (2, 2, 2), 120, 60, 300, 16, 32, 0.05),
}


def _vrank_inputs(shape, n, drift, seed, K=7):
    rng = np.random.default_rng(seed)
    grid = TGrid(shape)
    Rv = grid.nranks
    pos = np.empty((Rv, 3, n), np.float32)
    for r in range(Rv):
        cell = grid.cell_of_rank(r)
        for a in range(3):
            pos[r, a] = (cell[a] + rng.random(n)) / shape[a]
    pos = np.mod(pos + rng.normal(0, drift, pos.shape), 1.0).astype(
        np.float32)
    other = rng.standard_normal((Rv, K - 3, n)).astype(np.float32)
    count = rng.integers(n // 2, n + 1, size=Rv).astype(np.int32)
    return np.concatenate([pos, other], axis=1), count


@pytest.mark.parametrize("name", list(VRANK_CASES))
def test_vrank_engine_matches_reference(name):
    """The one-device engine (the wire as static gathers) against the
    reference's vrank engine: output, counts and every stat byte-equal;
    byte-equal to the port's planar vrank engine wherever nothing is
    clipped."""
    shape, dcn, n, cap, oc, B, B2, drift = VRANK_CASES[name]
    fused, count = _vrank_inputs(shape, n, drift,
                                 list(VRANK_CASES).index(name) + 40)
    dom_j = JDomain((0.0,) * 3, (1.0,) * 3, (True,) * 3)
    dom_t = TDomain((0.0,) * 3, (1.0,) * 3, (True,) * 3)
    jf = jax.jit(jex.vrank_redistribute_hierarchical_fn(
        dom_j, JGrid(shape), jmesh.HierarchicalMesh(JGrid(shape), dcn), cap,
        oc, B, B2, 3))
    w_out, w_cnt, w_st = jf(jnp.asarray(fused), jnp.asarray(count))
    grid = TGrid(shape)
    tf = tex.build_redistribute_hierarchical_vranks(
        dom_t, grid, tmesh.HierarchicalMesh(grid, dcn), cap, oc, B, B2, 3)
    out, cnt, st = tf(torch.from_numpy(fused), torch.from_numpy(count))
    assert out.numpy().tobytes() == np.asarray(w_out).tobytes()
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(w_cnt))
    for f in STATS + ("fallback", "needed_cross"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(w_st, f)),
                                      err_msg=f)
    if not st.dropped_send.any():
        p_out, p_cnt, _ = tex.vrank_redistribute_planar_fn(
            dom_t, grid, cap, oc, 3)(torch.from_numpy(fused),
                                     torch.from_numpy(count))
        assert out.numpy().tobytes() == p_out.numpy().tobytes()
        np.testing.assert_array_equal(cnt.numpy(), p_cnt.numpy())
    assert bool(st.fallback.all()) == (name == "fallback")


def test_engine_refuses_a_flat_mesh_and_a_foreign_grid():
    dom = TDomain((0.0,) * 3, (1.0,) * 3, (True,) * 3)
    grid = TGrid((2, 2, 2))
    with pytest.raises(ValueError, match="multi-pod"):
        tex.vrank_redistribute_hierarchical_fn(
            dom, grid, tmesh.HierarchicalMesh(grid, (1, 1, 1)), 64, 64, 8, 8)
    with pytest.raises(ValueError, match="wraps grid"):
        tex.vrank_redistribute_hierarchical_fn(
            dom, grid, tmesh.HierarchicalMesh(TGrid((2, 2, 4)), (1, 1, 2)),
            64, 64, 8, 8)
    with pytest.raises(ValueError, match="cross_cap"):
        tex.vrank_redistribute_hierarchical_fn(
            dom, grid, tmesh.HierarchicalMesh(grid, (2, 1, 1)), 64, 64, 8, 0)


# ------------------------------------------------------------------ API


def _ref_api(key):
    engine, dcn, drift, kw = cases.HIER_API_CASES[key]
    pos, _, ids, _ = cases.rows_inputs(R, 96, drift, 9)
    rd = japi.GridRedistribute(
        grid=(2, 2, 2), lo=(0.0,) * 3, hi=(1.0,) * 3, periodic=(True,) * 3,
        mesh=jmesh.make_mesh(JGrid((2, 2, 2)), jax.devices()[:R]),
        engine=engine, dcn_shape=dcn, **kw)
    return rd, rd.redistribute(pos, ids)


def _assert_api_rank(world, key, rd, res):
    w_pos = split_rows(np.asarray(res.positions), R)
    w_ids = split_rows(np.asarray(res.fields[0]), R)
    w_cnt = split_rows(np.asarray(res.count), R)
    for r in range(R):
        g_pos, g_ids, g_cnt, g_st, g_rd = world[r][("api", key)]
        assert g_pos.tobytes() == w_pos[r].tobytes(), r
        assert g_ids.tobytes() == w_ids[r].tobytes(), r
        np.testing.assert_array_equal(g_cnt, w_cnt[r])
        _assert_stats(g_st, res.stats)
        assert g_rd["engine"] == rd._last_wire["engine"]
        assert g_rd["n_pods"] == rd.n_pods
        assert g_rd["cross_cap"] == rd._cross_cap
        assert g_rd["mover_cap"] == rd._mover_cap
        assert g_rd["capacity"] == rd.capacity
        assert g_rd["fetches"] == rd._blocking_fetches


@pytest.mark.parametrize("key", ["explicit", "auto", "flat-none",
                                 "flat-ones"])
def test_api_mesh_matches_reference(world, key):
    """``GridRedistribute(mesh=, dcn_shape=)``: the reference's engine
    resolution (explicit and ``"auto"`` on several pods take the
    hierarchical engine, a one-pod grid degrades to sparse), its
    ``n_pods``, and rank ``r``'s shard of every output; each rank's valid
    rows are the planar engine's."""
    rd, res = _ref_api(key)
    _assert_api_rank(world, key, rd, res)
    want = {"explicit": "hierarchical", "auto": "hierarchical",
            "flat-none": "sparse", "flat-ones": "sparse"}[key]
    assert world[0][("api", key)][4]["engine"] == want
    assert world[0][("api", key)][4]["n_pods"] == (
        1 if key.startswith("flat") else 2 if key == "explicit" else 4)
    for r in range(R):
        g_pos, _, g_cnt, _, _ = world[r][("api", key)]
        p_pos, _, p_cnt, _, _ = world[r][("api", "planar")]
        assert g_pos.tobytes() == p_pos.tobytes()
        np.testing.assert_array_equal(g_cnt, p_cnt)


def test_api_cross_cap_ratchets_from_measured_need(world):
    """``cross_cap=1`` with real cross-pod movers: the call clips, every
    rank reads the same gathered ``needed_cross``, grows the block and
    re-runs the call, and the healed result is the planar engine's (and
    the reference's, which grows to the same block)."""
    rd, res = _ref_api("ratchet")
    _assert_api_rank(world, "ratchet", rd, res)
    assert rd._cross_cap > 1
    for r in range(R):
        g_pos, _, g_cnt, g_st, g_rd = world[r][("api", "ratchet")]
        p_pos, _, p_cnt, _, _ = world[r][("api", "ratchet-planar")]
        c = int(g_cnt[0])
        assert int(p_cnt[0]) == c
        assert g_pos[:c].tobytes() == p_pos[:c].tobytes()
        assert g_rd["cross_cap"] > 1 and g_rd["fetches"] >= 2
        assert int(g_st["dropped_send"].sum()) == 0


def test_api_vranks_bitexact_and_ratchets():
    """On one device (16 vranks, two pods of 8): byte-equal to the
    reference's instance and to the port's planar one; ``cross_cap=1``
    ratchets and re-runs to the same bytes."""
    pos, _, ids, _ = cases.rows_inputs(16, 40, 0.01, 12)
    kw = dict(grid=(2, 2, 4), lo=(0.0,) * 3, hi=(1.0,) * 3,
              periodic=(True,) * 3, capacity=40, out_capacity=120)
    # 16 ranks on 8 devices: the reference runs its vrank engine
    want = japi.GridRedistribute(engine="hierarchical", dcn_shape=(1, 1, 2),
                                 **kw)
    rd_h = tapi.GridRedistribute(engine="hierarchical", dcn_shape=(1, 1, 2),
                                 device="cpu", **kw)
    rd_p = tapi.GridRedistribute(engine="planar", device="cpu", **kw)
    jd = japi.GridRedistribute(engine="planar", backend="numpy", **kw)
    res_h = rd_h.redistribute(pos, ids)
    res_p = rd_p.redistribute(pos, ids)
    res_j = jd.redistribute(pos, ids)
    res_w = want.redistribute(pos, ids)
    assert want._vranks and want._last_wire["engine"] == "hierarchical"
    assert res_h.positions.numpy().tobytes() == np.asarray(
        res_w.positions).tobytes()
    assert rd_h._last_engine == "hierarchical" and rd_h.n_pods == 2
    assert res_h.positions.numpy().tobytes() == (
        res_p.positions.numpy().tobytes())
    assert res_h.positions.numpy().tobytes() == np.asarray(
        res_j.positions).tobytes()
    assert res_h.fields[0].numpy().tobytes() == np.asarray(
        res_j.fields[0]).tobytes()
    # the cross block grows from the measured need and the call re-runs
    pos, _, ids, _ = cases.rows_inputs(16, 40, 0.05, 13)
    rd_c = tapi.GridRedistribute(engine="hierarchical", dcn_shape=(1, 1, 2),
                                 cross_cap=1, device="cpu", **kw)
    res_c = rd_c.redistribute(pos, ids)
    res_p = rd_p.redistribute(pos, ids)
    assert rd_c._cross_cap > 1 and rd_c._blocking_fetches == 2
    assert res_c.positions.numpy().tobytes() == (
        res_p.positions.numpy().tobytes())
    assert int(res_c.stats.dropped_send.sum()) == 0
    # "auto" on one device stays planar; a grown block at the capacity
    # degrades the hierarchical engine to planar too
    rd_a = tapi.GridRedistribute(dcn_shape=(1, 1, 2), device="cpu", **kw)
    rd_a.redistribute(pos, ids)
    assert rd_a._last_engine == "planar"
    rd_m = tapi.GridRedistribute(engine="hierarchical", dcn_shape=(1, 1, 2),
                                 mover_cap=64, device="cpu", **kw)
    rd_m.redistribute(pos, ids)
    assert rd_m._last_engine == "planar"


def test_api_hierarchical_validation():
    kw = dict(grid=(2, 2, 2), lo=0.0, hi=1.0, periodic=True, device="cpu")
    with pytest.raises(ValueError, match="cross_cap"):
        tapi.GridRedistribute(cross_cap=0, **kw)
    with pytest.raises(ValueError, match="divisible"):
        tapi.GridRedistribute(dcn_shape=(3, 1, 1), **kw)
    rd = tapi.GridRedistribute(engine="hierarchical", dcn_shape=(2, 1, 1),
                               **kw)
    with pytest.raises(TypeError, match="32-bit"):
        rd.redistribute(np.zeros((16, 3), np.float32),
                        np.zeros(16, np.int16))


def test_ranks_import_no_jax(world):
    for r in range(R):
        assert world[r][("imports",)] == []
