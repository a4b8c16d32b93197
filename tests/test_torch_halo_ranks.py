"""The halo exchange across ranks (``parallel.halo``'s multi-rank engines
and ``GridRedistribute(mesh=).halo()``), one rank a process over gloo on
the CPU, held rank for rank against the JAX package's ``shard_map``
engines on its 8-virtual-device CPU mesh: rank ``r``'s ghosts are the
reference's shard ``r``, byte for byte (positions, fields, their order),
and the ghost counts and overflow gathered on every rank are its global
``[R]`` counters. The ghost sets also equal the set-level oracle
(``oracle.brute_force_ghosts``) and the port's one-device vrank engines.

One world of 8 ranks runs every case once a session
(``torch_rank_cases.run_halo``); the tests read its results.
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
from mpi_grid_redistribute_tpu.parallel import halo as jhalo
from mpi_grid_redistribute_tpu.parallel import mesh as jmesh
from mpi_grid_redistribute_tpu_torch import oracle as toracle
from mpi_grid_redistribute_tpu_torch.convert import split_lanes, split_rows
from mpi_grid_redistribute_tpu_torch.domain import Domain as TDomain
from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid as TGrid
from mpi_grid_redistribute_tpu_torch.parallel import halo as thalo

W = 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return cases.shared_world(tmp_path_factory, "halo",
                              "torch_rank_cases:run_halo", W)


def _mesh(shape):
    return jmesh.make_mesh(JGrid(shape), jax.devices()[:int(np.prod(shape))])


def _case(name):
    shape, periodic, w, n, H, G, lo, hi = cases.HALO_CASES[name]
    R = int(np.prod(shape))
    dom = JDomain(lo, hi, periodic=periodic)
    pos, count, ids = cases.halo_inputs(name)
    return shape, R, dom, w, n, H, G, pos, count, ids


@pytest.mark.parametrize("name", list(cases.HALO_CASES))
def test_rowmajor_engine_matches_reference(world, name):
    """``build_halo_exchange`` on each rank against the reference's on its
    mesh (an id field riding along): ghost positions and ids byte-equal,
    in order, and the gathered ``ghost_count``/``overflow``."""
    shape, R, dom, w, n, H, G, pos, count, ids = _case(name)
    res = jhalo.build_halo_exchange(_mesh(shape), dom, JGrid(shape), w, H, G,
                                    n_fields=1)(pos, count, ids)
    w_pos = split_rows(np.asarray(res.ghost_positions), R)
    w_ids = split_rows(np.asarray(res.ghost_fields[0]), R)
    for r in range(R):
        g_pos, g_cnt, g_ids, g_ov = world[r][(name, "rowmajor")]
        assert g_pos.tobytes() == w_pos[r].tobytes(), r
        assert g_ids.tobytes() == w_ids[r].tobytes(), r
        np.testing.assert_array_equal(g_cnt, np.asarray(res.ghost_count))
        np.testing.assert_array_equal(g_ov, np.asarray(res.overflow))
    overflow = int(np.asarray(res.overflow).sum())
    assert (overflow > 0) == (name in ("overflow", "two-sort-tight"))


@pytest.mark.parametrize("name", list(cases.HALO_CASES))
def test_planar_engine_matches_reference(world, name):
    """``build_halo_planar`` on each rank (``[4, n]``: the positions and a
    bitcast id row) against the reference's lane-sharded twin; the
    per-rank function returns the reference's own rows of the counters."""
    shape, R, dom, w, n, H, G, pos, count, ids = _case(name)
    if H is None:
        H, G = jhalo.default_capacities(dom, JGrid(shape), w, n)
    fused = np.concatenate([pos.T, ids.view(np.float32)[None]])
    ghost, gcount, overflow = jhalo.build_halo_planar(
        _mesh(shape), dom, JGrid(shape), (w,) * 3, H, G)(
            jnp.asarray(fused), jnp.asarray(count))
    w_ghost = split_lanes(np.asarray(ghost), R)
    for r in range(R):
        g_ghost, g_cnt, g_ov = world[r][(name, "planar")]
        assert g_ghost.tobytes() == w_ghost[r].tobytes(), r
        np.testing.assert_array_equal(g_cnt, np.asarray(gcount))
        np.testing.assert_array_equal(g_ov, np.asarray(overflow))
        p_cnt, p_ov, r_cnt, r_ov = world[r][(name, "rows")]
        np.testing.assert_array_equal(p_cnt, np.asarray(gcount)[r:r + 1])
        np.testing.assert_array_equal(p_ov, np.asarray(overflow)[r:r + 1])
        np.testing.assert_array_equal(r_cnt, p_cnt)
        np.testing.assert_array_equal(r_ov, p_ov)


@pytest.mark.parametrize("name", ["g222-periodic", "g222-open",
                                  "g421-periodic", "fields", "open-wide"])
def test_ghost_sets_match_oracle_and_vranks(world, name):
    """Each rank's ghost set is ``brute_force_ghosts``' (the set-level
    oracle, float64), and the ranks' ghosts are the port's one-device
    vrank engines' on the same global input, byte for byte."""
    shape, R, dom, w, n, H, G, pos, count, ids = _case(name)
    tdom = TDomain(dom.lo, dom.hi, periodic=dom.periodic)
    grid = TGrid(shape)
    shards = [pos[r * n:r * n + count[r]] for r in range(R)]
    expected = toracle.brute_force_ghosts(tdom, grid, shards, w)
    vpos, vcnt, vids, vov = thalo.vrank_halo_fn(tdom, grid, w, H, G)(
        torch.from_numpy(pos.reshape(R, n, 3)), torch.from_numpy(count),
        torch.from_numpy(ids.reshape(R, n)))
    fused = np.concatenate([pos.reshape(R, n, 3).transpose(0, 2, 1),
                            ids.reshape(R, 1, n).view(np.float32)], axis=1)
    pg, pcnt, _ = thalo.vrank_halo_planar_fn(tdom, grid, w, H, G)(
        torch.from_numpy(fused), torch.from_numpy(count))
    for r in range(R):
        g_pos, g_cnt, g_ids, _ = world[r][(name, "rowmajor")]
        c = int(g_cnt[r])
        assert c == len(expected[r]), r
        got = g_pos[:c]
        exp = np.asarray(expected[r], np.float64)
        np.testing.assert_allclose(got[np.lexsort(got.T[::-1])],
                                   exp[np.lexsort(exp.T[::-1])], atol=1e-5)
        assert g_pos.tobytes() == vpos[r].numpy().tobytes(), r
        assert g_ids.tobytes() == vids[r].numpy().tobytes(), r
        assert world[r][(name, "planar")][0].tobytes() == (
            pg[r].numpy().tobytes()), r
    np.testing.assert_array_equal(world[0][(name, "planar")][1],
                                  pcnt.numpy())


@pytest.mark.parametrize("periodic", [True, False])
def test_negative_zero_face_coordinate_across_ranks(world, periodic):
    """The -0.0 rule of the vrank engines holds across ranks, as the
    reference's shard engines behave: a row at (-0.0, -0.0, 0.5) of cell
    (1, 1, 1) on Domain(-1, 1) reaches its neighbours with the zero shift
    ADDED on the pass's axis (+0.0) by the row-major engine, on either
    kind of axis, and by the planar engine on a periodic axis; on an open
    axis the planar engine keeps -0.0 on both axes (the reference's
    compiled program folds its ``x + 0``; ``ROADMAP.md`` C7)."""
    name = "negzero-periodic" if periodic else "negzero-open"
    shape, R, dom, w, n, H, G, pos, count, ids = _case(name)
    grid = JGrid(shape)
    src = grid.rank_of_cell((1, 1, 1))
    z, nz = 0, 0x80000000
    for cell, bits in (((0, 1, 1), [z, nz]), ((1, 0, 1), [nz, z]),
                       ((0, 0, 1), [z, z])):
        dst = grid.rank_of_cell(cell)
        g_pos, g_cnt, g_ids, _ = world[dst][(name, "rowmajor")]
        k = np.flatnonzero(g_ids[:g_cnt[dst]] == src * n)
        assert len(k) == 1
        assert list(g_pos[k[0], :2].view(np.uint32)) == bits, cell
        ghost, p_cnt, _ = world[dst][(name, "planar")]
        k = np.flatnonzero(ghost[3, :p_cnt[dst]].view(np.int32) == src * n)
        assert list(ghost[:2, k[0]].view(np.uint32)) == (
            bits if periodic else [nz, nz]), cell


def _ref_api(key):
    engine, policy, headroom, pinned = cases.HALO_API_CASES[key]
    pos, count, ids = cases.halo_inputs("auto")
    rd = japi.GridRedistribute(grid=(2, 2, 2), lo=0.0, hi=1.0, periodic=True,
                               mesh=_mesh((2, 2, 2)), engine=engine,
                               on_overflow=policy)
    kw = {} if pinned is None else dict(pass_capacity=pinned[0],
                                        ghost_capacity=pinned[1])
    try:
        res = rd.halo(pos, ids, width=0.12, count=count, headroom=headroom,
                      **kw)
    except RuntimeError as err:
        return rd, str(err)
    return rd, res


@pytest.mark.parametrize("key", list(cases.HALO_API_CASES))
def test_api_halo_mesh_matches_reference(world, key):
    """``GridRedistribute(mesh=).halo()`` against the reference's instance
    on its mesh: rank ``r``'s ghosts are its shard ``r``, the counters its
    global ones, and the policy acts on the gathered overflow, so every
    rank grows to the same capacities (``"grow"``), returns the overflow
    (``"ignore"``) or raises (``"raise"``, pinned capacities) together."""
    rd, want = _ref_api(key)
    if isinstance(want, str):
        for r in range(W):
            status, msg = world[r][("api", key)]
            assert status == "raised"
            assert msg == want
        assert key in ("raise", "pinned")
        return
    G = np.asarray(want.ghost_positions).shape[0] // W
    w_pos = split_rows(np.asarray(want.ghost_positions), W)
    w_ids = split_rows(np.asarray(want.ghost_fields[0]), W)
    for r in range(W):
        g_pos, g_ids, g_cnt, g_ov, g_caps = world[r][("api", key)]
        assert g_pos.shape[0] == G
        assert g_pos.tobytes() == w_pos[r].tobytes(), r
        assert g_ids.tobytes() == w_ids[r].tobytes(), r
        np.testing.assert_array_equal(g_cnt, np.asarray(want.ghost_count))
        np.testing.assert_array_equal(g_ov, np.asarray(want.overflow))
        assert g_caps == rd._halo_caps
    if key.startswith("grow"):
        assert rd._halo_caps and not np.asarray(want.overflow).any()
    if key == "ignore":
        assert np.asarray(want.overflow).any()


def test_builders_validate_and_reuse(world):
    """Widths past the subdomain raise before any collective; explicit
    capacities make one engine for every row count."""
    dom, grid = TDomain(0.0, 1.0, periodic=True), TGrid((1, 1, 1))
    with pytest.raises(ValueError, match="exceeds subdomain width"):
        thalo.shard_halo_fn(TDomain(0.0, 1.0, periodic=True),
                            TGrid((2, 2, 2)), 0.6, 8, 8, mesh=object())
    with pytest.raises(ValueError, match=">= 0"):
        thalo.build_halo_planar(None, dom, grid, -0.1, 8, 8)
    # a one-rank grid runs without a process group (no neighbours: a
    # periodic axis of extent 1 sends to itself, as the reference does)
    pos = torch.from_numpy(np.random.default_rng(5).random(
        (40, 3), dtype=np.float32))
    res = thalo.build_halo_exchange(None, dom, grid, 0.1, 64, 256)(
        pos, torch.tensor([40]))
    vres = thalo.vrank_halo_fn(dom, grid, 0.1, 64, 256)(pos[None],
                                                         torch.tensor([40]))
    assert res.ghost_positions.numpy().tobytes() == (
        vres[0][0].numpy().tobytes())
    np.testing.assert_array_equal(res.ghost_count.numpy(), vres[1].numpy())


def test_ranks_import_no_jax(world):
    for r in range(W):
        assert world[r][("imports",)] == []
