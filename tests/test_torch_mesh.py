"""The rank mesh (``parallel.mesh``), the collectives
(``parallel.collectives``) and the world launcher (``parallel.launch``):
the pure mesh helpers against the JAX package's own, the rank -> cell
order against the reference's device mesh, each collective against its
NumPy meaning in the 8-rank gloo world of ``test_torch_exchange_ranks``,
and a faulty rank failing its world within the world's own limit.
"""

import time

import jax
import numpy as np
import pytest

import torch_rank_cases as cases
from mpi_grid_redistribute_tpu.domain import ProcessGrid as JGrid
from mpi_grid_redistribute_tpu.parallel import mesh as jmesh
from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid as TGrid
from mpi_grid_redistribute_tpu_torch.parallel import launch
from mpi_grid_redistribute_tpu_torch.parallel import mesh as tmesh

GRIDS = [(2, 2, 2), (3, 3, 3), (4, 2, 1), (1, 1, 1), (2, 1, 1), (3, 1, 2),
         (5, 4), (2,)]
PERIODIC = ["all", "none", "mixed"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return cases.shared_world(tmp_path_factory, "exchange",
                              "torch_rank_cases:run_exchange", 8)


def _periodic(kind, ndim):
    if kind == "all":
        return (True,) * ndim
    if kind == "none":
        return (False,) * ndim
    return tuple(a % 2 == 0 for a in range(ndim))


def test_near_cubic_and_shrink_match_reference():
    for n in range(1, 97):
        for ndim in (1, 2, 3):
            assert tmesh.near_cubic_shape(n, ndim) == jmesh.near_cubic_shape(
                n, ndim)
    for shape in [(8, 4, 2), (1, 1, 1), (3, 3, 3), (5, 5, 1), (2, 6)]:
        assert tmesh.shrink_shape(shape) == jmesh.shrink_shape(shape)
        for m in (1, 2, 5, 8, 27, 100):
            assert tmesh.shrink_to_fit(shape, m) == jmesh.shrink_to_fit(
                shape, m)
    for bad in (lambda m: m.near_cubic_shape(0),
                lambda m: m.shrink_shape((0, 2)),
                lambda m: m.shrink_to_fit((2, 2), 0)):
        with pytest.raises(ValueError) as t_err:
            bad(tmesh)
        with pytest.raises(ValueError) as j_err:
            bad(jmesh)
        assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("kind", PERIODIC)
@pytest.mark.parametrize("shape", GRIDS, ids=str)
def test_neighbor_tables_match_reference(shape, kind):
    per = _periodic(kind, len(shape))
    got = tmesh.neighbor_tables(TGrid(shape), per)
    want = jmesh.neighbor_tables(JGrid(shape), per)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert tmesh.neighbor_perms(TGrid(shape), per) == jmesh.neighbor_perms(
        JGrid(shape), per)
    assert tmesh.stencil_offsets(len(shape)) == jmesh.stencil_offsets(
        len(shape))


@pytest.mark.parametrize("shape", [(2, 2, 2), (4, 2, 1), (1, 2, 4),
                                   (8, 1, 1)], ids=str)
def test_rank_order_matches_reference_mesh(world, shape):
    """Rank ``r`` of the gloo world sits at the cell where the reference's
    mesh puts device ``r``."""
    devs = jmesh.make_mesh(JGrid(shape), jax.devices()[:8]).devices
    for r in range(8):
        rank, coords, size, backend = world[r][("mesh", shape)]
        assert (rank, size, backend) == (r, 8, "gloo")
        assert devs[coords] == jax.devices()[r]


def test_collectives_match_their_meaning(world):
    R = 8
    for r in range(R):
        got = world[r][("collectives",)]
        send = [np.arange(R * 3, dtype=np.int32) + 100 * s for s in range(R)]
        np.testing.assert_array_equal(got["all_to_all"], np.concatenate(
            [send[s][3 * r:3 * r + 3] for s in range(R)]))
        y = [(np.arange(2 * R * 2).reshape(2, R * 2) + 1000 * s).astype(
            np.int16) for s in range(R)]
        assert got["all_to_all_dim1"].dtype == np.int16
        np.testing.assert_array_equal(got["all_to_all_dim1"], np.concatenate(
            [y[s][:, 2 * r:2 * r + 2] for s in range(R)], axis=1))
        np.testing.assert_array_equal(
            got["all_gather"], np.stack([[s, -s] for s in range(R)]))
        np.testing.assert_array_equal(got["psum"], [sum(range(R)), R])
        f = [np.asarray([0.1 * (s + 1), -2.5 ** s], np.float32)
             for s in range(R)]
        acc = f[0].copy()
        for s in range(1, R):
            acc = acc + f[s]
        assert got["psum_ordered"].tobytes() == acc.tobytes()
        assert int(got["pmin"][0]) == 5
        want_p = np.full((2, 2), float(r - 1) if r > 0 else 0.0, np.float32)
        np.testing.assert_array_equal(got["ppermute"], want_p)
        assert int(got["broadcast"][0]) == 7 * (R - 1)
        assert got["axis_index"] == r


def test_validate_mesh_for_grid_and_one_rank_mesh():
    m = tmesh.make_mesh(TGrid((1, 1, 1)))  # no process group needed
    assert (m.size, m.rank, m.coords, m.group) == (1, 0, (0, 0, 0), None)
    tmesh.validate_mesh_for_grid(m, TGrid((1, 1, 1)))
    with pytest.raises(ValueError, match="mesh shape"):
        tmesh.validate_mesh_for_grid(m, TGrid((2, 1, 1)))
    with pytest.raises(ValueError, match="mesh axes"):
        tmesh.validate_mesh_for_grid(m, TGrid((1, 1, 1), ("a", "b", "c")))
    with pytest.raises(ValueError, match="torch.distributed"):
        tmesh.make_mesh(TGrid((2, 1, 1)))


def test_nccl_refuses_more_ranks_than_cards():
    with pytest.raises(ValueError, match="one rank per GPU"):
        tmesh.initialize_distributed("nccl", world_size=2, rank=0,
                                     init_method="file:///nonexistent")


def test_run_world_runs_on_the_gpu_by_default(monkeypatch):
    """Without ``device=`` the ranks go to the GPU: with none visible the
    call raises before any rank starts."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run_world("torch_rank_cases:fail_or_hang", 2,
                         args=("raise",))


def test_failing_rank_fails_the_world():
    with pytest.raises(launch.RankFailed, match="fails on purpose"):
        launch.run_world("torch_rank_cases:fail_or_hang", 2,
                         args=("raise",), device="cpu", timeout=60,
                         pg_timeout=20)


def test_hung_rank_fails_within_the_limit():
    """A rank that never reaches a collective: its peer gives up at the
    process group's timeout, and the world fails well before the hung
    rank would wake (no wait on gloo's default half hour)."""
    t0 = time.monotonic()
    with pytest.raises(launch.RankFailed, match="rank 0 of 2"):
        launch.run_world("torch_rank_cases:fail_or_hang", 2,
                         args=("hang",), device="cpu", timeout=90,
                         pg_timeout=4)
    # the collective's timeout fired, not the world's
    assert time.monotonic() - t0 < 45


def test_spawned_ranks_import_no_jax(world):
    """Every rank of the world is a fresh interpreter that imported the
    port and its case runner only: no JAX, nothing of the JAX package."""
    for r in range(8):
        assert world[r][("imports",)] == [], world[r][("imports",)]


def test_convert_shard_helpers_round_trip():
    """``convert``'s split/join of the reference's global layouts, on
    NumPy arrays and tensors: rows, lanes, the loop's planar flat, a
    grid-sharded mesh and a stats record."""
    import torch

    from mpi_grid_redistribute_tpu_torch import convert
    from mpi_grid_redistribute_tpu_torch.parallel.exchange import (
        RedistributeStats,
    )

    a = np.arange(8 * 5 * 3).reshape(40, 3)
    for x in (a, torch.from_numpy(a)):
        parts = convert.split_rows(x, 8)
        assert [tuple(p.shape) for p in parts] == [(5, 3)] * 8
        assert (np.asarray(convert.join_rows(parts)) == a).all()
    planar = np.arange(7 * 40).reshape(7, 40)
    lanes = convert.split_lanes(planar, 4)
    assert (lanes[2] == planar[:, 20:30]).all()
    assert (convert.join_lanes(lanes) == planar).all()
    flat = np.arange(3 * 12)  # 4 ranks' [3, 3] planar blocks, shard-major
    assert (convert.split_flat(flat, 4)[1] == np.arange(9, 18)).all()
    rho = np.arange(4 * 4 * 2).reshape(4, 4, 2)
    blocks = convert.split_grid(rho, (2, 2, 1))
    assert (blocks[1] == rho[:2, 2:, :]).all()
    assert (blocks[2] == rho[2:, :2, :]).all()
    st = RedistributeStats(*(np.arange(16).reshape(4, 4),) * 2,
                           *(np.arange(4),) * 3)
    rows = convert.split_stats(st, 4)
    assert (rows[3].send_counts == np.arange(12, 16)[None]).all()
    assert rows[3].dropped_send.tolist() == [3] and rows[0].fallback is None
    with pytest.raises(ValueError, match="split"):
        convert.split_rows(a, 7)
