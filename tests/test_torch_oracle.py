"""The port's NumPy oracle (mpi_grid_redistribute_tpu_torch.oracle) vs the
JAX package's oracle on its NumPy path (``native_ok=False``), bit level:
the binning copy (the reference's ``xp=np`` branch, NaN and out-of-box
rows included), ``redistribute_oracle`` on ragged shards,
``redistribute_oracle_padded`` at tight and loose capacities with and
without ``GridEdges``, and ``assert_ownership``."""

import numpy as np
import pytest

from mpi_grid_redistribute_tpu import domain as jdomain
from mpi_grid_redistribute_tpu import oracle as joracle
from mpi_grid_redistribute_tpu.ops import binning as jbin
from mpi_grid_redistribute_tpu_torch import domain as tdomain
from mpi_grid_redistribute_tpu_torch import oracle

GRIDS = [(1, 1, 1), (2, 1, 1), (2, 2, 2), (3, 2, 1)]


def _u8(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _doms(lo, hi, periodic):
    return (jdomain.Domain(lo, hi, periodic=periodic),
            tdomain.Domain(lo, hi, periodic=periodic))


def _edges(grid_shape, kind, r):
    if kind is None:
        return None, None
    axes = []
    for d, g in enumerate(grid_shape):
        cells = g * (2 if kind == "assignment" else 1)
        ax = (np.linspace(0.0, 1.0, cells + 1) if d == 0 else
              np.concatenate([[0.0], np.sort(r.random(cells - 1)), [1.0]]))
        axes.append(tuple(float(v) for v in ax))
    assign = None
    if kind == "assignment":
        n_fine = int(np.prod([len(a) - 1 for a in axes]))
        assign = tuple(int(v) for v in r.integers(0, np.prod(grid_shape),
                                                  n_fine))
    return jdomain.GridEdges(axes, assign), tdomain.GridEdges(axes, assign)


@pytest.mark.parametrize("edge_kind", [None, "edges", "assignment"])
@pytest.mark.parametrize("lo,hi,periodic", [
    (0.0, 1.0, True),
    ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (True, False, True)),
    ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), False),
])
def test_binning_copy_matches_the_reference_numpy_path(lo, hi, periodic,
                                                       edge_kind):
    r = np.random.default_rng(3)
    jd, td = _doms(lo, hi, periodic)
    grid_shape = (3, 2, 2)
    jg, tg = jdomain.ProcessGrid(grid_shape), tdomain.ProcessGrid(grid_shape)
    je, te = _edges(grid_shape, edge_kind, r)
    pos = (r.random((4000, 3), dtype=np.float32) * 1.6 - 0.3).astype(
        np.float32)
    pos[:6, 1] = [np.nan, np.inf, -np.inf, 1.0, 0.0, -0.0]
    np.testing.assert_array_equal(
        oracle.wrap_periodic(pos, td), jbin.wrap_periodic(pos, jd, xp=np))
    np.testing.assert_array_equal(
        oracle.rank_of_position(pos, td, tg, edges=te),
        jbin.rank_of_position(pos, jd, jg, xp=np, edges=je))


@pytest.mark.parametrize("grid_shape", GRIDS)
def test_redistribute_oracle_matches_reference(grid_shape):
    r = np.random.default_rng(sum(grid_shape))
    jd, td = _doms(0.0, 1.0, True)
    R = int(np.prod(grid_shape))
    sizes = r.integers(0, 200, R)
    pos = [r.random((s, 3), dtype=np.float32) for s in sizes]
    fields = [(r.standard_normal((s, 2)).astype(np.float32),
               np.arange(s, dtype=np.int16)) for s in sizes]
    want = joracle.redistribute_oracle(jd, jdomain.ProcessGrid(grid_shape),
                                       pos, fields)
    got = oracle.redistribute_oracle(td, tdomain.ProcessGrid(grid_shape),
                                     pos, fields)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(_u8(g), _u8(w))
    for gf, wf in zip(got[1], want[1]):
        for g, w in zip(gf, wf):
            np.testing.assert_array_equal(_u8(g), _u8(w))
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("edge_kind", [None, "edges", "assignment"])
@pytest.mark.parametrize("cap,out_cap", [(8, 400), (300, 100), (300, 900)])
@pytest.mark.parametrize("grid_shape", GRIDS)
def test_padded_oracle_matches_reference(grid_shape, cap, out_cap,
                                         edge_kind):
    r = np.random.default_rng(sum(grid_shape) + cap)
    jd, td = _doms(0.0, 1.0, (True, True, False))
    R, n = int(np.prod(grid_shape)), 300
    je, te = _edges(grid_shape, edge_kind, r)
    pos = (r.random((R * n, 3), dtype=np.float32) * 1.2 - 0.1).astype(
        np.float32)
    vel = r.standard_normal((R * n, 3)).astype(np.float32)
    flag = r.random(R * n) < 0.5
    counts = r.integers(0, n + 1, R)
    want = joracle.redistribute_oracle_padded(
        jd, jdomain.ProcessGrid(grid_shape), pos, counts, [vel, flag], cap,
        out_cap, native_ok=False, edges=je)
    got = oracle.redistribute_oracle_padded(
        td, tdomain.ProcessGrid(grid_shape), pos, counts, [vel, flag], cap,
        out_cap, edges=te)
    np.testing.assert_array_equal(_u8(got[0]), _u8(want[0]))
    np.testing.assert_array_equal(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(_u8(g), _u8(w))
    assert got[3].keys() == want[3].keys()
    for k in want[3]:
        assert got[3][k].dtype == want[3][k].dtype
        np.testing.assert_array_equal(got[3][k], want[3][k])


def test_assert_ownership():
    r = np.random.default_rng(8)
    _, td = _doms(0.0, 1.0, True)
    tg = tdomain.ProcessGrid((2, 2, 2))
    pos = r.random((800, 3), dtype=np.float32)
    out, cnt, _, _ = oracle.redistribute_oracle_padded(
        td, tg, pos, np.full(8, 100), [], 100, 200)
    shards = [out[i * 200: i * 200 + cnt[i]] for i in range(8)]
    oracle.assert_ownership(td, tg, shards)
    shards[0] = np.concatenate([shards[0], shards[1][:1]])
    with pytest.raises(AssertionError, match="rank 0"):
        oracle.assert_ownership(td, tg, shards)
    with pytest.raises(ValueError):
        oracle.redistribute_oracle(td, tg, shards[:3])
