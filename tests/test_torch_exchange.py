"""Port canonical vrank engines (mpi_grid_redistribute_tpu_torch.parallel.
exchange) vs the JAX package's ``build_redistribute_planar_vranks`` and
``build_redistribute_vranks`` at the same capacities, bit level (uint8
views) on the output rows, the counts and every stats leaf, and vs the
port's NumPy oracle. Grids (1,1,1), (2,1,1), (2,2,2), (3,2,1); uniform
cells and ``GridEdges`` with and without an assignment; overflow on both
sides; count 0; fields with NaN payloads, -0.0 and denormals (the
transport is an int32 view, so no float op touches them)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mpi_grid_redistribute_tpu import domain as jdomain
from mpi_grid_redistribute_tpu.parallel import exchange as jex
from mpi_grid_redistribute_tpu_torch import domain as tdomain
from mpi_grid_redistribute_tpu_torch import oracle
from mpi_grid_redistribute_tpu_torch.parallel import exchange as tex

torch.set_num_threads(1)

GRIDS = [(1, 1, 1), (2, 1, 1), (2, 2, 2), (3, 2, 1)]
STATS = ("send_counts", "recv_counts", "dropped_send", "dropped_recv",
         "needed_capacity")


def _u8(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if got.dtype == np.bool_ and want.dtype == np.int32:
        got = got.astype(np.int32)  # the reference's promotion, C6
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(_u8(got), _u8(want))


def _doms(periodic=True, lo=0.0, hi=1.0):
    return (jdomain.Domain(lo, hi, periodic=periodic),
            tdomain.Domain(lo, hi, periodic=periodic))


def _state(r, V, n):
    """Positions spilling past the box (wrap and clamp), a float32 velocity
    with special bit patterns and int32 ids."""
    pos = (r.random((V, n, 3), dtype=np.float32) * 1.4 - 0.2).astype(
        np.float32)
    vel = r.standard_normal((V, n, 3)).astype(np.float32)
    vel.view(np.uint32)[:, :4, 0] = np.array(
        [0x7FC0BEEF, 0x00000001, 0x80000000, 0x007FFFFF], np.uint32)
    ids = r.integers(-2**31, 2**31 - 1, (V, n)).astype(np.int32)
    return pos, vel, ids


def _edges(grid_shape, kind, r):
    if kind is None:
        return None, None
    axes = []
    for d, g in enumerate(grid_shape):
        cells = g * (2 if kind == "assignment" else 1)
        if d == 0:
            ax = np.linspace(0.0, 1.0, cells + 1)  # a uniform axis
        else:
            ax = np.concatenate([[0.0], np.sort(r.random(cells - 1)), [1.0]])
        axes.append(tuple(float(v) for v in ax))
    assign = None
    if kind == "assignment":
        n_fine = int(np.prod([len(a) - 1 for a in axes]))
        assign = tuple(int(v) for v in r.integers(0, np.prod(grid_shape),
                                                  n_fine))
    return jdomain.GridEdges(axes, assign), tdomain.GridEdges(axes, assign)


def _check_stats(got, want):
    for f in STATS:
        _same(getattr(got, f), getattr(want, f))
    assert got.fallback is None and got.pipeline is None


@pytest.mark.parametrize("edge_kind", [None, "edges", "assignment"])
@pytest.mark.parametrize("as_int", [False, True])
@pytest.mark.parametrize("grid_shape", GRIDS)
def test_planar_engine_matches_jax(grid_shape, as_int, edge_kind):
    r = np.random.default_rng(sum(grid_shape) * 10 + as_int)
    V, n = int(np.prod(grid_shape)), 400
    pos, vel, ids = _state(r, V, n)
    fused = np.concatenate([pos.transpose(0, 2, 1), vel.transpose(0, 2, 1),
                            ids.view(np.float32)[:, None, :]], axis=1)
    fused = np.ascontiguousarray(fused.view(np.int32) if as_int else fused)
    count = r.integers(0, n + 1, V).astype(np.int32)
    count[0] = n
    jd, td = _doms()
    je, te = _edges(grid_shape, edge_kind, r)
    cap, out_cap = 24, 500  # clips some remote pairs
    want = jex.build_redistribute_planar_vranks(
        jd, jdomain.ProcessGrid(grid_shape), cap, out_cap, edges=je
    )(jnp.asarray(fused), jnp.asarray(count))
    got = tex.build_redistribute_planar_vranks(
        td, tdomain.ProcessGrid(grid_shape), cap, out_cap, edges=te
    )(torch.from_numpy(fused), torch.from_numpy(count))
    _same(got[0], want[0])
    _same(got[1], want[1])
    _check_stats(got[2], want[2])


@pytest.mark.parametrize("grid_shape", GRIDS)
def test_rowmajor_engine_matches_jax_on_narrow_fields(grid_shape):
    """int16 and bool fields take the row-major engine; the reference
    returns a bool field as int32 (ROADMAP.md C6), the port keeps bool."""
    r = np.random.default_rng(sum(grid_shape))
    V, n = int(np.prod(grid_shape)), 300
    pos, vel, _ = _state(r, V, n)
    h = r.integers(-2**15, 2**15 - 1, (V, n, 2)).astype(np.int16)
    b = r.random((V, n)) < 0.5
    count = r.integers(0, n + 1, V).astype(np.int32)
    jd, td = _doms(periodic=(True, False, True))
    cap, out_cap = 20, 250
    args = (pos, count, vel, h, b)
    want = jex.build_redistribute_vranks(
        jd, jdomain.ProcessGrid(grid_shape), cap, out_cap
    )(*map(jnp.asarray, args))
    got = tex.build_redistribute_vranks(
        td, tdomain.ProcessGrid(grid_shape), cap, out_cap
    )(*map(torch.from_numpy, args))
    assert got[4].dtype == torch.bool
    for g, w in zip(got[:-1], want[:-1]):
        _same(g, w)
    _check_stats(got[-1], want[-1])


@pytest.mark.parametrize("cap,out_cap", [(2, 1000), (64, 40), (64, 5000)])
def test_engines_match_the_oracle_at_tight_and_loose_capacities(cap, out_cap):
    """Both engines against the port's NumPy oracle, with drops on the send
    side, the receive side, and an output larger than the whole pool (the
    zero-padded branch)."""
    grid_shape = (2, 2, 2)
    r = np.random.default_rng(cap + out_cap)
    V, n = 8, 350
    pos, vel, ids = _state(r, V, n)
    count = r.integers(0, n + 1, V).astype(np.int32)
    _, td = _doms()
    tg = tdomain.ProcessGrid(grid_shape)
    want = oracle.redistribute_oracle_padded(
        td, tg, pos.reshape(V * n, 3), count,
        [vel.reshape(V * n, 3), ids.reshape(V * n)], cap, out_cap)
    fused = np.concatenate([pos.transpose(0, 2, 1), vel.transpose(0, 2, 1),
                            ids.view(np.float32)[:, None, :]], axis=1)
    out, cnt, stats = tex.vrank_redistribute_planar_fn(td, tg, cap, out_cap)(
        torch.from_numpy(np.ascontiguousarray(fused)), torch.from_numpy(count))
    rows = out.numpy().transpose(0, 2, 1)
    _same(np.ascontiguousarray(rows[..., :3]).reshape(-1, 3), want[0])
    _same(np.ascontiguousarray(rows[..., 3:6]).reshape(-1, 3), want[2][0])
    _same(np.ascontiguousarray(rows[..., 6]).view(np.int32).reshape(-1),
          want[2][1])
    _same(cnt, want[1])
    for f in STATS:
        _same(getattr(stats, f), want[3][f])
    rm = tex.vrank_redistribute_fn(td, tg, cap, out_cap)(
        *map(torch.from_numpy, (pos, count, vel, ids)))
    _same(rm[0].reshape(-1, 3), want[0])
    _same(rm[2].reshape(-1, 3), want[2][0])
    _same(rm[3].reshape(-1), want[2][1])
    _same(rm[1], want[1])
    for f in STATS:
        _same(getattr(rm[4], f), want[3][f])
    if cap == 2:
        assert want[3]["dropped_send"].sum() > 0
    if out_cap == 40:
        assert want[3]["dropped_recv"].sum() > 0


def test_count_zero_gives_zero_output():
    _, td = _doms()
    tg = tdomain.ProcessGrid((2, 2, 2))
    r = np.random.default_rng(0)
    fused = torch.from_numpy(r.random((8, 4, 64), dtype=np.float32))
    out, cnt, stats = tex.vrank_redistribute_planar_fn(td, tg, 16, 64)(
        fused, torch.zeros(8, dtype=torch.int32))
    assert not out.view(torch.int32).any() and not cnt.any()
    assert not stats.send_counts.any() and not stats.needed_capacity.any()


def test_planar_engine_refuses_bad_input():
    _, td = _doms()
    fn = tex.vrank_redistribute_planar_fn(td, tdomain.ProcessGrid((2, 1, 1)),
                                          4, 8)
    with pytest.raises(ValueError):
        fn(torch.zeros((3, 4, 8)), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        fn(torch.zeros((2, 4, 8), dtype=torch.float64),
           torch.zeros(2, dtype=torch.int32))
