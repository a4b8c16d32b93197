"""Port binning (mpi_grid_redistribute_tpu_torch.ops.binning) vs the JAX
package's ops/binning.py, bit level: remainder_fast, the planar wrap, the
engine's destination key (positions exactly on cell edges included) and
the destination sort with its leaver-prefix contract. Inputs come from a
numpy seed; tolerance is bit-exact (uint32 views) throughout."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mpi_grid_redistribute_tpu import domain as jdomain
from mpi_grid_redistribute_tpu.ops import binning as jbin
from mpi_grid_redistribute_tpu_torch import domain as tdomain
from mpi_grid_redistribute_tpu_torch.ops import binning as tbin

# the inputs are small: one intra-op thread is as fast here and keeps
# these tests from competing for cores with the other test workers
torch.set_num_threads(1)


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32)


def _edge_values(r, ext, size=4096):
    """Random values around [-2 ext, 3 ext] plus exact multiples of the
    extent and of its cell widths (the values that re-home a particle
    when one ulp is off)."""
    vals = (r.random(size, dtype=np.float32) * 5 - 2) * np.float32(ext)
    edges = np.float32(ext) * np.arange(-8, 17, dtype=np.float32) / 4
    return np.concatenate([vals, edges, -edges, [0.0, -0.0]]).astype(
        np.float32
    )


@pytest.mark.parametrize("ext", [1.0, 0.5, 4.0, 3.0, 0.3])
def test_remainder_fast_matches_jax(ext):
    r = np.random.default_rng(int(ext * 10))
    q = _edge_values(r, ext)
    want = jax.jit(lambda x: jbin.remainder_fast(x, ext))(jnp.asarray(q))
    got = tbin.remainder_fast(torch.from_numpy(q), ext)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize(
    "lo,hi,periodic",
    [
        ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (True, True, True)),
        ((0.0, -2.0, 1.0), (1.0, 2.0, 3.0), (True, False, True)),
        ((-1.0, 0.0, 0.5), (2.0, 0.7, 1.5), (True, True, False)),
    ],
)
def test_wrap_periodic_planar_matches_jax(lo, hi, periodic):
    jd = jdomain.Domain(lo, hi, periodic=periodic)
    td = tdomain.Domain(lo, hi, periodic=periodic)
    r = np.random.default_rng(3)
    pos = np.stack(
        [
            np.float32(lo[d]) + _edge_values(r, hi[d] - lo[d], 2048)
            for d in range(3)
        ]
    ).astype(np.float32)
    want = jax.jit(lambda p: jbin.wrap_periodic_planar(p, jd))(
        jnp.asarray(pos)
    )
    got = tbin.wrap_periodic_planar(torch.from_numpy(pos), td)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("grid_shape", [(2, 2, 2), (4, 2, 1)])
def test_dest_key_on_cell_edges_matches_jax(grid_shape):
    """The engine's key: jax rank_of_position_planar, masked to leavers,
    on positions that sit exactly on every cell edge and domain face."""
    domain_args = ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (True, True, False))
    jd = jdomain.Domain(*domain_args[:2], periodic=domain_args[2])
    td = tdomain.Domain(*domain_args[:2], periodic=domain_args[2])
    jg, tg = jdomain.ProcessGrid(grid_shape), tdomain.ProcessGrid(grid_shape)
    V, n = tg.nranks, 512
    r = np.random.default_rng(11)
    pos = r.random((3, V * n), dtype=np.float32)
    for d in range(3):
        edges = np.arange(0, 2 * grid_shape[d] + 1) / (2 * grid_shape[d])
        pos[d, : edges.size] = edges.astype(np.float32)
    pos[:, -4:] = np.float32(1.0)  # the upper face
    alive = r.random(V * n) < 0.8
    me = np.repeat(np.arange(V, dtype=np.int32), n)

    def jkey(p, a):
        rank = jbin.rank_of_position_planar(p, jd, jg)
        return jnp.where(a & (rank != me), rank, V).reshape(V, n)

    want = jax.jit(jkey)(jnp.asarray(pos), jnp.asarray(alive))
    got = tbin.dest_key_planar(
        torch.from_numpy(pos), torch.from_numpy(alive), td, tg, V, V
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_floor_to_int32_saturates_like_xla():
    x = np.array(
        [np.inf, -np.inf, np.nan, 1e10, -1e10, 2.0**31, -(2.0**31),
         2147483520.0, 3.7, -3.2, 0.0, -0.0],
        np.float32,
    )
    want = jax.jit(lambda a: jnp.floor(a).astype(jnp.int32))(jnp.asarray(x))
    got = tbin.floor_to_int32(torch.from_numpy(x))
    # values beyond 2^31 - 128 clamp there in the port; both sides clip
    # to a cell range afterwards, so compare after a clip
    np.testing.assert_array_equal(
        np.clip(got.numpy(), -1000, 1000), np.clip(np.asarray(want), -1000, 1000)
    )
    assert got.numpy()[2] == 0  # NaN -> 0, as XLA


@pytest.mark.parametrize("n,frac", [(1000, 0.3), (8192, 0.02), (8192, 0.9)])
def test_sorted_dest_counts_matches_jax(n, frac):
    r = np.random.default_rng(n)
    n_dest = 8
    dest = np.where(
        r.random(n) < frac, r.integers(0, n_dest, n), n_dest
    ).astype(np.int32)
    o_j, c_j, b_j = jax.jit(
        lambda k: jbin.sorted_dest_counts(k, n_dest)
    )(jnp.asarray(dest))
    o_t, c_t, b_t = tbin.sorted_dest_counts(torch.from_numpy(dest), n_dest)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


@pytest.mark.parametrize(
    "V,n,frac",
    # 8192 columns at 2% leavers takes the reference's two-level
    # selection; 90% violates its guard (flat sort); 777 is too narrow
    [(8, 8192, 0.02), (8, 8192, 0.9), (4, 777, 0.3)],
)
def test_sorted_dest_counts_batched_leaver_prefix(V, n, frac):
    r = np.random.default_rng(V * n)
    dest = np.where(
        r.random((V, n)) < frac, r.integers(0, V, (V, n)), V
    ).astype(np.int32)
    o_j, c_j, b_j = jax.jit(
        lambda k: jbin.sorted_dest_counts_batched(k, V)
    )(jnp.asarray(dest))
    o_t, c_t, b_t = tbin.sorted_dest_counts_batched(torch.from_numpy(dest), V)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    o_j, o_t = np.asarray(o_j), o_t.numpy()
    for v in range(V):
        lv = int(np.asarray(c_j)[v].sum())
        np.testing.assert_array_equal(o_t[v, :lv], o_j[v, :lv])
        # the prefix is each leaver's column in (dest, column) order
        cols = np.flatnonzero(dest[v] != V)
        want = cols[np.argsort(dest[v, cols], kind="stable")]
        np.testing.assert_array_equal(o_t[v, :lv], want)
