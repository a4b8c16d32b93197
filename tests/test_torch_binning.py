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


# ---- the canonical exchange's routing: row-major and planar binning,
# GridEdges (digitize, uniform axes, assignment), dest_histogram

DOMAINS = [
    ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (True, True, True)),
    ((0.0, -2.0, 1.0), (1.0, 2.0, 3.0), (True, False, True)),
    ((-1.5, 0.0, 0.5), (1.5, 0.3, 1.5), (True, True, False)),  # ext 3, 0.3
    ((0.0, 0.0, 0.0), (1.7, 2.9, 1.0), (False, True, True)),  # ext 1.7, 2.9
    ((0.25, 0.0, 0.0), (1.25, 1.0, 1.0), (False, False, False)),
]


def _rows(r, lo, hi, grid_shape, n=3000):
    """Row-major positions over [lo - ext/2, hi + ext/2): random values,
    every cell edge and the domain faces, +-0.0, inf and NaN."""
    cols = []
    for d in range(3):
        ext = hi[d] - lo[d]
        v = (np.float32(lo[d]) + (r.random(n, dtype=np.float32) * 2 - 0.5)
             * np.float32(ext)).astype(np.float32)
        edges = (np.float32(lo[d]) + np.float32(ext)
                 * np.arange(-2, 2 * grid_shape[d] + 3, dtype=np.float32)
                 / np.float32(2 * grid_shape[d])).astype(np.float32)
        v[: edges.size] = edges
        v[-6:] = [0.0, -0.0, np.float32(hi[d]), np.float32(lo[d]), 1e30,
                  -1e30]
        cols.append(v)
    return np.stack(cols, axis=-1)


def _jdom(lo, hi, periodic):
    return (jdomain.Domain(lo, hi, periodic=periodic),
            tdomain.Domain(lo, hi, periodic=periodic))


@pytest.mark.parametrize("lo,hi,periodic", DOMAINS)
def test_wrap_periodic_rowmajor_matches_jax(lo, hi, periodic):
    jd, td = _jdom(lo, hi, periodic)
    pos = _rows(np.random.default_rng(21), lo, hi, (2, 2, 2))
    want = jax.jit(lambda p: jbin.wrap_periodic(p, jd))(jnp.asarray(pos))
    got = tbin.wrap_periodic(torch.from_numpy(pos), td)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _edges(lo, hi, grid_shape, kind, r):
    """GridEdges of each kind on both sides: random inner boundaries, an
    exact linspace (uniform_axes) on axis 0, and a finer assignment-aware
    grid."""
    axes = []
    for d, g in enumerate(grid_shape):
        cells = g * (2 if kind == "assignment" else 1)
        if d == 0 or kind == "assignment":
            ax = np.linspace(lo[d], hi[d], cells + 1)
        else:
            inner = np.sort(r.uniform(lo[d], hi[d], cells - 1))
            ax = np.concatenate([[lo[d]], inner, [hi[d]]])
        axes.append(tuple(float(v) for v in ax))
    assign = None
    if kind == "assignment":
        n_fine = int(np.prod([len(a) - 1 for a in axes]))
        assign = tuple(int(v) for v in r.integers(0, np.prod(grid_shape),
                                                  n_fine))
    return (jdomain.GridEdges(axes, assign), tdomain.GridEdges(axes, assign))


@pytest.mark.parametrize("edge_kind", [None, "edges", "assignment"])
@pytest.mark.parametrize("grid_shape", [(2, 2, 2), (3, 2, 1), (1, 1, 1)])
@pytest.mark.parametrize("lo,hi,periodic", [DOMAINS[i] for i in (0, 2, 4)])
def test_rank_of_position_matches_jax(lo, hi, periodic, grid_shape,
                                      edge_kind):
    """Row-major and planar cells and ranks, uniform and with edges (NaN
    rows left out with edges: the reference's own engine and oracle
    disagree there)."""
    r = np.random.default_rng(len(grid_shape) * 7 + grid_shape[0])
    jd, td = _jdom(lo, hi, periodic)
    jg, tg = jdomain.ProcessGrid(grid_shape), tdomain.ProcessGrid(grid_shape)
    je = te = None
    if edge_kind is not None:
        je, te = _edges(lo, hi, grid_shape, edge_kind, r)
        assert te.uniform_axes == je.uniform_axes
        assert te.uniform_axes[0]
    pos = _rows(r, lo, hi, grid_shape)
    if edge_kind is None:
        pos[7] = np.nan
    for jfn, tfn in ((jbin.cell_of_position, tbin.cell_of_position),
                     (jbin.rank_of_position, tbin.rank_of_position)):
        want = jax.jit(lambda p: jfn(p, jd, jg, edges=je))(jnp.asarray(pos))
        got = tfn(torch.from_numpy(pos), td, tg, edges=te)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    planar = np.ascontiguousarray(pos.T)
    for jfn, tfn in ((jbin.cell_of_position_planar,
                      tbin.cell_of_position_planar),
                     (jbin.rank_of_position_planar,
                      tbin.rank_of_position_planar)):
        want = jax.jit(lambda p: jfn(p, jd, jg, edges=je))(
            jnp.asarray(planar))
        got = tfn(torch.from_numpy(planar), td, tg, edges=te)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_canonical_inverse_width_is_the_float64_quotient():
    """The canonical binning takes float32(g / ext) from a float64
    quotient, the migrate loop's ``axis_consts`` a float32 division: at
    extent 1.7 and 3 cells they differ by an ulp, so the canonical path
    keeps its own formula (held against the reference's canonical
    binning by the test above, whose third domain has extent 0.3)."""
    d = tdomain.Domain((0.0,) * 3, (1.7, 1.0, 1.0))
    canon = np.float32(3 / d.extent[0])
    loop = tbin.axis_consts(d, (3, 1, 1), 0)[4]
    assert canon != loop


@pytest.mark.parametrize("with_valid", [False, True])
def test_dest_histogram_matches_jax(with_valid):
    r = np.random.default_rng(31)
    dest = r.integers(0, 9, 5000).astype(np.int32)  # 8 = the sentinel
    valid = r.random(5000) < 0.7 if with_valid else None
    want = jax.jit(lambda k, v: jbin.dest_histogram(k, 8, v))(
        jnp.asarray(dest), None if valid is None else jnp.asarray(valid))
    got = tbin.dest_histogram(
        torch.from_numpy(dest), 8,
        None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tbin.dest_histogram_np(dest, 8, valid),
                                  jbin.dest_histogram_np(dest, 8, valid))
