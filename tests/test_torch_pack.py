"""Port pack and compaction (mpi_grid_redistribute_tpu_torch.ops.pack) vs
the JAX package's ops/pack.py, bit level (uint8 views): the row-major
pack and both compactions, ``_stable_order``'s packed one-word branch and
its multi-key branch, the planar compaction's packed single key and its
two-key sort (reached with many sources), and the planar pack. The
port's functions take a leading batch dimension; batched calls equal a
loop of unbatched ones. Inputs come from a numpy seed."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mpi_grid_redistribute_tpu.ops import pack as jpack
from mpi_grid_redistribute_tpu_torch.ops import pack as tpack

torch.set_num_threads(1)


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if got.dtype == np.bool_ and want.dtype == np.int32:
        # the reference's ``jnp.where(mask, a, 0)`` promotes a bool array
        # to int32 (ROADMAP.md C6); the port keeps bool, as the oracle does
        got = got.astype(np.int32)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(
        np.ascontiguousarray(got).view(np.uint8),
        np.ascontiguousarray(want).view(np.uint8))


def _payload(r, n):
    """A float32 [n, 3] block with NaN payloads, -0.0 and denormals, an
    int32 column and a bool flag."""
    f = r.standard_normal((n, 3)).astype(np.float32)
    special = np.array([0x7FC0BEEF, 0x00000001, 0x80000000, 0x007FFFFF,
                        0xFF800000], np.uint32)[:n]
    f.view(np.uint32)[: special.size, 0] = special
    return f, r.integers(-2**31, 2**31 - 1, n).astype(np.int32), r.random(n) < 0.5


def _dest(r, n, R, frac_self=0.3):
    d = r.integers(0, R + 1, n).astype(np.int32)  # R = the sentinel
    d[r.random(n) < frac_self] = R
    return d


@pytest.mark.parametrize("R,n,cap", [(8, 700, 40), (3, 64, 64), (1, 10, 4),
                                     (6, 1000, 1)])
def test_pack_by_destination_matches_jax(R, n, cap):
    r = np.random.default_rng(R * n + cap)
    dest = _dest(r, n, R)
    counts = np.bincount(dest, minlength=R + 1)[:R].astype(np.int32)
    arrays = _payload(r, n)
    want = jax.jit(lambda d, c, *a: jpack.pack_by_destination(
        d, c, a, cap))(jnp.asarray(dest), jnp.asarray(counts),
                       *map(jnp.asarray, arrays))
    got = tpack.pack_by_destination(
        torch.from_numpy(dest), torch.from_numpy(counts),
        tuple(map(torch.from_numpy, arrays)), cap)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("m", [1, 2, 37, 5000])
def test_stable_order_packed_branch_matches_jax(m):
    r = np.random.default_rng(m)
    invalid = r.random(m) < 0.4
    want = jax.jit(jpack._stable_order)(jnp.asarray(invalid))
    got = tpack._stable_order(torch.from_numpy(invalid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stable_order_multi_key_branch_matches_jax():
    r = np.random.default_rng(5)
    invalid = r.random(3000) < 0.3
    key = r.integers(0, 9, 3000).astype(np.int32)
    want = jax.jit(jpack._stable_order)(jnp.asarray(invalid), jnp.asarray(key))
    got = tpack._stable_order(torch.from_numpy(invalid), torch.from_numpy(key))
    # the valid prefix is contractual; the reference's tail is the
    # invalid rows in (key, position) order as well
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _recv(r, R, cap, arrays_like):
    recv_counts = r.integers(0, cap + 1, R).astype(np.int32)
    recv = tuple(
        (r.standard_normal((R, cap) + a.shape[1:]) * 100).astype(a.dtype)
        if a.dtype != np.bool_ else r.random((R, cap) + a.shape[1:]) < 0.5
        for a in arrays_like
    )
    return recv, recv_counts


@pytest.mark.parametrize("R,cap,n,out_cap", [
    (8, 30, 200, 300), (8, 30, 200, 50), (4, 5, 1000, 2000), (1, 8, 50, 20),
])
def test_compact_with_self_matches_jax(R, cap, n, out_cap):
    r = np.random.default_rng(R * cap + n)
    local = _payload(r, n)
    recv, recv_counts = _recv(r, R, cap, local)
    me = R // 2
    recv_counts[me] = 0
    self_mask = r.random(n) < 0.6
    want = jax.jit(functools.partial(jpack.compact_with_self,
                                     out_capacity=out_cap))(
        tuple(map(jnp.asarray, recv)), jnp.asarray(recv_counts),
        tuple(map(jnp.asarray, local)), jnp.asarray(self_mask),
        jnp.int32(me))
    got = tpack.compact_with_self(
        tuple(map(torch.from_numpy, recv)), torch.from_numpy(recv_counts),
        tuple(map(torch.from_numpy, local)), torch.from_numpy(self_mask), me,
        out_cap)
    for g, w in zip(got[0], want[0]):
        _same(g, w)
    _same(got[1], want[1])
    _same(got[2], want[2])


@pytest.mark.parametrize("R,cap,out_cap", [(8, 30, 100), (3, 7, 64)])
def test_compact_received_matches_jax(R, cap, out_cap):
    r = np.random.default_rng(R + cap)
    recv, recv_counts = _recv(r, R, cap, _payload(r, 1))
    want = jax.jit(functools.partial(jpack.compact_received,
                                     out_capacity=out_cap))(
        tuple(map(jnp.asarray, recv)), jnp.asarray(recv_counts))
    got = tpack.compact_received(
        tuple(map(torch.from_numpy, recv)), torch.from_numpy(recv_counts),
        out_cap)
    for g, w in zip(got[0], want[0]):
        _same(g, w)
    _same(got[1], want[1])
    _same(got[2], want[2])


def _planar_pool(r, K, m, n_sources):
    values = r.integers(-2**31, 2**31 - 1, (K, m)).astype(np.int32)
    invalid = r.random(m) < 0.3
    source_key = r.integers(0, n_sources, m).astype(np.int32)
    return values, invalid, source_key


@pytest.mark.parametrize("n_sources,m,out_cap", [
    (8, 3000, 2500),        # packed single key
    (8, 3000, 4000),        # packed, pool smaller than the output
    (1 << 20, 4096, 3000),  # n_sources + 1 > 2^(31 - 12): the two-key sort
    (1 << 19, 4096, 5000),  # ... at the boundary, padded output
])
def test_planar_compact_keys_both_branches_match_jax(n_sources, m, out_cap):
    bM = (m - 1).bit_length()
    packed = n_sources + 1 <= (1 << (31 - bM))
    assert packed == (n_sources == 8)
    r = np.random.default_rng(n_sources + m)
    values, invalid, source_key = _planar_pool(r, 5, m, n_sources)
    new_full = np.int32((~invalid).sum())
    want = jax.jit(functools.partial(
        jpack.planar_compact_keys, n_sources=n_sources,
        out_capacity=out_cap))(
        jnp.asarray(values), jnp.asarray(invalid), jnp.asarray(source_key),
        new_full=jnp.asarray(new_full))
    got = tpack.planar_compact_keys(
        torch.from_numpy(values), torch.from_numpy(invalid),
        torch.from_numpy(source_key), n_sources, torch.tensor(new_full),
        out_cap)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("R,C,n,out_cap", [(8, 16, 300, 350), (5, 9, 40, 20)])
def test_planar_compact_with_self_matches_jax(R, C, n, out_cap):
    r = np.random.default_rng(R * C)
    pool = r.integers(-2**31, 2**31 - 1, (4, R * C)).astype(np.int32)
    local = r.integers(-2**31, 2**31 - 1, (4, n)).astype(np.int32)
    recv_counts = r.integers(0, C + 1, R).astype(np.int32)
    me = 1
    recv_counts[me] = 0
    self_mask = r.random(n) < 0.5
    want = jax.jit(functools.partial(jpack.planar_compact_with_self,
                                     out_capacity=out_cap))(
        jnp.asarray(pool), jnp.asarray(recv_counts), jnp.int32(me),
        jnp.asarray(self_mask), jnp.asarray(local))
    got = tpack.planar_compact_with_self(
        torch.from_numpy(pool), torch.from_numpy(recv_counts), me,
        torch.from_numpy(self_mask), torch.from_numpy(local), out_cap)
    for g, w in zip(got, want):
        _same(g, w)


def test_pool_source_keys_match_jax():
    r = np.random.default_rng(9)
    recv_counts = r.integers(0, 6, 4).astype(np.int32)
    self_mask = r.random(11) < 0.5
    want = jpack.pool_source_keys(jnp.asarray(recv_counts),
                                  jnp.asarray(self_mask), jnp.int32(2), 5)
    got = tpack.pool_source_keys(torch.from_numpy(recv_counts),
                                 torch.from_numpy(self_mask), 2, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_dest,C,n", [(8, 20, 500), (3, 64, 100)])
def test_pack_cols_matches_jax(n_dest, C, n):
    r = np.random.default_rng(n_dest * C)
    fused = r.integers(-2**31, 2**31 - 1, (6, n)).astype(np.int32)
    dest = _dest(r, n, n_dest)
    order = np.argsort(dest, kind="stable").astype(np.int32)
    counts = np.bincount(dest, minlength=n_dest + 1)[:n_dest]
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    send_counts = np.minimum(counts, C).astype(np.int32)
    want = jax.jit(functools.partial(jpack.pack_cols, n_dest=n_dest,
                                     capacity=C))(
        jnp.asarray(fused), jnp.asarray(order), jnp.asarray(bounds[:n_dest]),
        jnp.asarray(send_counts))
    got = tpack.pack_cols(
        torch.from_numpy(fused), torch.from_numpy(order),
        torch.from_numpy(bounds[:n_dest]), torch.from_numpy(send_counts),
        n_dest, C)
    _same(got[0], want[0])
    valid = np.asarray(want[0]).any(axis=0) | True
    np.testing.assert_array_equal(got[1].numpy()[valid],
                                  np.asarray(want[1])[valid])


def test_batched_calls_equal_a_loop_of_single_ones():
    """The vrank engines call these with a leading batch dimension."""
    r = np.random.default_rng(77)
    V, R, C, n, out_cap = 4, 4, 12, 90, 80
    pool = torch.from_numpy(
        r.integers(-2**31, 2**31 - 1, (V, 3, R * C)).astype(np.int32))
    local = torch.from_numpy(
        r.integers(-2**31, 2**31 - 1, (V, 3, n)).astype(np.int32))
    rc = torch.from_numpy(r.integers(0, C + 1, (V, R)).astype(np.int32))
    mask = torch.from_numpy(r.random((V, n)) < 0.5)
    me = torch.arange(V, dtype=torch.int32)
    got = tpack.planar_compact_with_self(pool, rc, me, mask, local, out_cap)
    for v in range(V):
        one = tpack.planar_compact_with_self(pool[v], rc[v], v, mask[v],
                                             local[v], out_cap)
        for g, o in zip(got, one):
            assert torch.equal(g[v], o)
    rows = torch.from_numpy(r.standard_normal((V, n, 3)).astype(np.float32))
    recv = torch.from_numpy(
        r.standard_normal((V, R, C, 3)).astype(np.float32))
    got = tpack.compact_with_self((recv,), rc, (rows,), mask, me, out_cap)
    for v in range(V):
        one = tpack.compact_with_self((recv[v],), rc[v], (rows[v],), mask[v],
                                      v, out_cap)
        assert torch.equal(got[0][0][v], one[0][0])
        assert torch.equal(got[1][v], one[1]) and torch.equal(got[2][v],
                                                              one[2])
