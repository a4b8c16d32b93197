"""Port segmented CIC deposit (mpi_grid_redistribute_tpu_torch.ops.segdep)
vs the JAX package: ``segsum_sorted_plain`` against the Pallas kernel
``pallas_segdep.segsum_sorted`` in interpret mode and against its XLA
twin ``_segsum_xla``.

Tolerances, and why:
  * DYADIC data (``rel`` in multiples of 1/4, mass in {1/2, 1, 2}): every
    corner weight is a short binary fraction and every partial sum stays
    exact in float32, so any summation order gives the same bits --
    BIT-exact against both JAX engines;
  * generic floats: the summation order differs between engines (matrix
    tree on the TPU kernel, scatter-add, ``index_add_``), so each is held
    within ``rtol = atol = 2e-5`` of a float64 ``np.add.at`` oracle (the
    deposit engines' float64-oracle tolerance) and within ``1e-6`` of
    the JAX result (float32 summation noise at these sizes);
  * the corner-weight CHANNELS themselves share one definition
    (``_corner_weights``), so they are bit-equal on any data."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mpi_grid_redistribute_tpu.ops import pallas_segdep as jseg
from mpi_grid_redistribute_tpu_torch.ops import segdep

torch.set_num_threads(1)


def _bits(got, want):
    got = np.ascontiguousarray(got.numpy())
    want = np.ascontiguousarray(np.asarray(want))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _port(keys, rel, mass, n_cells, vblock):
    return segdep.segsum_sorted_plain(
        torch.from_numpy(keys), torch.from_numpy(rel),
        None if mass is None else torch.from_numpy(mass), n_cells, vblock,
    )


def _jax_both(keys, rel, mass, n_cells, vblock):
    """(Pallas kernel in interpret mode, XLA segment_sum twin)."""
    d = rel.shape[0]
    m = None if mass is None else jnp.asarray(mass)
    kern = jseg.segsum_sorted(jnp.asarray(keys), jnp.asarray(rel), m,
                              n_cells, vblock, interpret=True)
    xla = jax.jit(
        lambda k, r: jseg._segsum_xla(k, r, m, n_cells, tuple(vblock), d)
    )(jnp.asarray(keys), jnp.asarray(rel))
    return np.asarray(kern), np.asarray(xla)


def _oracle(keys, rel, mass, n_cells, vblock):
    d = rel.shape[0]
    w64 = np.asarray(
        jseg._corner_weights([jnp.asarray(rel[dd]) for dd in range(d)],
                             None if mass is None else jnp.asarray(mass),
                             vblock),
        np.float64,
    )
    out = np.zeros((2**d, n_cells + 1))
    seg = np.clip(keys, 0, n_cells)
    for ch in range(2**d):
        np.add.at(out[ch], seg, w64[ch])
    return out[:, :n_cells]


def _clustered_keys(r, n, n_cells, density, valid_frac=0.9):
    """Keys clustered into a fraction of the cells (blocks then span many
    empty cells), invalid rows as the sentinel tail."""
    hot = max(1, int(n_cells * density))
    cells = r.choice(n_cells, size=hot, replace=False)
    key = cells[r.integers(0, hot, size=n)]
    valid = r.random(n) < valid_frac
    return np.sort(np.where(valid, key, n_cells)).astype(np.int32)


def _slab_keys(r, vblock):
    """Concatenated per-slab sorts (vrank-major keys, sentinels at each
    slab's tail, so sentinel runs sit mid-stream)."""
    V = 4
    C = int(np.prod(vblock))
    keys = []
    for v, (sn, vf) in enumerate(zip([6144, 3000, 4096, 500],
                                     [0.03, 0.8, 0.5, 1.0])):
        k = np.where(r.random(sn) < vf, v * C + r.integers(0, C, sn), V * C)
        keys.append(np.sort(k.astype(np.int32)))
    return np.concatenate(keys), V * C


def _stream(kind, seed, vblock):
    r = np.random.default_rng(seed)
    n_cells = int(np.prod(vblock))
    if kind == "dense":
        n = 10_000
        keys = _clustered_keys(r, n, n_cells, 1.0)
    elif kind == "sparse":
        n = 9_000
        keys = _clustered_keys(r, n, n_cells, 0.05)
    elif kind == "sentinel":
        n = 4096
        keys = np.full(n, n_cells, np.int32)
    elif kind == "short":
        n = 100
        keys = _clustered_keys(r, n, n_cells, 1.0)
    else:  # slabs
        keys, n_cells = _slab_keys(r, vblock)
        n = keys.shape[0]
    return r, keys, n, n_cells


KINDS = ["dense", "sparse", "sentinel", "short", "slabs"]


@pytest.mark.parametrize("with_mass", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_bit_equal_to_jax_on_dyadic_data(kind, with_mass):
    vblock = (8, 8, 8)
    r, keys, n, n_cells = _stream(kind, KINDS.index(kind), vblock)
    rel = (r.integers(0, 32, size=(3, n)) * 0.25).astype(np.float32)
    mass = (r.choice(np.float32([0.5, 1.0, 2.0]), n).astype(np.float32)
            if with_mass else None)
    got = _port(keys, rel, mass, n_cells, vblock)
    kern, xla = _jax_both(keys, rel, mass, n_cells, vblock)
    assert got.shape == (8, n_cells)
    _bits(got, kern)
    _bits(got, xla)


@pytest.mark.parametrize("n,n_cells,d,vblock", [
    (2048, 256, 2, (8, 8)),
    (6000, 512, 2, (8, 8)),
    (3000, 200, 3, (4, 4, 4)),
])
def test_plain_bit_equal_on_reference_dyadic_shapes(n, n_cells, d, vblock):
    """The shapes of the reference's own dyadic test (1- and 2-D canvas
    spans, an odd cell count, a sentinel tail)."""
    r = np.random.default_rng(n + d)
    keys = np.concatenate([
        np.sort(r.integers(0, n_cells, size=n - n // 20)),
        np.full(n // 20, n_cells),
    ]).astype(np.int32)
    rel = (r.integers(0, 32, size=(d, n)) * 0.25).astype(np.float32)
    got = _port(keys, rel, None, n_cells, vblock)
    kern, xla = _jax_both(keys, rel, None, n_cells, vblock)
    _bits(got, kern)
    _bits(got, xla)


@pytest.mark.parametrize("with_mass", [False, True])
@pytest.mark.parametrize("kind", ["dense", "sparse", "slabs"])
def test_plain_within_tolerance_on_generic_floats(kind, with_mass):
    vblock = (8, 8, 8) if kind != "sparse" else (16, 16, 16)
    r, keys, n, n_cells = _stream(kind, 50 + KINDS.index(kind), vblock)
    rel = (r.random((3, n)) * vblock[0]).astype(np.float32)
    mass = r.random(n).astype(np.float32) if with_mass else None
    got = _port(keys, rel, mass, n_cells, vblock).numpy()
    kern, xla = _jax_both(keys, rel, mass, n_cells, vblock)
    np.testing.assert_allclose(
        got, _oracle(keys, rel, mass, n_cells, vblock), rtol=2e-5, atol=2e-5
    )
    np.testing.assert_allclose(got, kern, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, xla, rtol=1e-6, atol=1e-6)


def test_corner_weights_bit_equal():
    r = np.random.default_rng(4)
    rel = (r.random((3, 1000)) * 9 - 0.5).astype(np.float32)  # off-block too
    mass = r.random(1000).astype(np.float32)
    for m in (None, mass):
        got = segdep._corner_weights(
            [torch.from_numpy(rel[d]) for d in range(3)],
            None if m is None else torch.from_numpy(m), (8, 8, 8),
        )
        want = jax.jit(lambda x, mm: jseg._corner_weights(
            [x[d] for d in range(3)], mm, (8, 8, 8)
        ))(rel, m)
        _bits(got, want)


def test_n_cells_bound_and_types_raise():
    keys = torch.zeros(4, dtype=torch.int32)
    rel = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="2\\*\\*27"):
        segdep.segsum_sorted(keys, rel, None, 2**27 + 1, (8, 8, 8))
    with pytest.raises(TypeError):
        segdep.segsum_sorted(keys.long(), rel, None, 16, (8, 8, 8))
    with pytest.raises(TypeError):
        segdep.segsum_sorted(keys, rel, torch.zeros(5), 16, (8, 8, 8))
    before = segdep.KERNEL.launches
    segdep.segsum_sorted(keys, rel, None, 16, (8, 8, 8))
    assert segdep.KERNEL.launches == before  # CPU runs the plain version
