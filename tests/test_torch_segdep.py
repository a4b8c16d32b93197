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

import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mpi_grid_redistribute_tpu.ops import pallas_segdep as jseg
from mpi_grid_redistribute_tpu_torch.bench import common
from mpi_grid_redistribute_tpu_torch.ops import deposit as tdeposit
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


@pytest.mark.parametrize("n,d,want", [
    (8 * 2**20, 3, (4096, 16)),  # the config-5 slab stream
    (1, 3, (1, 16)),
    (segdep.TILE - 1, 2, (1, 8)),
    (segdep.TILE, 1, (1, 4)),
    (segdep.TILE + 1, 3, (2, 16)),
    (0, 3, (0, 16)),
])
def test_kernel_geometry(n, d, want):
    """One block per TILE rows, and the floats of a tile's carry record
    (its last run's total and its first run's sum, 2^D channels each)."""
    assert segdep.geometry(n, d) == want


@pytest.mark.parametrize("n,d", [(-1, 3), (16, 0), (16, 4)])
def test_kernel_geometry_refuses(n, d):
    with pytest.raises(ValueError):
        segdep.geometry(n, d)


EDGE_STREAMS = ["run_spans_tiles", "runs_end_at_tile_ends",
                "sentinel_tile_between_slabs", "all_sentinel",
                "empty_canvas_ends"]


@pytest.mark.parametrize("with_mass", [False, True])
@pytest.mark.parametrize("stream", EDGE_STREAMS)
def test_plain_bit_equal_to_jax_on_tile_edge_streams(stream, with_mass):
    """The streams that put runs across the kernel's tile edges (a cell
    over three tiles, boundaries on tile ends, a whole tile of sentinels
    between two slabs, no valid row, empty canvas ends): the plain version
    bit-equal to both JAX engines on dyadic data."""
    r = np.random.default_rng(EDGE_STREAMS.index(stream) + 10 * with_mass)
    keys, n_cells = common.segdep_edge_streams(segdep.TILE, r)[stream]
    n = keys.shape[0]
    vblock = (8, 8, 8)
    rel = (r.integers(0, 32, size=(3, n)) * 0.25).astype(np.float32)
    mass = (r.choice(np.float32([0.5, 1.0, 2.0]), n).astype(np.float32)
            if with_mass else None)
    got = _port(keys, rel, mass, n_cells, vblock)
    kern, xla = _jax_both(keys, rel, mass, n_cells, vblock)
    _bits(got, kern)
    _bits(got, xla)
    valid = keys < n_cells
    assert got.numpy().sum() == pytest.approx(
        valid.sum() if mass is None else mass[valid].sum(), rel=1e-6
    )


def test_edge_streams_are_monotone_and_hit_tile_edges():
    """Each edge stream keeps its valid keys non-decreasing, and the
    features they are named for are where the kernel's tiles put them."""
    t = segdep.TILE
    s = common.segdep_edge_streams(t, np.random.default_rng(0))
    for keys, n_cells in s.values():
        ok = keys[keys < n_cells]
        assert (np.diff(ok) >= 0).all()
    keys, _ = s["run_spans_tiles"]
    first, last = np.flatnonzero(keys == 30)[[0, -1]]
    assert last // t - first // t >= 3
    keys, n_cells = s["runs_end_at_tile_ends"]
    breaks = np.flatnonzero(np.diff(keys)) + 1
    assert {t, 2 * t, 3 * t, 5 * t, 6 * t} <= set(breaks.tolist())
    keys, n_cells = s["sentinel_tile_between_slabs"]
    tiles = keys[: len(keys) // t * t].reshape(-1, t)
    assert (tiles == n_cells).all(axis=1).any()
    keys, n_cells = s["empty_canvas_ends"]
    ok = keys[keys < n_cells]
    assert ok.min() > 0 and ok.max() < n_cells - 1
    assert (s["all_sentinel"][0] == s["all_sentinel"][1]).all()


def test_negative_keys_clamp_into_cell_0_as_in_the_reference():
    """Negative keys are outside the contract (no caller passes one). The
    reference's XLA fallback clamps them into cell 0, and so does the
    plain version; the kernel drops them (ROADMAP.md C4,
    tests/test_torch_cuda.py pins the kernel's side)."""
    keys = np.array([-3, -1, 0, 0, 2, 5], np.int32)
    rel = np.full((1, 6), 0.25, np.float32)
    got = _port(keys, rel, None, 4, (4,))
    kern, xla = _jax_both(keys, rel, None, 4, (4,))
    _bits(got, xla)
    assert got[:, 0].tolist() == [3.0, 1.0]  # 4 rows: 2 negative, 2 key 0


def _recording_segsum(monkeypatch):
    seen = []
    orig = tdeposit._segsum

    def wrapped(plain):
        fn = orig(plain)

        def rec(keys, rel, mass, n_cells, vblock):
            seen.append((keys.clone(), n_cells))
            return fn(keys, rel, mass, n_cells, vblock)

        return rec

    monkeypatch.setattr(tdeposit, "_segsum", wrapped)
    return seen


@pytest.mark.parametrize("caller", ["device_sort", "slab_sorts"])
def test_callers_pass_non_decreasing_valid_keys(monkeypatch, caller):
    """Both callers of segsum_sorted (the whole-stream sort of
    cic_deposit_device_mxu and the per-slab sorts of
    _slab_deposit_from_keys) hand it streams whose valid keys never
    decrease, the kernel's contract; sentinels sit at the slab tails."""
    seen = _recording_segsum(monkeypatch)
    r = np.random.default_rng(5)
    V, n = 8, 3000
    vgrid_shape, vblock = (2, 2, 2), (8, 8, 8)
    cells = np.asarray(list(itertools.product(range(2), repeat=3)),
                       np.float32)
    pos = ((cells[:, :, None] + r.random((V, 3, n), dtype=np.float32))
           / 2).astype(np.float32).transpose(1, 0, 2).reshape(3, V * n)
    valid = torch.from_numpy(r.random(V * n) < 0.9)
    inv_h = torch.full((3,), 16.0)
    if caller == "device_sort":
        tdeposit.cic_deposit_device_mxu(
            torch.from_numpy(pos), None, valid, torch.zeros(3), inv_h,
            (16, 16, 16),
        )
    else:
        tdeposit.cic_deposit_vranks_mxu(
            torch.from_numpy(pos), None, valid,
            torch.from_numpy(cells / 2), inv_h, vblock, vgrid_shape,
        )
    assert len(seen) == 1
    keys, n_cells = seen[0]
    ok = keys[(keys >= 0) & (keys < n_cells)]
    assert ok.numel() == int(valid.sum())
    assert bool((ok[1:] >= ok[:-1]).all())
    assert bool((keys >= 0).all())
    if caller == "slab_sorts":  # a sentinel run at each slab's tail
        slabs = keys.reshape(V, n)
        assert bool((slabs[:, -1] == n_cells).all())


@pytest.mark.parametrize("keys", [
    [0, 2, 1, 3],  # one descent between valid rows
    [4, 6, 6, 5],  # the descent is the last row
    [3, 8, 8, 2],  # a descent hidden behind sentinel rows (n_cells = 8)
    [5, -1, 4, 7],  # and behind a negative key
])
def test_debug_check_refuses_decreasing_valid_keys(monkeypatch, keys):
    """With ``MPI_GRID_SEGDEP_DEBUG=1`` a stream whose valid keys decrease
    raises, naming the descent; without it the call goes through (the
    plain version does not need the contract, the kernel does)."""
    k = torch.tensor(keys, dtype=torch.int32)
    rel = torch.full((1, len(keys)), 0.25)
    segdep.segsum_sorted(k, rel, None, 8, (4,))
    monkeypatch.setenv("MPI_GRID_SEGDEP_DEBUG", "1")
    with pytest.raises(ValueError, match="decrease 1 time"):
        segdep.segsum_sorted(k, rel, None, 8, (4,))


@pytest.mark.parametrize("stream", EDGE_STREAMS)
def test_debug_check_passes_contract_streams(monkeypatch, stream):
    """The tile-edge streams meet the contract (sentinels anywhere, valid
    keys non-decreasing): the debug check lets them through and changes
    nothing."""
    r = np.random.default_rng(EDGE_STREAMS.index(stream))
    keys, n_cells = common.segdep_edge_streams(segdep.TILE, r)[stream]
    rel = (r.integers(0, 32, size=(2, keys.shape[0])) * 0.25).astype(
        np.float32)
    args = (torch.from_numpy(keys), torch.from_numpy(rel), None, n_cells,
            (8, 8))
    want = segdep.segsum_sorted(*args).numpy()
    monkeypatch.setenv("MPI_GRID_SEGDEP_DEBUG", "1")
    _bits(segdep.segsum_sorted(*args), want)
