"""Port landing scatter (mpi_grid_redistribute_tpu_torch.ops.overlay) vs
the JAX package's ops/pallas_overlay.py in interpret mode, bit level
(uint32 views): every encoding, int32 and float32 state with NaN bit
patterns, drop sentinels, empty updates, and the two raises (duplicate
targets under the debug check, unknown encoding)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from mpi_grid_redistribute_tpu.ops import pallas_overlay
from mpi_grid_redistribute_tpu_torch.ops import overlay

# the inputs are small: one intra-op thread is as fast here and keeps
# these tests from competing for cores with the other test workers
torch.set_num_threads(1)

W, RMAX = 256, 128


def _jax(flat, targets, cols, encoding="int8"):
    out = pallas_overlay.overlay_scatter_planar(
        jnp.asarray(flat), jnp.asarray(targets), jnp.asarray(cols),
        interpret=True, w=W, rmax=RMAX, encoding=encoding,
    )
    return np.asarray(out)


def _port(flat, targets, cols, **kw):
    out = overlay.overlay_scatter_planar(
        torch.from_numpy(flat.copy()), torch.from_numpy(targets),
        torch.from_numpy(cols), **kw,
    )
    return out.numpy()


def _state(r, k, m, p, dtype):
    if dtype is np.int32:
        flat = r.integers(-(2**31), 2**31 - 1, size=(k, m), dtype=np.int32)
        cols = r.integers(-(2**31), 2**31 - 1, size=(k, p), dtype=np.int32)
    else:
        flat = r.standard_normal((k, m)).astype(np.float32)
        cols = r.standard_normal((k, p)).astype(np.float32)
        # NaN-looking bit patterns (bitcast int32 payloads) in one row
        cols[3] = r.integers(
            -(2**31), 2**31 - 1, size=p, dtype=np.int32
        ).view(np.float32)
        flat[3] = r.integers(
            -(2**31), 2**31 - 1, size=m, dtype=np.int32
        ).view(np.float32)
    return flat, cols


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("encoding", ["quarter", "half", "int8"])
def test_plain_matches_interpret_kernel(seed, dtype, encoding):
    r = np.random.default_rng(seed)
    k, m, p = 7, 4 * W, 37
    targets = r.choice(m, size=p, replace=False).astype(np.int32)
    flat, cols = _state(r, k, m, p, dtype)
    want = _jax(flat, targets, cols, encoding)
    got = _port(flat, targets, cols, encoding=encoding)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_drop_sentinels_and_empty(dtype):
    r = np.random.default_rng(7)
    k, m = 7, 2 * W
    flat, cols = _state(r, k, m, 6, dtype)
    # mixed: valid, at and beyond m, negative
    targets = np.array([0, 5, m, m + 3, -1, 511], np.int32)
    want = _jax(flat, targets, cols)
    got = _port(flat, targets, cols)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # all dropped -> pass-through
    targets = np.full((6,), m, np.int32)
    got = _port(flat, targets, cols)
    np.testing.assert_array_equal(got.view(np.uint32), flat.view(np.uint32))
    np.testing.assert_array_equal(
        _jax(flat, targets, cols).view(np.uint32), flat.view(np.uint32)
    )
    # no updates at all
    got = _port(flat, np.zeros((0,), np.int32), cols[:, :0])
    np.testing.assert_array_equal(got.view(np.uint32), flat.view(np.uint32))


def test_every_column_updated():
    r = np.random.default_rng(3)
    k, m = 5, 2 * W
    flat, cols = _state(r, k, m, m, np.float32)
    targets = r.permutation(m).astype(np.int32)
    want = _jax(flat, targets, cols)
    got = _port(flat, targets, cols)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_duplicate_targets_raise_under_debug(monkeypatch):
    r = np.random.default_rng(11)
    k, m = 7, 2 * W
    flat, cols = _state(r, k, m, 4, np.float32)
    dup = np.array([3, 17, 17, 200], np.int32)
    monkeypatch.setenv("MPI_GRID_OVERLAY_DEBUG", "1")
    with pytest.raises(ValueError, match="duplicate in-range"):
        _port(flat, dup, cols)
    # repeated drop sentinels stay legal, and the result is exact
    ok = np.array([3, 17, m, m], np.int32)
    got = _port(flat, ok, cols)
    want = _jax(flat, ok, cols)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_unknown_encoding_raises(monkeypatch):
    r = np.random.default_rng(0)
    flat, cols = _state(r, 7, W, 8, np.float32)
    targets = np.arange(8, dtype=np.int32)
    with pytest.raises(ValueError, match="encoding"):
        _port(flat, targets, cols, encoding="byte")
    monkeypatch.setenv("MPI_GRID_OVERLAY_ENC", "bytes")
    with pytest.raises(ValueError, match="encoding"):
        _port(flat, targets, cols)


def test_wrapper_validates_and_counts_no_cpu_launch():
    r = np.random.default_rng(2)
    flat, cols = _state(r, 7, W, 8, np.int32)
    targets = np.arange(8, dtype=np.int32)
    before = overlay.KERNEL.launches
    _port(flat, targets, cols)
    assert overlay.KERNEL.launches == before
    with pytest.raises(TypeError):
        _port(flat, targets.astype(np.int64), cols)
    with pytest.raises(TypeError):
        _port(flat, targets, cols[:, :4])
