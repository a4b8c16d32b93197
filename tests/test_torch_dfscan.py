"""Port double-float tile scan (mpi_grid_redistribute_tpu_torch.ops.dfscan)
vs the JAX package: ``tile_df_cumsum_rows_plain`` against the Pallas
kernel ``pallas_dfscan.tile_df_cumsum_rows`` in interpret mode and
against jitted ``deposit._df_cumsum(x, axis=1)``.

The contract is BIT equality of both the hi and the lo words: the kernel
runs the same TwoSum sequence in the same Hillis-Steele order, adds and
subtracts only, so there is no tolerance to state.

Denormals: XLA on the CPU flushes float32 denormals to zero (so does the
TPU); PyTorch does not. On denormal inputs the torch side therefore runs
with ``torch.set_flush_denormal(True)`` (the ``ftz`` fixture), restored
afterwards. On the card the kernel and its plain version both follow
IEEE, and ``tests/test_torch_cuda.py`` holds them bit-equal there."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mpi_grid_redistribute_tpu.ops import deposit as jdeposit
from mpi_grid_redistribute_tpu.ops import pallas_dfscan
from mpi_grid_redistribute_tpu_torch.ops import deposit as tdeposit
from mpi_grid_redistribute_tpu_torch.ops import dfscan

torch.set_num_threads(1)


def _assert_bits(got, want):
    got = np.ascontiguousarray(got.numpy())
    want = np.ascontiguousarray(np.asarray(want))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _jax_df_cumsum(x):
    return jax.jit(functools.partial(jdeposit._df_cumsum, axis=1))(x)


def _check(x, interpret=True):
    hi, lo = dfscan.tile_df_cumsum_rows_plain(torch.from_numpy(x))
    for want in ([pallas_dfscan.tile_df_cumsum_rows(
            jnp.asarray(x), interpret=True)] if interpret else []) + [
            _jax_df_cumsum(jnp.asarray(x))]:
        _assert_bits(hi, want[0])
        _assert_bits(lo, want[1])


@pytest.fixture
def ftz():
    if not torch.set_flush_denormal(True):
        pytest.skip("this CPU cannot flush denormals")
    yield
    torch.set_flush_denormal(False)


@pytest.mark.parametrize("rows,tile", [
    (100, 256), (256, 128), (300, 512), (1025, 64),
])
def test_plain_matches_jax_kernel_and_xla_bits(rows, tile):
    r = np.random.default_rng(rows * 1000 + tile)
    _check(r.standard_normal((rows, tile)).astype(np.float32))


def test_plain_matches_xla_on_a_non_power_of_two_tile():
    # the TPU kernel takes powers of two only; the port takes any tile
    r = np.random.default_rng(12)
    _check(r.standard_normal((37, 100)).astype(np.float32), interpret=False)


def test_plain_matches_jax_on_hostile_magnitudes():
    """Mixed huge/tiny magnitudes and signs, exact zeros mid-stream
    (the reference's own hostile case)."""
    r = np.random.default_rng(77)
    mags = r.choice([1e-30, 1e-8, 1.0, 1e8, 1e30], size=(64, 256))
    x = (r.standard_normal((64, 256)) * mags).astype(np.float32)
    x[3, :8] = 0.0
    _check(x)


def test_plain_matches_jax_on_denormals(ftz):
    r = np.random.default_rng(5)
    mags = r.choice([1e-38, 1e-42, 1e-44], size=(64, 256))
    x = (r.standard_normal((64, 256)) * mags).astype(np.float32)
    _check(x)


def test_entry_runs_plain_on_cpu_and_checks_type():
    x = torch.from_numpy(
        np.random.default_rng(3).standard_normal((9, 32)).astype(np.float32)
    )
    before = dfscan.KERNEL.launches
    hi, lo = dfscan.tile_df_cumsum_rows(x)
    hp, lp = dfscan.tile_df_cumsum_rows_plain(x)
    assert dfscan.KERNEL.launches == before  # CPU: no launch
    assert torch.equal(hi, hp) and torch.equal(lo, lp)
    with pytest.raises(TypeError):
        dfscan.tile_df_cumsum_rows(x.double())


def test_prefix_is_inclusive_to_double_float_accuracy():
    r = np.random.default_rng(5)
    x = r.standard_normal((32, 256)).astype(np.float32)
    hi, lo = dfscan.tile_df_cumsum_rows(torch.from_numpy(x))
    total = hi[:, -1].double() + lo[:, -1].double()
    np.testing.assert_allclose(
        total.numpy(), x.astype(np.float64).sum(axis=1), rtol=1e-12,
        atol=1e-10,
    )


@pytest.mark.parametrize("axis", [0, 1])
def test_df_cumsum_with_lo_input_matches_jax(axis):
    """The level-2 scan over tile totals: (hi, lo) pairs in, along either
    axis."""
    r = np.random.default_rng(8 + axis)
    x = r.standard_normal((24, 40)).astype(np.float32)
    x_lo = (r.standard_normal((24, 40)) * 1e-9).astype(np.float32)
    got = tdeposit._df_cumsum(torch.from_numpy(x), axis=axis,
                              x_lo=torch.from_numpy(x_lo))
    want = jax.jit(functools.partial(jdeposit._df_cumsum, axis=axis))(
        jnp.asarray(x), x_lo=jnp.asarray(x_lo)
    )
    _assert_bits(got[0], want[0])
    _assert_bits(got[1], want[1])
    a, b = r.standard_normal((2, 500)).astype(np.float32)
    got = tdeposit._two_sum(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, jax.jit(jdeposit._two_sum)(a, b)):
        _assert_bits(g, w)
