"""Port drift-bin (mpi_grid_redistribute_tpu_torch.ops.driftbin) vs the
JAX package's ops/pallas_driftbin.py, bit level: the plain PyTorch
version against the jitted XLA twin and against the Pallas kernel in
interpret mode, including hostile inputs on open axes (+-inf, NaN,
1e10), non-power-of-two periodic extents and dead rows.

dt is 1.0 or 0.0625 wherever positions drift: a jitted JAX function on
the CPU contracts ``p + v*dt`` into one fused multiply-add while the
port (like the TPU) rounds the product first. With a power-of-two dt the
product is exact and both conventions give the same bits; at dt = 0.05
thousands of random drifts differ by an ulp, enough to re-home a
particle."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mpi_grid_redistribute_tpu import domain as jdomain
from mpi_grid_redistribute_tpu.ops import pallas_driftbin
from mpi_grid_redistribute_tpu_torch import domain as tdomain
from mpi_grid_redistribute_tpu_torch.ops import driftbin

# the inputs are small: one intra-op thread is as fast here and keeps
# these tests from competing for cores with the other test workers
torch.set_num_threads(1)

DTS = [1.0, 0.0625]


def _mk_state(r, V, n, scale=1.0):
    m = V * n
    pos = ((r.random((3, m), dtype=np.float32) * 2 - 0.5) * scale).astype(
        np.float32
    )
    vel = (r.random((3, m), dtype=np.float32) - 0.5).astype(np.float32)
    alive = (r.random((m,)) < 0.9).astype(np.int32)
    return np.concatenate(
        [pos.view(np.int32), vel.view(np.int32), alive[None, :]], axis=0
    )


def _domains(lo, hi, periodic):
    return (jdomain.Domain(lo, hi, periodic=periodic),
            tdomain.Domain(lo, hi, periodic=periodic))


def _jax_twin(flat, dt, jd, jg, V):
    f, k = jax.jit(
        lambda a: pallas_driftbin.drift_wrap_bin_xla(a, dt, jd, jg, V, V)
    )(jnp.asarray(flat))
    return np.asarray(f), np.asarray(k)


def _port_plain(flat, dt, td, tg, V):
    f, k = driftbin.drift_wrap_bin_plain(
        torch.from_numpy(flat.copy()), dt, td, tg, V, V
    )
    return f.numpy(), k.numpy()


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("scale", [1.0, 50.0])
@pytest.mark.parametrize("grid_shape", [(2, 2, 2), (4, 2, 1)])
def test_plain_matches_xla_twin_and_interpret_kernel(grid_shape, scale, dt):
    V, n = int(np.prod(grid_shape)), 2048
    jd, td = _domains(0.0, 1.0, True)
    jg, tg = jdomain.ProcessGrid(grid_shape), tdomain.ProcessGrid(grid_shape)
    r = np.random.default_rng(int(scale) * 7 + V)
    flat = _mk_state(r, V, n, scale=scale)
    f_t, k_t = _port_plain(flat, dt, td, tg, V)
    f_x, k_x = _jax_twin(flat, dt, jd, jg, V)
    np.testing.assert_array_equal(f_t.view(np.uint32), f_x.view(np.uint32))
    np.testing.assert_array_equal(k_t, k_x)
    f_p, k_p = pallas_driftbin.drift_wrap_bin(
        jnp.asarray(flat), dt, jd, jg, V, V, interpret=True, w=1024,
    )
    np.testing.assert_array_equal(
        f_t.view(np.uint32), np.asarray(f_p).view(np.uint32)
    )
    np.testing.assert_array_equal(k_t, np.asarray(k_p))


@pytest.mark.parametrize("dt", DTS)
def test_mixed_periodic_and_open_domain(dt):
    V, n = 4, 1024
    args = ((0.0, -2.0, 1.0), (1.0, 2.0, 3.0), (True, False, True))
    jd, td = _domains(*args)
    jg, tg = jdomain.ProcessGrid((2, 2, 1)), tdomain.ProcessGrid((2, 2, 1))
    flat = _mk_state(np.random.default_rng(5), V, n, scale=3.0)
    f_t, k_t = _port_plain(flat, dt, td, tg, V)
    f_x, k_x = _jax_twin(flat, dt, jd, jg, V)
    np.testing.assert_array_equal(f_t.view(np.uint32), f_x.view(np.uint32))
    np.testing.assert_array_equal(k_t, k_x)
    f_p, k_p = pallas_driftbin.drift_wrap_bin(
        jnp.asarray(flat), dt, jd, jg, V, V, interpret=True, w=1024,
    )
    np.testing.assert_array_equal(
        f_t.view(np.uint32), np.asarray(f_p).view(np.uint32)
    )
    np.testing.assert_array_equal(k_t, np.asarray(k_p))


@pytest.mark.parametrize("dt", DTS)
def test_hostile_values_on_open_axis(dt):
    """+-inf, NaN and 1e10 on an open axis: the float -> int conversion
    must saturate like XLA's (a huge or +inf coordinate bins into the
    last cell, NaN into cell 0), not wrap to INT_MIN."""
    V, n = 4, 1024
    args = ((0.0, -2.0, 1.0), (1.0, 2.0, 3.0), (True, False, True))
    jd, td = _domains(*args)
    jg, tg = jdomain.ProcessGrid((2, 2, 1)), tdomain.ProcessGrid((2, 2, 1))
    flat = _mk_state(np.random.default_rng(6), V, n)
    hostile = np.array(
        [np.inf, -np.inf, np.nan, 1e10, -1e10, 3e38, -3e38, 2.0],
        np.float32,
    )
    for d in range(3):  # open axis 1 mostly, periodic axes too
        row = flat[d].view(np.float32)
        row[d * 64 : d * 64 + hostile.size * 8] = np.repeat(hostile, 8)
    vel = flat[4].view(np.float32)
    vel[500:508] = hostile  # hostile velocities on the open axis
    flat[-1, :] = 1
    f_t, k_t = _port_plain(flat, dt, td, tg, V)
    f_x, k_x = _jax_twin(flat, dt, jd, jg, V)
    np.testing.assert_array_equal(f_t.view(np.uint32), f_x.view(np.uint32))
    np.testing.assert_array_equal(k_t, k_x)
    # +inf and 1e10 on the open axis 1 land in its last cell, NaN in
    # cell 0 (columns 64.. hold the hostile rows of axis 1, all in vrank
    # 0, whose stayers carry the sentinel V)
    key = k_t.reshape(-1)
    dv = np.where(key == V, 0, key)
    cell_y = dv % 2  # grid (2, 2, 1): stride 1 on axis 1
    assert (cell_y[64:72] == 1).all()  # +inf
    assert (cell_y[80:88] == 0).all()  # NaN
    assert (cell_y[88:96] == 1).all()  # 1e10


@pytest.mark.parametrize("dt", DTS)
def test_non_pow2_periodic_extent(dt):
    """Extents the TPU kernel refuses (fmod remainder path) — the plain
    version and the CUDA kernel cover them, against the XLA twin."""
    V, n = 4, 1000  # n matches no TPU block width either
    args = ((0.0, -1.0, 0.5), (3.0, 0.7, 1.5), (True, True, True))
    jd, td = _domains(*args)
    jg, tg = jdomain.ProcessGrid((2, 1, 2)), tdomain.ProcessGrid((2, 1, 2))
    flat = _mk_state(np.random.default_rng(8), V, n, scale=4.0)
    f_t, k_t = _port_plain(flat, dt, td, tg, V)
    f_x, k_x = _jax_twin(flat, dt, jd, jg, V)
    np.testing.assert_array_equal(f_t.view(np.uint32), f_x.view(np.uint32))
    np.testing.assert_array_equal(k_t, k_x)


def test_wrapper_runs_plain_on_cpu_and_validates():
    V, n = 8, 256
    td = tdomain.Domain(0.0, 1.0, periodic=True)
    tg = tdomain.ProcessGrid((2, 2, 2))
    flat = _mk_state(np.random.default_rng(9), V, n)
    before = driftbin.KERNEL.launches
    f_w, k_w = driftbin.drift_wrap_bin(
        torch.from_numpy(flat.copy()), 1.0, td, tg, V, V
    )
    f_t, k_t = _port_plain(flat, 1.0, td, tg, V)
    np.testing.assert_array_equal(f_w.numpy(), f_t)
    np.testing.assert_array_equal(k_w.numpy(), k_t)
    assert driftbin.KERNEL.launches == before  # no kernel on the CPU
    with pytest.raises(TypeError):
        driftbin.drift_wrap_bin(
            torch.from_numpy(flat).view(torch.float32), 1.0, td, tg, V, V
        )
    with pytest.raises(ValueError):
        driftbin.drift_wrap_bin(
            torch.from_numpy(flat[:5].copy()), 1.0, td, tg, V, V
        )
