"""Card tests of the PyTorch port: each CUDA kernel against its plain
PyTorch version on the same inputs, bit for bit, and the drift/migrate
loop on the card against the port's CPU run. They skip without a GPU.

This file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu_torch import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.bench import common
from mpi_grid_redistribute_tpu_torch.models import nbody
from mpi_grid_redistribute_tpu_torch.ops import driftbin, overlay


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(r, V, n, scale=1.0):
    m = V * n
    pos = ((r.random((3, m), dtype=np.float32) * 2 - 0.5) * scale).astype(
        np.float32
    )
    pos[1, :48] = np.repeat(
        np.array([np.inf, -np.inf, np.nan, 1e10, -1e10, 3e38], np.float32), 8
    )
    vel = (r.random((3, m), dtype=np.float32) - 0.5).astype(np.float32)
    alive = (r.random(m) < 0.9).astype(np.int32)
    return torch.from_numpy(np.concatenate(
        [pos.view(np.int32), vel.view(np.int32), alive[None]], axis=0
    ))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [1.0, 0.0625, 0.05])
@pytest.mark.parametrize("periodic,hi", [
    ((True, True, True), (1.0, 2.0, 2.0)),
    ((True, False, True), (1.0, 2.0, 4.7)),  # open axis, non-pow2 extent
])
def test_driftbin_kernel_matches_plain(cuda, dt, periodic, hi):
    V, n = 4, 4099  # ragged width
    domain = Domain((0.0, -2.0, 1.0), hi, periodic=periodic)
    grid = ProcessGrid((2, 2, 1))
    flat = _state(np.random.default_rng(10), V, n, 3.0).to(cuda)
    before = driftbin.KERNEL.launches
    f_k, k_k = driftbin.drift_wrap_bin(flat.clone(), dt, domain, grid, V, V)
    f_p, k_p = driftbin.drift_wrap_bin_plain(
        flat.clone(), dt, domain, grid, V, V
    )
    torch.cuda.synchronize()
    assert driftbin.KERNEL.launches == before + 1
    assert torch.equal(f_k, f_p) and torch.equal(k_k, k_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_overlay_kernel_matches_plain(cuda, dtype):
    g = torch.Generator(device="cuda").manual_seed(4)
    K, m, P = 7, 100_003, 5000
    flat = torch.randint(-(2**31), 2**31 - 1, (K, m), dtype=torch.int32,
                         device=cuda, generator=g)
    cols = torch.randint(-(2**31), 2**31 - 1, (K, P), dtype=torch.int32,
                         device=cuda, generator=g)
    t = torch.randperm(m + 50, device=cuda, generator=g)[:P].to(torch.int32)
    t[:10] = -5
    flat, cols = flat.view(dtype), cols.view(dtype)
    got = overlay.overlay_scatter_planar(flat.clone(), t, cols)
    want = overlay.overlay_scatter_planar_plain(flat.clone(), t, cols)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_overlay_kernel_raises_on_bad_input(cuda):
    flat = torch.zeros((7, 64), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        overlay.overlay_scatter_planar(
            flat, torch.zeros(4, dtype=torch.int64, device=cuda),
            torch.zeros((7, 4), dtype=torch.int32, device=cuda),
        )
    with pytest.raises(ValueError):
        overlay.overlay_scatter_planar(
            flat[:, ::2], torch.zeros(4, dtype=torch.int32, device=cuda),
            torch.zeros((7, 4), dtype=torch.int32, device=cuda),
        )


@pytest.mark.cuda
def test_loop_on_card_matches_cpu_run(cuda):
    grid = (2, 2, 2)
    n_local = 4096
    v, cap, budget = common.drift_sizing(grid, n_local, 0.9, 0.02)
    pos, vel, alive = common.uniform_state(
        grid, n_local, 0.9, np.random.default_rng(1), vel_scale=4 * v
    )
    cfg = nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True), grid=ProcessGrid((1, 1, 1)),
        dt=1.0, capacity=cap, n_local=n_local, local_budget=budget,
        engine="planar",
    )
    vgrid = ProcessGrid(grid)
    a = nbody.make_migrate_loop(cfg, 5, vgrid=vgrid)(pos, vel, alive)
    b = nbody.make_migrate_loop(cfg, 5, vgrid=vgrid, device="cpu")(
        pos, vel, alive
    )
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x.cpu().view(torch.uint8), y.view(torch.uint8))
    for f in ("sent", "received", "population", "backlog", "flow"):
        assert torch.equal(getattr(a[3], f).cpu(), getattr(b[3], f)), f
