"""Card tests of the PyTorch port: each CUDA kernel against its plain
PyTorch version on the same inputs (bit for bit; the segmented deposit
sums in another order than the plain ``index_add_``, so it is bit-equal
on dyadic data, where every order gives the same bits, and within
float32 summation noise otherwise), and the drift/migrate loop, with and
without the fused deposit, on the card against the port's CPU run. They
skip without a GPU.

This file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu_torch import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.bench import common
from mpi_grid_redistribute_tpu_torch.models import nbody
from mpi_grid_redistribute_tpu_torch.ops import (
    dfscan, driftbin, overlay, segdep,
)


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


def _bits_equal(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,tile", [
    (100, 256), (257, 128), (33, 1000), (1025, 64), (10, 1), (7, 1024),
])
def test_dfscan_kernel_matches_plain(cuda, rows, tile):
    r = np.random.default_rng(rows * 7 + tile)
    x = torch.from_numpy(r.standard_normal((rows, tile)).astype(np.float32))
    x = x.to(cuda)
    before = dfscan.KERNEL.launches
    hi, lo = dfscan.tile_df_cumsum_rows(x)
    hp, lp = dfscan.tile_df_cumsum_rows_plain(x)
    torch.cuda.synchronize()
    assert dfscan.KERNEL.launches == before + 1
    assert _bits_equal(hi, hp) and _bits_equal(lo, lp)


@pytest.mark.cuda
@pytest.mark.parametrize("mags", [
    (1e-30, 1e-8, 1.0, 1e8, 1e30),
    (1e-38, 1e-42, 1e-44),  # denormals: IEEE on both sides of the card
])
def test_dfscan_kernel_hostile_magnitudes(cuda, mags):
    r = np.random.default_rng(77)
    m = r.choice(mags, size=(64, 256))
    x = (r.standard_normal((64, 256)) * m).astype(np.float32)
    x[3, :8] = 0.0
    x[5, 10] = np.inf
    x[6, 20] = np.nan
    xt = torch.from_numpy(x).to(cuda)
    hi, lo = dfscan.tile_df_cumsum_rows(xt)
    hp, lp = dfscan.tile_df_cumsum_rows_plain(xt)
    torch.cuda.synchronize()
    assert _bits_equal(hi, hp) and _bits_equal(lo, lp)


@pytest.mark.cuda
def test_dfscan_kernel_raises_on_bad_input(cuda):
    with pytest.raises(ValueError):
        dfscan.tile_df_cumsum_rows(torch.zeros((4, 1025), device=cuda))
    with pytest.raises(TypeError):
        dfscan.tile_df_cumsum_rows(
            torch.zeros((4, 8), dtype=torch.float64, device=cuda)
        )
    with pytest.raises(ValueError):
        dfscan.tile_df_cumsum_rows(torch.zeros((8, 8), device=cuda)[:, ::2])


def _segdep_stream(r, kind, n, n_cells):
    """Sorted key streams: uniform with a sentinel tail, clustered (a few
    hot cells whose runs cross many 256-row blocks, and empty gaps),
    per-slab sorts with sentinel runs mid-stream, and all sentinel."""
    if kind == "uniform":
        keys = np.sort(r.integers(0, n_cells, n - n // 20))
        keys = np.concatenate([keys, np.full(n // 20, n_cells)])
    elif kind == "clustered":
        hot = r.choice(n_cells, 5, replace=False)
        keys = np.sort(np.where(r.random(n) < 0.9, hot[r.integers(0, 5, n)],
                                n_cells))
    elif kind == "slabs":
        V = 4
        C = n_cells // V
        parts = []
        for v, (size, frac) in enumerate(
            zip([n // 2, n // 4, n // 8, n - n // 2 - n // 4 - n // 8],
                [0.03, 0.8, 0.5, 1.0])
        ):
            k = np.where(r.random(size) < frac,
                         v * C + r.integers(0, C, size), n_cells)
            parts.append(np.sort(k))
        keys = np.concatenate(parts)
    else:
        keys = np.full(n, n_cells)
    return keys.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "clustered", "slabs", "sentinel"])
@pytest.mark.parametrize("d,vblock,n,n_cells", [
    (3, (8, 8, 8), 20_000, 512),
    (2, (16, 16), 3_000, 256),
])
@pytest.mark.parametrize("with_mass", [False, True])
def test_segdep_kernel_matches_plain(cuda, kind, d, vblock, n, n_cells,
                                     with_mass):
    r = np.random.default_rng(
        ["uniform", "clustered", "slabs", "sentinel"].index(kind) * 10 + d
        + 100 * with_mass
    )
    keys = torch.from_numpy(_segdep_stream(r, kind, n, n_cells)).to(cuda)
    # dyadic: rel in multiples of 1/4 and mass in {1/2, 1, 2} make every
    # weight a short binary fraction, so every partial sum is exact and
    # any summation order gives the same bits
    rel_d = torch.from_numpy(
        (r.integers(0, 4 * vblock[0], (d, n)) * 0.25).astype(np.float32)
    ).to(cuda)
    mass_d = torch.from_numpy(
        r.choice(np.float32([0.5, 1.0, 2.0]), n)
    ).to(cuda) if with_mass else None
    before = segdep.KERNEL.launches
    got = segdep.segsum_sorted(keys, rel_d, mass_d, n_cells, vblock)
    want = segdep.segsum_sorted_plain(keys, rel_d, mass_d, n_cells, vblock)
    torch.cuda.synchronize()
    assert segdep.KERNEL.launches == before + 1
    assert got.shape == (2**d, n_cells)
    assert _bits_equal(got, want)
    # generic floats: float32 summation noise (2e-5, the deposit
    # engines' float64-oracle tolerance), and bit-reproducible run to run
    rel_g = (torch.rand((d, n), generator=torch.Generator().manual_seed(n))
             * vblock[0]).to(cuda)
    mass_g = None if mass_d is None else (mass_d * 0.37).contiguous()
    a = segdep.segsum_sorted(keys, rel_g, mass_g, n_cells, vblock)
    b = segdep.segsum_sorted(keys, rel_g, mass_g, n_cells, vblock)
    p = segdep.segsum_sorted_plain(keys, rel_g, mass_g, n_cells, vblock)
    torch.cuda.synchronize()
    assert _bits_equal(a, b)
    torch.testing.assert_close(a, p, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_segdep_kernel_raises_on_bad_input(cuda):
    keys = torch.zeros(16, dtype=torch.int32, device=cuda)
    rel = torch.zeros((4, 16), device=cuda)
    with pytest.raises(ValueError):  # D = 4 is past the kernel's 3
        segdep.segsum_sorted(keys, rel, None, 16, (2, 2, 2, 2))
    with pytest.raises(ValueError):
        segdep.segsum_sorted(keys, rel[:3], None, 2**27 + 1, (8, 8, 8))
    with pytest.raises(TypeError):
        segdep.segsum_sorted(keys.long(), rel[:3], None, 16, (8, 8, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["scan", "mxu"])
@pytest.mark.parametrize("each_step", [True, False])
def test_deposit_loop_on_card_matches_cpu_run(cuda, method, each_step):
    grid = (2, 2, 2)
    n_local = 4096
    v, cap, budget = common.drift_sizing(grid, n_local, 0.9, 0.02)
    pos, vel, alive = common.uniform_state(
        grid, n_local, 0.9, np.random.default_rng(2), vel_scale=4 * v
    )
    cfg = nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True), grid=ProcessGrid((1, 1, 1)),
        dt=1.0, capacity=cap, n_local=n_local, local_budget=budget,
        deposit_shape=(16, 16, 16), deposit_method=method, engine="planar",
    )
    vgrid = ProcessGrid(grid)
    kernel = (dfscan if method == "scan" else segdep).KERNEL
    before = kernel.launches
    a = nbody.make_migrate_loop(
        cfg, 4, vgrid=vgrid, deposit_each_step=each_step
    )(pos, vel, alive)
    b = nbody.make_migrate_loop(
        cfg, 4, vgrid=vgrid, device="cpu", deposit_each_step=each_step
    )(pos, vel, alive)
    torch.cuda.synchronize()
    assert kernel.launches == before + (4 if each_step else 1)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x.cpu().view(torch.uint8), y.view(torch.uint8))
    rho, rho_cpu = a[4].cpu(), b[4]
    if method == "scan":
        assert _bits_equal(rho, rho_cpu)
    else:  # another summation order than the CPU's index_add_
        torch.testing.assert_close(rho, rho_cpu, rtol=2e-5, atol=2e-5)
    assert abs(float(rho.double().sum()) - int(alive.sum())) <= 1e-5 * int(
        alive.sum()
    )
