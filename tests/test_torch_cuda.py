"""Card tests of the PyTorch port: each CUDA kernel against its plain
PyTorch version on the same inputs (bit for bit; the segmented deposit
sums in another order than the plain ``index_add_``, so it is bit-equal
on dyadic data, where every order gives the same bits, and within
float32 summation noise otherwise), and the drift/migrate loop (the
sparse and planar engines, and the row-store landing route), with and
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
    dfscan, driftbin, overlay, scatter, segdep,
)
from mpi_grid_redistribute_tpu_torch.parallel import migrate


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


def _ordered_targets(g, order, m, p, V=8):
    """``p`` unique targets in ``[0, m)`` in ascending, descending, random
    or loop order, with the first warp's 32 all dropped and a few
    negatives. Loop order is the shape ``parallel.migrate._land`` emits
    per vrank (V groups): the vacated slots in send order (ascending
    within each of 7 destination runs), then popped holes walking the
    free stack downward, then the sentinel ``m``."""
    t = torch.randperm(m, device="cuda", generator=g)[:p]
    if order == "ascending":
        t = t.sort().values
    elif order == "descending":
        t = t.sort(descending=True).values
    elif order == "loop":
        n, per = m // V, p // V
        parts = []
        for v in range(V):
            cnt = per if v < V - 1 else p - per * (V - 1)
            k_in, k_pop = int(cnt * 0.75), int(cnt * 0.1)
            slots = torch.randperm(n, device="cuda", generator=g)[
                :k_in + k_pop] + v * n
            for run in slots[:k_in].tensor_split(7):
                parts.append(run.sort().values)
            parts += [slots[k_in:].sort(descending=True).values,
                      torch.full((cnt - k_in - k_pop,), m, device="cuda")]
        t = torch.cat(parts)
    t = t.to(torch.int32)
    t[:32] = torch.where(torch.arange(32, device="cuda") % 2 == 0, m + 3,
                         -1).to(torch.int32)
    t[40:43] = -(2**31)
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("order", ["ascending", "descending", "random",
                                   "loop"])
@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 6, 7, 9])
def test_overlay_kernel_every_k_and_order(cuda, K, order, dtype):
    """K planes from 1 to 9, P not a multiple of 32 with an all-dropped
    first warp, targets in four orders, NaN bit patterns in float32:
    bit-equal to the plain version."""
    g = torch.Generator(device="cuda").manual_seed(K * 10 + len(order))
    m, P = 40_000, 3_001
    flat = torch.randint(-(2**31), 2**31 - 1, (K, m), dtype=torch.int32,
                         device=cuda, generator=g)
    cols = torch.randint(-(2**31), 2**31 - 1, (K, P), dtype=torch.int32,
                         device=cuda, generator=g)
    cols[0, :4] = torch.tensor([0x7FC0BEEF, 0x7F800001, -1, 1],
                               dtype=torch.int32, device=cuda)
    t = _ordered_targets(g, order, m, P)
    flat, cols = flat.view(dtype), cols.view(dtype)
    before = overlay.KERNEL.launches
    got = overlay.overlay_scatter_planar(flat.clone(), t, cols)
    want = overlay.overlay_scatter_planar_plain(flat.clone(), t, cols)
    torch.cuda.synchronize()
    assert overlay.KERNEL.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [
    2**30,  # K * m = 2**31: word offsets past an int32
    2**30 - 1,  # the largest K = 2 plane pair whose offsets fit an int32
])
def test_overlay_kernel_index_width_edges(cuda, m):
    """Word offsets on both sides of 2**31 (8 GB of state), targets
    reaching the last column of the second plane: every in-range word
    lands and nothing else changes."""
    K, P = 2, 4099
    g = torch.Generator(device="cuda").manual_seed(m % 1000)
    flat = torch.zeros((K, m), dtype=torch.int32, device=cuda)
    cols = torch.randint(1, 2**31 - 1, (K, P), dtype=torch.int32,
                         device=cuda, generator=g)
    t = torch.randperm(P - 3, device=cuda, generator=g) * (m // P)
    t = torch.cat([t, torch.tensor([m - 1, m - 2, m], device=cuda)]).to(
        torch.int32
    )
    got = overlay.overlay_scatter_planar(flat, t, cols)
    torch.cuda.synchronize()
    assert torch.equal(got[:, t[:-1].long()], cols[:, :-1])
    assert int((got != 0).sum()) == K * (P - 1)
    del flat, got


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


def _signed_zero_rows(r, rows, tile):
    """Normals, with (where there are rows for them) a row of -0.0, a row
    mixing -0.0 and +0.0 with values, and a row of +-0.0 only."""
    x = r.standard_normal((rows, tile)).astype(np.float32)
    if rows >= 4:
        x[1] = -0.0
        x[2, ::3] = -0.0
        x[2, 1::5] = 0.0
        x[3] = np.where(r.random(tile) < 0.5, -0.0, 0.0)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [
    1, 2, 3, 5, 31, 32, 33, 63, 96, 255, 256, 257, 1000, 1024,
])
@pytest.mark.parametrize("rows", [1, 13, 517])
def test_dfscan_kernel_tiles_and_partial_warps(cuda, tile, rows):
    """Every register count and rows-per-warp class, with row counts that
    leave the last warp (13 rows at tile <= 16) and the last 8-warp block
    partly filled, and rows of signed zeros: bit-equal to the plain
    version."""
    x = torch.from_numpy(
        _signed_zero_rows(np.random.default_rng(tile * 1000 + rows), rows,
                          tile)
    ).to(cuda)
    before = dfscan.KERNEL.launches
    hi, lo = dfscan.tile_df_cumsum_rows(x)
    hp, lp = dfscan.tile_df_cumsum_rows_plain(x)
    torch.cuda.synchronize()
    assert dfscan.KERNEL.launches == before + 1
    assert _bits_equal(hi, hp) and _bits_equal(lo, lp)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [5, 32, 256])
def test_dfscan_kernel_negative_zero_rows(cuda, tile):
    """All -0.0 rows become +0.0 at the first step (-0.0 + 0.0 is +0.0),
    as in the plain version; a kernel that skipped the add with the
    shifted-in zeros would keep -0.0 at column 0."""
    r = np.random.default_rng(tile)
    x = np.full((40, tile), -0.0, np.float32)
    x[20:] = _signed_zero_rows(r, 20, tile)
    xt = torch.from_numpy(x).to(cuda)
    hi, lo = dfscan.tile_df_cumsum_rows(xt)
    hp, lp = dfscan.tile_df_cumsum_rows_plain(xt)
    torch.cuda.synchronize()
    assert _bits_equal(hi, hp) and _bits_equal(lo, lp)
    assert not torch.signbit(hi[:20]).any()


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


EDGE_STREAMS = ("run_spans_tiles", "runs_end_at_tile_ends",
                "sentinel_tile_between_slabs", "all_sentinel",
                "empty_canvas_ends")


@pytest.mark.cuda
@pytest.mark.parametrize("with_mass", [False, True])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("stream", EDGE_STREAMS)
def test_segdep_kernel_tile_edge_streams(cuda, stream, d, with_mass):
    """Runs across the kernel's tile edges (a cell over three tiles,
    boundaries on tile ends, a whole tile of sentinels between two slabs,
    no valid row, empty canvas ends): bit-equal to the plain version on
    dyadic data, within 2e-5 and run-to-run identical on generic
    floats."""
    r = np.random.default_rng(EDGE_STREAMS.index(stream) * 10 + d)
    keys_np, n_cells = common.segdep_edge_streams(segdep.TILE, r)[stream]
    n = keys_np.shape[0]
    vblock = (8,) * d
    keys = torch.from_numpy(keys_np).to(cuda)
    rel_d = torch.from_numpy(
        (r.integers(0, 32, (d, n)) * 0.25).astype(np.float32)
    ).to(cuda)
    mass_d = torch.from_numpy(
        r.choice(np.float32([0.5, 1.0, 2.0]), n)
    ).to(cuda) if with_mass else None
    before = segdep.KERNEL.launches
    got = segdep.segsum_sorted(keys, rel_d, mass_d, n_cells, vblock)
    want = segdep.segsum_sorted_plain(keys, rel_d, mass_d, n_cells, vblock)
    torch.cuda.synchronize()
    assert segdep.KERNEL.launches == before + 1
    assert _bits_equal(got, want)
    rel_g = torch.from_numpy(
        (r.random((d, n)) * 8).astype(np.float32)
    ).to(cuda)
    mass_g = None if mass_d is None else (mass_d * 0.37).contiguous()
    a = segdep.segsum_sorted(keys, rel_g, mass_g, n_cells, vblock)
    b = segdep.segsum_sorted(keys, rel_g, mass_g, n_cells, vblock)
    p = segdep.segsum_sorted_plain(keys, rel_g, mass_g, n_cells, vblock)
    torch.cuda.synchronize()
    assert _bits_equal(a, b)
    torch.testing.assert_close(a, p, rtol=2e-5, atol=2e-5)


T = segdep.TILE


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [
    (1, 0), (T - 1, 0), (T, 0), (T + 1, 0), (2 * T - 1, 1), (4 * T + 1, 1),
    (6 * T, 1), (6 * T, 0), (600 * T + 3, 0),
])
def test_segdep_kernel_partial_tiles_and_unaligned_rows(cuda, n, offset):
    """N at and around the tile, N not a multiple of 4, rows that start
    off a 16-byte boundary (the kernel's scalar loads) and a stream of
    600 tiles, bit-equal to the plain version on dyadic data."""
    r = np.random.default_rng(n + offset)
    n_cells = 512
    keys_np = np.sort(r.integers(0, n_cells + 1, n + offset)).astype(np.int32)
    keys = torch.from_numpy(keys_np).to(cuda)[offset:]
    rel = torch.from_numpy(
        (r.integers(0, 32, (3 * (n + offset),)) * 0.25).astype(np.float32)
    ).to(cuda)[offset * 3:].reshape(3, n)
    mass = torch.from_numpy(
        r.choice(np.float32([0.5, 1.0, 2.0]), n + offset)
    ).to(cuda)[offset:]
    for m in (None, mass):
        got = segdep.segsum_sorted(keys, rel, m, n_cells, (8, 8, 8))
        want = segdep.segsum_sorted_plain(keys, rel, m, n_cells, (8, 8, 8))
        torch.cuda.synchronize()
        assert _bits_equal(got, want)


@pytest.mark.cuda
def test_segdep_kernel_drops_negative_keys(cuda):
    """Negative keys are outside the contract: the kernel drops them, the
    plain version (like the reference's XLA fallback) clamps them into
    cell 0 (ROADMAP.md C4)."""
    keys = torch.tensor([-3, -1, 0, 0, 2, 5], dtype=torch.int32, device=cuda)
    rel = torch.full((1, 6), 0.25, device=cuda)
    got = segdep.segsum_sorted(keys, rel, None, 4, (4,))
    want = segdep.segsum_sorted_plain(keys, rel, None, 4, (4,))
    torch.cuda.synchronize()
    assert got[:, 0].tolist() == [1.5, 0.5]
    assert want[:, 0].tolist() == [3.0, 1.0]
    assert torch.equal(got[:, 1:], want[:, 1:])


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [
    torch.float32, torch.int32, torch.float64, torch.float16, torch.uint8,
])
@pytest.mark.parametrize("n_rows,K,P", [
    (100_003, 7, 5000), (8192, 8, 3000), (4099, 1, 4099), (64, 13, 40),
])
def test_scatter_rows_kernel_matches_plain(cuda, dtype, n_rows, K, P):
    """Kernel 6 against its plain version on raw words: negative targets,
    targets >= n_rows, and NaN / inf / denormal bit patterns."""
    g = torch.Generator(device="cuda").manual_seed(n_rows + K)
    w = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        torch.empty((), dtype=dtype).element_size()
    ]
    lo, hi = torch.iinfo(w).min, torch.iinfo(w).max
    flat = torch.randint(lo, hi, (n_rows, K), dtype=w, device=cuda,
                         generator=g)
    rows = torch.randint(lo, hi, (P, K), dtype=w, device=cuda, generator=g)
    if w == torch.int32:  # NaN payload, +-inf, denormals
        rows[:4, 0] = torch.tensor([0x7FC0BEEF, 0x7F800000, 0xFF800000 - 2**32,
                                    0x00000001], dtype=w, device=cuda)
    t = torch.randperm(n_rows + 50, device=cuda, generator=g)[:P].to(
        torch.int32
    )
    t[:7] = -3
    flat, rows = flat.view(dtype), rows.view(dtype)
    before = scatter.KERNEL.launches
    got = scatter.scatter_rows(flat.clone(), t, rows)
    want = scatter.scatter_rows_plain(flat.clone(), t, rows)
    torch.cuda.synchronize()
    assert scatter.KERNEL.launches == before + 1
    assert torch.equal(got.view(w), want.view(w))


_WORD = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [
    torch.float32, torch.int32, torch.float64, torch.float16, torch.uint8,
])
@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 6, 7, 8, 9, 13])
def test_scatter_rows_kernel_every_k(cuda, dtype, K):
    """Each compile-time K (1..8) and the generic one (9, 13), at a P that
    is not a multiple of 32, with one warp's 32 targets all dropped (too
    large or negative) and a partial last warp."""
    g = torch.Generator(device="cuda").manual_seed(100 + K)
    w = _WORD[torch.empty((), dtype=dtype).element_size()]
    lo, hi = torch.iinfo(w).min, torch.iinfo(w).max
    n_rows, P = 5003, 1061
    flat = torch.randint(lo, hi, (n_rows, K), dtype=w, device=cuda,
                         generator=g)
    rows = torch.randint(lo, hi, (P, K), dtype=w, device=cuda, generator=g)
    t = torch.randperm(n_rows + 300, device=cuda, generator=g)[:P].to(
        torch.int32
    )
    t[64:96] = torch.where(torch.arange(32, device=cuda) % 2 == 0,
                           n_rows + 7, -1).to(torch.int32)
    t[5] = -(2**31)
    assert scatter.index_bits(n_rows, P, K) == 32
    flat, rows = flat.view(dtype), rows.view(dtype)
    before = scatter.KERNEL.launches
    got = scatter.scatter_rows(flat.clone(), t, rows)
    want = scatter.scatter_rows_plain(flat.clone(), t, rows)
    torch.cuda.synchronize()
    assert scatter.KERNEL.launches == before + 1
    assert torch.equal(got.view(w), want.view(w))


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,K,bits", [
    (2**28, 9, 64),  # 2.4 GB: word offsets past 2**31
    (2**31 - 1, 1, 32),  # the last shape on the 32-bit path
])
def test_scatter_rows_kernel_index_width_edges(cuda, n_rows, K, bits):
    """The 64-bit index path, and the 32-bit one at its largest offset,
    bit-equal to the plain version; targets reach the last row."""
    assert scatter.index_bits(n_rows, 4099, K) == bits
    g = torch.Generator(device="cuda").manual_seed(K)
    flat = torch.randint(0, 256, (n_rows, K), dtype=torch.uint8, device=cuda,
                         generator=g)
    rows = torch.randint(0, 256, (4099, K), dtype=torch.uint8, device=cuda,
                         generator=g)
    t = (torch.randperm(4096, device=cuda, generator=g) * (n_rows // 4096))
    t = torch.cat([t, torch.tensor([n_rows - 1, n_rows - 2, n_rows],
                                   device=cuda)]).to(torch.int32)
    want = scatter.scatter_rows_plain(flat.clone(), t, rows)
    got = scatter.scatter_rows(flat, t, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    del want
    assert torch.equal(got[-2:], rows[-3:-1].flip(0))


@pytest.mark.cuda
def test_scatter_rows_kernel_raises_on_bad_input(cuda):
    flat = torch.zeros((64, 7), device=cuda)
    t = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        scatter.scatter_rows(flat, t.long(), torch.zeros((4, 7), device=cuda))
    with pytest.raises(ValueError):
        scatter.scatter_rows(flat.T.contiguous().T, t,
                             torch.zeros((4, 7), device=cuda))
    with pytest.raises(ValueError):
        scatter.scatter_rows(flat, t.cpu(), torch.zeros((4, 7), device=cuda))


def _loop_inputs(seed, n_local=4096):
    grid = (2, 2, 2)
    v, cap, budget = common.drift_sizing(grid, n_local, 0.9, 0.02)
    state = common.uniform_state(
        grid, n_local, 0.9, np.random.default_rng(seed), vel_scale=v
    )
    cfg = nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True), grid=ProcessGrid((1, 1, 1)),
        dt=1.0, capacity=cap, n_local=n_local, local_budget=budget,
    )
    return cfg, ProcessGrid(grid), state


@pytest.mark.cuda
def test_sparse_loop_on_card_matches_planar_and_cpu(cuda):
    """The default engine on the card: bit-equal to the planar engine on
    the card and to its own CPU run, every step on the fast branch, one
    host read per step, kernels 1 and 2 once per step."""
    import dataclasses

    cfg, vgrid, (pos, vel, alive) = _loop_inputs(3)
    syncs = migrate.HOST_SYNCS["sparse_guard"]
    b1, b2 = driftbin.KERNEL.launches, overlay.KERNEL.launches
    a = nbody.make_migrate_loop(cfg, 5, vgrid=vgrid)(pos, vel, alive)
    torch.cuda.synchronize()
    assert migrate.HOST_SYNCS["sparse_guard"] - syncs == 5
    assert driftbin.KERNEL.launches - b1 == 5
    assert overlay.KERNEL.launches - b2 == 5
    assert a[3].fast_path.all()
    p = nbody.make_migrate_loop(
        dataclasses.replace(cfg, engine="planar"), 5, vgrid=vgrid
    )(pos, vel, alive)
    c = nbody.make_migrate_loop(cfg, 5, vgrid=vgrid, device="cpu")(
        pos, vel, alive
    )
    for x, y, z in zip(a[:3], p[:3], c[:3]):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
        assert torch.equal(x.cpu().view(torch.uint8), z.view(torch.uint8))
    for f in ("sent", "received", "population", "backlog", "flow"):
        assert torch.equal(getattr(a[3], f), getattr(p[3], f)), f
        assert torch.equal(getattr(a[3], f).cpu(), getattr(c[3], f)), f


@pytest.mark.cuda
def test_rows_route_on_card_matches_plain_and_int32_loop(cuda):
    """The row-store landing route on the legacy float32 state, dest keys
    from kernel 1 on the int32 view: kernel 6 once per step, bit-equal to
    the plain-version run and to the int32 planar loop."""
    import dataclasses

    cfg, vgrid, (pos, vel, alive) = _loop_inputs(4)
    full = ProcessGrid((2, 2, 2))
    pos_p = torch.from_numpy(nbody.rows_to_planar(pos, 1)).reshape(3, -1)
    vel_p = torch.from_numpy(nbody.rows_to_planar(vel, 1)).reshape(3, -1)
    fused0 = torch.cat([pos_p, vel_p, torch.from_numpy(alive).float()[None]])

    def run(plain):
        mig = migrate.shard_migrate_vranks_fn(
            cfg.domain, cfg.grid, vgrid, cfg.capacity,
            local_budget=cfg.local_budget, scatter_impl="rows", plain=plain,
        )
        bin_fn = driftbin.drift_wrap_bin_plain if plain else \
            driftbin.drift_wrap_bin
        state = migrate.init_state(fused0.clone().to(cuda), vranks=8,
                                   batched=True)
        stats = []
        for _ in range(4):
            f, key = bin_fn(state.fused.view(torch.int32), 1.0, cfg.domain,
                            full, 8, 8)
            state, st = mig(state._replace(fused=f.view(torch.float32)), key)
            stats.append(st)
        return state, stats

    before = scatter.KERNEL.launches
    got, gstats = run(False)
    torch.cuda.synchronize()
    assert scatter.KERNEL.launches - before == 4
    want, wstats = run(True)
    ref = nbody.make_migrate_loop(
        dataclasses.replace(cfg, engine="planar"), 4, vgrid=vgrid
    )(pos, vel, alive)
    assert torch.equal(got.fused.view(torch.int32), want.fused.view(torch.int32))
    fi = got.fused.view(torch.int32)
    assert torch.equal(fi[:3].reshape(-1), ref[0].view(torch.int32))
    assert torch.equal(fi[3:6].reshape(-1), ref[1].view(torch.int32))
    assert torch.equal(got.fused[-1] > 0, ref[2])
    for i, (g, w) in enumerate(zip(gstats, wstats)):
        for f in ("sent", "received", "population", "backlog", "flow"):
            assert torch.equal(getattr(g, f), getattr(w, f)), f
            assert torch.equal(getattr(g, f), getattr(ref[3], f)[i]), f
