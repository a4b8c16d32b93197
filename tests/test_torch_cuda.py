"""Card tests of the PyTorch port: each CUDA kernel against its plain
PyTorch version on the same inputs (bit for bit; the segmented deposit
sums in another order than the plain ``index_add_``, so it is bit-equal
on dyadic data, where every order gives the same bits, and within
float32 summation noise otherwise), and the drift/migrate loop (the
sparse and planar engines, and the row-store landing route), with and
without the fused deposit, on the card against the port's CPU run; the
canonical redistribute and the halo exchange (both vrank engines and the
public ``halo()`` under each overflow policy) on the card against the
port's CPU run, with no host sync in an engine exchange; the
load-balanced ``cells``/``assignment`` loop (both engines) against the
CPU run, config 3's 64-vrank shape against the plain-version run, and the
``"segment"`` deposit (atomics: within 2e-5 of the CPU run, its mass
exact to rtol 1e-5); the sequential and pipelined service chunks on the
card against the CPU run, with no host sync inside and kernel 2 at the
pipelined landing's K = 8 and 9; the service driver's three legs on the
card against its CPU run, its chunks with no host sync, a snapshot from
the card restored on the CPU, and the chunk overlap (chunk k's ys read
while chunk k+1 still runs). They skip without a GPU.

This file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu_torch import Domain, GridRedistribute, ProcessGrid
from mpi_grid_redistribute_tpu_torch.bench import common
from mpi_grid_redistribute_tpu_torch.bench import (
    config2_clustered, config3_slab,
)
from mpi_grid_redistribute_tpu_torch.models import nbody
from mpi_grid_redistribute_tpu_torch.ops import (
    deposit, dfscan, driftbin, overlay, rowsort, scatter, segdep,
)
from mpi_grid_redistribute_tpu_torch.parallel import halo, migrate


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
@pytest.mark.parametrize("tile", [1025, 2048, 3000, 8192, 14528])
@pytest.mark.parametrize("rows", [1, 13, 517])
def test_dfscan_kernel_block_route(cuda, tile, rows):
    """Tiles above 1024 (a block per row, the row in shared memory), with
    rows of signed zeros: bit-equal to the plain version."""
    assert dfscan.geometry(tile).route == "block"
    x = torch.from_numpy(
        _signed_zero_rows(np.random.default_rng(tile + rows), rows, tile)
    ).to(cuda)
    before = dfscan.KERNEL.launches
    hi, lo = dfscan.tile_df_cumsum_rows(x)
    hp, lp = dfscan.tile_df_cumsum_rows_plain(x)
    torch.cuda.synchronize()
    assert dfscan.KERNEL.launches == before + 1
    assert _bits_equal(hi, hp) and _bits_equal(lo, lp)


@pytest.mark.cuda
def test_dfscan_tile_past_shared_memory_runs_plain(cuda):
    """A tile past one block's shared memory goes to the plain version by
    ``dfscan.geometry``'s shape rule: no launch, the plain bits."""
    tile = dfscan.MAX_BLOCK_TILE + 1
    x = torch.randn((3, tile), device=cuda)
    before = dfscan.KERNEL.launches
    hi, lo = dfscan.tile_df_cumsum_rows(x)
    hp, lp = dfscan.tile_df_cumsum_rows_plain(x)
    torch.cuda.synchronize()
    assert dfscan.KERNEL.launches == before
    assert _bits_equal(hi, hp) and _bits_equal(lo, lp)


@pytest.mark.cuda
def test_dfscan_kernel_raises_on_bad_input(cuda):
    with pytest.raises(ValueError):
        dfscan.tile_df_cumsum_rows(torch.zeros((4, 0), device=cuda))
    with pytest.raises(TypeError):
        dfscan.tile_df_cumsum_rows(
            torch.zeros((4, 8), dtype=torch.float64, device=cuda)
        )
    with pytest.raises(ValueError):
        dfscan.tile_df_cumsum_rows(torch.zeros((8, 8), device=cuda)[:, ::2])



def _cic_payload(r, D, n, local_shape):
    """A sorted scan-deposit payload ``[D + 1, n]`` with the rows the fused
    route must get right: at the far face, a few ulp below 0, +-0.0, huge,
    NaN, masses that are not 1, and a tail of invalid rows (coordinates 0,
    mass 0)."""
    rel = (r.random((D, n)) * np.asarray(local_shape)[:, None]).astype(
        np.float32)
    mass = r.uniform(0.25, 3.0, n).astype(np.float32)
    for d in range(D):
        rel[d, 3 + d] = np.float32(local_shape[d])
        rel[d, 20 + d] = np.nextafter(np.float32(0), np.float32(-1))
        rel[d, 30 + d] = -0.0
        rel[d, 50 + d] = np.nextafter(np.float32(local_shape[d]),
                                      np.float32(0))
        rel[d, 60 + d] = np.float32(3e38)
    rel[0, 70] = np.nan
    mass[80] = -0.0
    rel[:, n - n // 10:] = 0.0
    mass[n - n // 10:] = 0.0
    return torch.from_numpy(np.concatenate([rel, mass[None]], axis=0))


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["pairs", "all"])
@pytest.mark.parametrize("D,local_shape", [
    (1, (16,)), (2, (8, 5)), (3, (8, 8, 8)),
])
@pytest.mark.parametrize("tile", [
    1, 3, 5, 31, 33, 64, 100, 256, 257, 1000, 1024,
])
def test_dfscan_cic_route_matches_plain(cuda, D, local_shape, tile, group):
    """The planar entry on the card (the plain stages around the rows
    route) against its plain twin, channel group by channel group, with a
    ragged last tile and a partly filled last warp and block: bit for bit,
    one "rows" launch a group and no fused one."""
    n = 77 * max(tile, 32) + 13
    payload = _cic_payload(np.random.default_rng(tile * 10 + D), D, n,
                           local_shape).to(cuda)
    g = 2 if group == "pairs" else 1 << D
    for c0 in range(0, 1 << D, g):
        before = dict(dfscan.ROUTES)
        got = dfscan.cic_tile_prefix(payload, local_shape, c0, g, tile)
        want = dfscan.cic_tile_prefix_plain(payload, local_shape, c0, g,
                                            tile)
        torch.cuda.synchronize()
        assert dfscan.ROUTES == dict(before, rows=before["rows"] + 1)
        assert got.shape == want.shape == (2 * g, -(-n // tile) * tile)
        assert _bits_equal(got, want)


@pytest.mark.cuda
def test_dfscan_cic_route_refuses_what_it_cannot_take(cuda):
    """The fused route's entry refuses strided or misaligned rows, channels
    outside ``2^D`` and another dtype, and takes no rows."""
    rows = torch.zeros((100, 4), device=cuda)
    with pytest.raises(ValueError):
        dfscan.cic_tile_prefix_rows(rows[::2], (8, 8, 8), 0, 2, 256)
    with pytest.raises(ValueError):  # 4-byte aligned, not 16
        dfscan.cic_tile_prefix_rows(rows.view(-1)[1:397].view(99, 4),
                                    (8, 8, 8), 0, 2, 256)
    with pytest.raises(ValueError):
        dfscan.cic_tile_prefix_rows(rows, (8, 8, 8), 6, 4, 256)
    with pytest.raises(TypeError):
        dfscan.cic_tile_prefix_rows(rows.double(), (8, 8, 8), 0, 2, 256)
    before = dict(dfscan.ROUTES)
    assert dfscan.cic_tile_prefix_rows(rows[:0], (8, 8, 8), 0, 2,
                                       1).shape == (4, 0)
    assert dfscan.ROUTES == before


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["pairs", "all"])
@pytest.mark.parametrize("D,local_shape", [
    (1, (16,)), (2, (8, 5)), (3, (8, 8, 8)),
])
@pytest.mark.parametrize("tile", [
    1, 3, 5, 31, 33, 64, 100, 256, 257, 1000, 1024,
])
def test_dfscan_cic_rows_route_matches_plain(cuda, D, local_shape, tile,
                                             group):
    """The fused route on the sorted rows (every instance: D = 1..3, R =
    1..32) against the plain twin on the planar payload those rows hold:
    bit for bit, one "packed" launch a group."""
    n = 77 * max(tile, 32) + 13
    payload = _cic_payload(np.random.default_rng(tile * 10 + D), D, n,
                           local_shape)
    rows = torch.zeros((n, 4))
    rows[:, :D + 1] = payload.t()
    rows, payload = rows.to(cuda), payload.to(cuda)
    g = 2 if group == "pairs" else 1 << D
    for c0 in range(0, 1 << D, g):
        before = dict(dfscan.ROUTES)
        got = dfscan.cic_tile_prefix_rows(rows, local_shape, c0, g, tile)
        want = dfscan.cic_tile_prefix_plain(payload, local_shape, c0, g,
                                            tile)
        torch.cuda.synchronize()
        assert dfscan.ROUTES == dict(before, packed=before["packed"] + 1)
        assert got.shape == want.shape == (2 * g, -(-n // tile) * tile)
        assert _bits_equal(got, want)


def _sort_keys(r, n, bits):
    """Keys for a sort over ``bits`` bits: ``n_seg = 2^(bits - 1)``
    segments (so ``n_seg.bit_length() == bits``), drawn from a pool a
    quarter of ``n`` wide so that ties are dense, both ends of the range,
    and the sentinel ``n_seg`` on ~15% of the rows."""
    n_seg = 1 << (bits - 1)
    pool = r.integers(0, n_seg, size=max(1, n // 4))
    key = r.choice(pool, n).astype(np.int32)
    key[r.random(n) < 0.15] = n_seg
    if n > 2:
        key[:2] = (0, n_seg - 1)
    return key, n_seg


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 22, 28])
@pytest.mark.parametrize("n", [1, 1_000_003, (1 << 24) + 1])
def test_sort_rows_bit_equal_to_the_stable_sort_and_gather(cuda, n, bits):
    """``sort_rows`` on the card (one launch: the pack and cub's passes
    over the key's own bits) against ``torch.sort(stable=True)`` and
    ``index_select`` on the card: keys and rows bit for bit, on keys
    dense with ties and the sentinel; the rows' NaN and signed zeros
    kept; the inputs untouched."""
    r = np.random.default_rng(n + bits)
    key, n_seg = _sort_keys(r, n, bits)
    assert n_seg.bit_length() == bits
    rel = (r.random((3, n)) * 64).astype(np.float32)
    mass = r.uniform(0.5, 2.0, n).astype(np.float32)
    if n > 4:
        rel[0, 2:5] = (-0.0, np.nan, np.float32(3e38))
        mass[3] = -0.0
    key_t, rel_t, mass_t = (torch.from_numpy(a).to(cuda)
                            for a in (key, rel, mass))
    before = rowsort.KERNEL.launches
    keys_s, rows_s = rowsort.sort_rows(key_t, rel_t, mass_t, bits)
    want_k, want_r = rowsort.sort_rows_plain(key_t, rel_t, mass_t, bits)
    torch.cuda.synchronize()
    assert rowsort.KERNEL.launches == before + 1
    assert torch.equal(keys_s, want_k)
    assert _bits_equal(rows_s, want_r)
    assert torch.equal(key_t.cpu(), torch.from_numpy(key))
    out = (torch.empty_like(keys_s), torch.empty_like(rows_s))
    got = rowsort.sort_rows(key_t, rel_t, mass_t, bits, _out=out)
    torch.cuda.synchronize()
    assert got[0] is out[0] and got[1] is out[1]
    assert torch.equal(out[0], want_k) and _bits_equal(out[1], want_r)


@pytest.mark.cuda
def test_sort_rows_refuses_what_it_cannot_take(cuda):
    key = torch.zeros(10, dtype=torch.int32, device=cuda)
    rel = torch.zeros((3, 10), device=cuda)
    mass = torch.zeros(10, device=cuda)
    with pytest.raises(ValueError):
        rowsort.sort_rows(key, rel.t().contiguous().t(), mass, 4)
    with pytest.raises(TypeError):
        rowsort.sort_rows(key, torch.zeros((4, 10), device=cuda), mass, 4)
    k, rows = rowsort.sort_rows(key[:0], rel[:, :0], mass[:0], 4)
    assert k.shape == (0,) and rows.shape == (0, 4)
    with pytest.raises(ValueError):  # rows 4 bytes off a 16-byte line
        dfscan.cic_tile_prefix_rows(
            torch.zeros(45, device=cuda)[1:].view(11, 4), (8, 8, 8), 0, 2,
            256)


@pytest.mark.cuda
def test_sort_rows_resource_usage_lists_cub_kernels(cuda):
    """``rowsort.KERNEL.resource_usage()`` lists the pack's instances and
    cub's four kernels of the sort, none spilling: ``csrc/rowsort.cu``
    names cub's kernels as cub 2.8 instantiates them, and another cub
    fails here rather than leave them out of the table."""
    usage = rowsort.KERNEL.resource_usage()
    assert set(usage) == {f"rowsort_pack_kernel<{d}>" for d in (1, 2, 3)} | {
        f"cub::DeviceRadixSort{k}Kernel"
        for k in ("Histogram", "ExclusiveSum", "Onesweep", "SingleTile")}
    assert all(u["local_bytes"] == 0 for u in usage.values())


def _vrank_deposit_args(r, D, n_per, cuda):
    """The CIC cell's vrank shape cut to D axes: 8 vranks of 64^D cells
    (a (2, 2, 2), (4, 2) or (8,) vrank grid over the unit box), ``n_per``
    rows a vrank in its own block, 90% valid, masses that are not 1,
    rows on the block's faces."""
    vgrid = {1: (8,), 2: (4, 2), 3: (2, 2, 2)}[D]
    V, vblock = 8, (64,) * D
    cells = np.array(list(np.ndindex(*vgrid)), np.float32)  # [V, D]
    width = 1.0 / np.asarray(vgrid, np.float32)
    lo = (cells * width).astype(np.float32)
    u = r.random((D, V, n_per), dtype=np.float32)
    u[:, :, :3] = 0.0
    u[0, :, 3:6] = np.float32(1.0) - np.float32(2 ** -24)
    pos = (lo.T[:, :, None] + u * width[:, None, None]).astype(np.float32)
    m = V * n_per
    args = [pos.reshape(D, m), r.uniform(0.5, 2.0, m).astype(np.float32),
            r.random(m) < 0.9, lo,
            (np.asarray(vblock, np.float32) / width).astype(np.float32)]
    return [torch.from_numpy(a).to(cuda) for a in args], vblock


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 2, 3])
def test_vrank_deposit_rows_route_bit_equal_to_plain(cuda, D):
    """``cic_deposit_vranks_planar`` at the CIC cell's vrank shape, 2^21
    rows a vrank (2^24 in all: the 8 channels in one group): the payload
    sort and kernel 5 on the sorted rows, bit-equal to ``plain=True``."""
    from mpi_grid_redistribute_tpu_torch.ops import _build

    args, vblock = _vrank_deposit_args(np.random.default_rng(D), D, 1 << 21,
                                       cuda)
    _build.reset_counts()
    got = deposit.cic_deposit_vranks_planar(*args, vblock)
    torch.cuda.synchronize()
    assert rowsort.KERNEL.launches == 1
    assert dfscan.ROUTES == {"rows": 0, "packed": 1}
    want = deposit.cic_deposit_vranks_planar(*args, vblock, plain=True)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)
    total = float(args[1][args[2]].double().sum())
    assert abs(float(got.double().sum()) - total) <= 1e-6 * total


@pytest.mark.cuda
def test_vrank_deposit_counts_one_sort_and_four_packed_launches(cuda):
    """Above 2^24 rows (the CIC cell's deposit), a deposit makes 1 payload
    sort launch and 4 packed kernel-5 launches (groups of 2), no planar or
    rows-route one, bit-equal to ``plain=True``."""
    from mpi_grid_redistribute_tpu_torch.ops import _build

    args, vblock = _vrank_deposit_args(np.random.default_rng(3), 3,
                                       (1 << 21) + 1, cuda)
    _build.reset_counts()
    got = deposit.cic_deposit_vranks_planar(*args, vblock)
    torch.cuda.synchronize()
    counts = _build.counts()
    assert counts["sort_rows"] == 1 and counts["tile_df_cumsum_rows"] == 4
    assert dfscan.ROUTES == {"rows": 0, "packed": 4}
    want = deposit.cic_deposit_vranks_planar(*args, vblock, plain=True)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)

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
    (4, (4, 4, 4, 4), 20_000, 256),
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
@pytest.mark.parametrize("d", [1, 2, 3, 4])
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
def test_segdep_d5_runs_plain(cuda):
    """D = 5 is past the kernel's 4: ``segdep.geometry``'s shape rule
    sends it to the plain version, with no launch."""
    r = np.random.default_rng(5)
    keys = torch.from_numpy(
        np.sort(r.integers(0, 33, 3000)).astype(np.int32)).to(cuda)
    rel = torch.from_numpy(
        (r.integers(0, 8, (5, 3000)) * 0.25).astype(np.float32)).to(cuda)
    before = segdep.KERNEL.launches
    got = segdep.segsum_sorted(keys, rel, None, 32, (2,) * 5)
    want = segdep.segsum_sorted_plain(keys, rel, None, 32, (2,) * 5)
    torch.cuda.synchronize()
    assert segdep.KERNEL.launches == before
    assert got.shape == (32, 32) and _bits_equal(got, want)


@pytest.mark.cuda
def test_segdep_kernel_raises_on_bad_input(cuda):
    keys = torch.zeros(16, dtype=torch.int32, device=cuda)
    rel = torch.zeros((4, 16), device=cuda)
    with pytest.raises(ValueError):  # vblock does not match D = 4
        segdep.segsum_sorted(keys, rel, None, 16, (2, 2, 2))
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
def test_scan_deposit_at_tile_2048_launches_kernel_5(cuda):
    """``cic_deposit_device_planar(..., tile=2048)``: kernel 5 on its block
    route, bit-equal to the port's CPU run."""
    r = np.random.default_rng(2048)
    n, block = 50_000, (8, 8, 8)
    args = [torch.from_numpy(a) for a in (
        r.random((3, n), dtype=np.float32), r.random(n, dtype=np.float32),
        r.random(n) < 0.9)] + [torch.zeros(3), torch.full((3,), 8.0)]
    before = dfscan.KERNEL.launches
    routes = dict(dfscan.ROUTES)
    got = deposit.cic_deposit_device_planar(
        *(a.to(cuda) for a in args), block, tile=2048)
    torch.cuda.synchronize()
    assert dfscan.KERNEL.launches == before + 1
    # the fused route serves the register route's tiles: this one keeps
    # the plain stages around the rows route, and the planar payload sort
    assert dfscan.ROUTES == {"rows": routes["rows"] + 1,
                             "packed": routes["packed"]}
    want = deposit.cic_deposit_device_planar(*args, block, tile=2048)
    assert _bits_equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,groups", [(3_000_017, 1), ((1 << 24) + 4099, 4)])
def test_scan_deposit_fused_route_bit_equal_to_plain(cuda, n, groups):
    """``cic_deposit_device_planar`` on the card against ``plain=True``
    (the planar sort and the plain stages, on the card too): one payload
    sort launch, then below 2^24 rows all 8 channels in one fused launch
    on the sorted rows, above it 4 launches of 2; no planar or rows-route
    launch; bit for bit, with masses that are not 1, invalid rows and
    rows on the block's faces."""
    from mpi_grid_redistribute_tpu_torch.ops import _build

    r = np.random.default_rng(n)
    block = (64, 64, 64)
    pos = r.random((3, n), dtype=np.float32)
    pos[:, :5] = 0.0
    pos[0, 5:9] = np.float32(1.0) - np.float32(2 ** -24)
    args = [torch.from_numpy(a).to(cuda) for a in (
        pos, r.uniform(0.5, 2.0, n).astype(np.float32), r.random(n) < 0.9)]
    args += [torch.zeros(3, device=cuda), torch.full((3,), 64.0, device=cuda)]
    _build.reset_counts()
    got = deposit.cic_deposit_device_planar(*args, block)
    torch.cuda.synchronize()
    assert dfscan.ROUTES == {"rows": 0, "packed": groups}
    assert dfscan.KERNEL.launches == groups
    assert rowsort.KERNEL.launches == 1
    want = deposit.cic_deposit_device_planar(*args, block, plain=True)
    torch.cuda.synchronize()
    # plain: no launch
    assert dfscan.ROUTES == {"rows": 0, "packed": groups}
    assert rowsort.KERNEL.launches == 1
    assert _bits_equal(got, want)
    total = float(args[1][args[2]].double().sum())
    assert abs(float(got.double().sum()) - total) <= 1e-6 * total


@pytest.mark.cuda
@pytest.mark.parametrize("dyadic", [True, False])
def test_mxu_deposit_in_4d_launches_kernel_4(cuda, dyadic):
    """A 4-D mxu deposit: kernel 4 at D = 4, bit-equal to the port's CPU
    run on dyadic positions, within 2e-5 otherwise."""
    r = np.random.default_rng(4)
    n, block = 40_000, (6, 6, 6, 6)
    pos = r.random((4, n), dtype=np.float32)
    if dyadic:
        pos = np.floor(pos * 24) / 24  # multiples of 1/4 cell
        pos = pos.astype(np.float32)
    args = [torch.from_numpy(a) for a in (
        pos, np.ones(n, np.float32), r.random(n) < 0.9)] + [
        torch.zeros(4), torch.full((4,), 6.0)]
    before = segdep.KERNEL.launches
    got = deposit.cic_deposit_device_mxu(*(a.to(cuda) for a in args), block)
    torch.cuda.synchronize()
    assert segdep.KERNEL.launches == before + 1
    want = deposit.cic_deposit_device_mxu(*args, block)
    assert got.shape == (7, 7, 7, 7)
    if dyadic:
        assert _bits_equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)


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


def _canonical_inputs(r, R, n):
    pos = r.random((R * n, 3), dtype=np.float32)
    vel = r.standard_normal((R * n, 3)).astype(np.float32)
    vel.view(np.uint32)[:4, 0] = [0x7FC0BEEF, 0x00000001, 0x80000000,
                                  0x007FFFFF]
    ids = np.arange(R * n, dtype=np.int32)
    tag = (np.arange(R * n) % 7).astype(np.int16)
    return pos, vel, ids, tag


def _same_result(a, b):
    def u8(x):
        return x.cpu().contiguous().view(torch.uint8)

    assert torch.equal(u8(a.positions), u8(b.positions))
    assert torch.equal(u8(a.count), u8(b.count))
    for x, y in zip(a.fields, b.fields):
        assert torch.equal(u8(x), u8(y))
    for f in ("send_counts", "recv_counts", "dropped_send", "dropped_recv",
              "needed_capacity"):
        assert torch.equal(getattr(a.stats, f).cpu(), getattr(b.stats, f))


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(2, 2, 2), (3, 2, 1)])
@pytest.mark.parametrize("case", ["auto", "rowmajor", "int16", "edges",
                                  "tight"])
def test_canonical_call_on_card_matches_cpu_run(cuda, grid, case):
    """``GridRedistribute.redistribute`` on the card (the default device)
    byte-equal to the same call on the CPU port, stats included."""
    r = np.random.default_rng(len(case) + sum(grid))
    R = int(np.prod(grid))
    pos, vel, ids, tag = _canonical_inputs(r, R, 3000)
    fields = (vel, ids, tag) if case == "int16" else (vel, ids)
    kw = dict(capacity_factor=3.0)
    if case == "rowmajor":
        kw["engine"] = "rowmajor"
    if case == "tight":
        kw = dict(capacity=64, out_capacity=2500, on_overflow="ignore")
    if case == "edges":
        # axis 0 non-uniform, the others uniform (the floor-multiply path)
        kw["edges"] = [
            tuple(np.linspace(0.0, 1.0, g + 1)) if d else
            tuple(np.concatenate([[0.0], np.sort(r.random(g - 1)), [1.0]]))
            for d, g in enumerate(grid)]
    dom = Domain(0.0, 1.0, periodic=True)
    a = GridRedistribute(dom, grid, **kw).redistribute(pos, *fields)
    b = GridRedistribute(dom, grid, device="cpu", **kw).redistribute(
        pos, *fields)
    torch.cuda.synchronize()
    assert a.positions.is_cuda
    _same_result(a, b)
    if case == "tight":
        assert int(a.stats.dropped_send.sum()) > 0


@pytest.mark.cuda
def test_canonical_deferred_check_on_card(cuda):
    """The deferred overflow check's pinned copy behind a CUDA event: no
    blocking read after calibration, and a loss between samples raises at
    the flush and grows the capacity."""
    r = np.random.default_rng(3)
    n = 8 * 2000
    pos = torch.from_numpy(r.random((n, 3), dtype=np.float32)).to(cuda)
    ids = torch.arange(n, dtype=torch.int32, device=cuda)
    rd = GridRedistribute(Domain(0.0, 1.0, periodic=True), (2, 2, 2),
                          capacity_factor=16.0, check_every=4)
    for _ in range(3):
        rd.redistribute(pos, ids)
    fetches = rd._blocking_fetches
    for _ in range(9):
        rd.redistribute(pos, ids)
    assert rd._blocking_fetches == fetches
    assert rd._pending_check[0].is_pinned()
    rd.flush_overflow_checks()
    old = rd.capacity = 1  # force drops on the next call
    rd.redistribute(pos, ids)
    with pytest.raises(RuntimeError, match="deferred overflow check"):
        rd.flush_overflow_checks()
    assert rd.capacity > old


def _halo_state(r, grid_shape, n, fill=0.8):
    """Owned rows ``[V, n, 3]`` float32 (padding rows zero), counts, and
    an int32 id row, for the halo engines."""
    g = ProcessGrid(grid_shape)
    V = g.nranks
    pos = np.zeros((V, n, 3), np.float32)
    count = r.integers(int(fill * n), n + 1, V).astype(np.int32)
    for v in range(V):
        cell = np.asarray(g.cell_of_rank(v))
        pos[v, :count[v]] = ((cell + r.random((count[v], 3)))
                             / np.asarray(grid_shape)).astype(np.float32)
    ids = np.arange(V * n, dtype=np.int32).reshape(V, n)
    return pos, count, ids


def _u8(x):
    return x.cpu().contiguous().view(torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("grid_shape,periodic", [
    ((2, 2, 2), True), ((2, 2, 2), False), ((4, 2, 1), True)])
@pytest.mark.parametrize("case", ["roomy", "overflow", "two_sorts"])
def test_halo_engines_on_card_match_cpu_run(cuda, grid_shape, periodic,
                                            case):
    """Both vrank halo engines on the card bit-equal to the port's CPU
    run (ghosts, ids, counts, overflow), roomy and dropping capacities
    and the two-sort band path; planar == row-major on the card."""
    r = np.random.default_rng(len(case) + sum(grid_shape))
    pos, count, ids = _halo_state(r, grid_shape, 3000)
    dom = Domain(0.0, 1.0, periodic=periodic)
    grid = ProcessGrid(grid_shape)
    w = 0.25 if case == "two_sorts" else 0.08
    H, G = (64, 200) if case == "overflow" else halo.default_capacities(
        dom, grid, w, 3000)
    fused = np.ascontiguousarray(np.concatenate(
        [pos.transpose(0, 2, 1), ids[:, None, :].view(np.float32)], axis=1))
    outs = {}
    for dev in ("cuda", "cpu"):
        c = torch.from_numpy(count).to(dev)
        outs[dev, "rm"] = halo.vrank_halo_fn(dom, grid, w, H, G)(
            torch.from_numpy(pos).to(dev), c, torch.from_numpy(ids).to(dev))
        outs[dev, "pl"] = halo.vrank_halo_planar_fn(dom, grid, w, H, G)(
            torch.from_numpy(fused).to(dev), c)
    torch.cuda.synchronize()
    for eng in ("rm", "pl"):
        assert outs["cuda", eng][0].is_cuda
        for a, b in zip(outs["cuda", eng], outs["cpu", eng]):
            assert torch.equal(_u8(a), _u8(b))
    rg, rc, rid, ro = outs["cuda", "rm"]
    pg, pc, po = outs["cuda", "pl"]
    assert torch.equal(rc, pc) and torch.equal(ro, po)
    assert torch.equal(_u8(pg[:, :3].transpose(1, 2)), _u8(rg))
    assert torch.equal(pg[:, 3].view(torch.int32), rid)
    assert (int(ro.sum()) > 0) == (case == "overflow")


@pytest.mark.cuda
def test_halo_engines_make_no_host_sync(cuda):
    """An engine exchange on the card never waits for the device: torch's
    sync debug mode raises on any synchronizing call."""
    r = np.random.default_rng(5)
    pos, count, ids = _halo_state(r, (2, 2, 2), 20000)
    dom, grid = Domain(0.0, 1.0, periodic=True), ProcessGrid((2, 2, 2))
    H, G = halo.default_capacities(dom, grid, 0.05, 20000)
    p = torch.from_numpy(pos).to(cuda)
    c = torch.from_numpy(count).to(cuda)
    fused = p.transpose(1, 2).contiguous()
    rm = halo.vrank_halo_fn(dom, grid, 0.05, H, G)
    pl = halo.vrank_halo_planar_fn(dom, grid, 0.05, H, G)
    rm(p, c), pl(fused, c)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            rm(p, c)
            pl(fused, c)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["grow", "raise", "ignore"])
def test_halo_call_on_card_matches_cpu_run(cuda, policy):
    """``GridRedistribute.halo`` on the card (the default device) under
    each overflow policy on clustered rows that overflow the starved
    budgets: the CPU port's bits, grown capacities and errors."""
    r = np.random.default_rng(9)
    pos = (r.random((8 * 2000, 3)) ** 4).astype(np.float32)
    ids = np.arange(8 * 2000, dtype=np.int32)
    dom = Domain(0.0, 1.0, periodic=True)
    res = GridRedistribute(dom, (2, 2, 2), device="cpu", capacity_factor=8.0,
                           out_capacity=8 * 2000).redistribute(pos, ids)
    kw = dict(width=0.12, count=res.count, headroom=0.05)
    a = GridRedistribute(dom, (2, 2, 2), on_overflow=policy)
    b = GridRedistribute(dom, (2, 2, 2), device="cpu", on_overflow=policy)
    if policy == "raise":
        with pytest.raises(RuntimeError, match="halo overflow"):
            a.halo(res.positions, *res.fields, **kw)
        return
    ha = a.halo(res.positions.to(cuda), *(f.to(cuda) for f in res.fields),
                **kw)
    hb = b.halo(res.positions, *res.fields, **kw)
    torch.cuda.synchronize()
    assert ha.ghost_positions.is_cuda
    for x, y in ((ha.ghost_positions, hb.ghost_positions),
                 (ha.ghost_count, hb.ghost_count), (ha.overflow, hb.overflow),
                 (ha.ghost_fields[0], hb.ghost_fields[0])):
        assert torch.equal(_u8(x), _u8(y))
    assert a._halo_caps == b._halo_caps
    assert (int(ha.overflow.sum()) > 0) == (policy == "ignore")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["auto", "planar"])
def test_assignment_loop_on_card_matches_cpu_run(cuda, engine):
    """Config 2's steady state at a small width: the LPT-assigned loop on
    the card, bit-equal to the CPU run; kernel 1 never launches, kernel 2
    once a step."""
    total = config2_clustered.steady_total(1024)
    out = {}
    for dev in ("cuda", "cpu"):
        setup = config2_clustered.steady_setup(total, dev)
        cfg, vgrid, state = config2_clustered.steady_workload(
            setup, "imbalanced", engine=engine
        )
        k1, k2 = driftbin.KERNEL.launches, overlay.KERNEL.launches
        out[dev] = nbody.make_migrate_loop(cfg, 5, vgrid=vgrid,
                                           device=dev)(*state)
        torch.cuda.synchronize()
        if dev == "cuda":
            assert driftbin.KERNEL.launches == k1
            assert overlay.KERNEL.launches == k2 + 5
    a, b = out["cuda"], out["cpu"]
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x.cpu().view(torch.uint8), y.view(torch.uint8))
    for f in ("sent", "received", "population", "backlog", "flow",
              "fast_path"):
        x, y = getattr(a[3], f), getattr(b[3], f)
        assert (x is None and y is None) or torch.equal(x.cpu(), y), f
    assert int(a[3].sent.sum()) > 0


@pytest.mark.cuda
def test_config3_shape_on_card_matches_plain_run(cuda):
    """(8, 8, 1) as 64 vranks: kernels 1 and 2 against the plain-version
    run, bit for bit, and against the CPU run."""
    cfg, vgrid, (pos, vel, alive) = config3_slab.build(n_local=4096)
    runs = [nbody.make_migrate_loop(cfg, 4, vgrid=vgrid, plain=plain,
                                    device=dev)(pos, vel, alive)
            for plain, dev in ((False, None), (True, None), (False, "cpu"))]
    torch.cuda.synchronize()
    for other in runs[1:]:
        for x, y in zip(runs[0][:3], other[:3]):
            assert torch.equal(x.cpu().view(torch.uint8),
                               y.cpu().view(torch.uint8))
        for f in ("sent", "received", "population", "backlog", "flow"):
            assert torch.equal(getattr(runs[0][3], f).cpu(),
                               getattr(other[3], f).cpu()), f
    assert int(runs[0][3].dropped_recv.sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("each_step", [True, False])
def test_segment_deposit_loop_on_card_matches_cpu_run(cuda, each_step):
    grid = (2, 2, 2)
    n_local = 4096
    v, cap, budget = common.drift_sizing(grid, n_local, 0.9, 0.02)
    pos, vel, alive = common.uniform_state(
        grid, n_local, 0.9, np.random.default_rng(4), vel_scale=4 * v
    )
    cfg = nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True), grid=ProcessGrid((1, 1, 1)),
        dt=1.0, capacity=cap, n_local=n_local, local_budget=budget,
        deposit_shape=(16, 16, 16), deposit_method="segment",
    )
    vgrid = ProcessGrid(grid)
    a = nbody.make_migrate_loop(cfg, 4, vgrid=vgrid,
                                deposit_each_step=each_step)(pos, vel, alive)
    b = nbody.make_migrate_loop(cfg, 4, vgrid=vgrid, device="cpu",
                                deposit_each_step=each_step)(pos, vel, alive)
    torch.cuda.synchronize()
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x.cpu().view(torch.uint8), y.view(torch.uint8))
    rho = a[4].cpu()
    # index_add_ on the card adds with atomics, in no fixed order
    torch.testing.assert_close(rho, b[4], rtol=2e-5, atol=2e-5)
    live = int(alive.sum())
    assert abs(float(rho.double().sum()) - live) <= 1e-5 * live


@pytest.mark.cuda
def test_two_rank_gloo_world_on_card_matches_cpu_world(cuda):
    """Two processes sharing the card over gloo (the multi-rank path on
    one card): one migrate step with its scan deposit, bit-equal to the
    same world on the CPU, kernel 2 and kernel 5 launched once on each
    rank; then one canonical drift step with its scan deposit (kernel 5
    once), a halo with each engine and a hierarchical call over two
    pods, each bit-equal to the CPU world. Gloo moves the card's tensors
    itself (no staging): every collective gives the CPU world's bits."""
    from mpi_grid_redistribute_tpu_torch.bench import multirank
    from mpi_grid_redistribute_tpu_torch.parallel import launch

    target = "mpi_grid_redistribute_tpu_torch.bench.multirank:small_loop"
    card = launch.run_world(target, 2, device="cuda", timeout=300,
                            pg_timeout=120)
    cpu = launch.run_world(target, 2, device="cpu", timeout=300,
                           pg_timeout=120)
    for r in range(2):
        (state_c, stats_c, rho_c, launches, coll_c, slice_c), (
            state_h, stats_h, rho_h, _, coll_h, slice_h) = card[r], cpu[r]
        # the drift step, the halo and the hierarchical call
        assert slice_c["launches"]["tile_df_cumsum_rows"] == 1
        assert not any(slice_h["launches"].values())
        for k in slice_h:
            if k != "launches":
                assert multirank._same_tree(slice_c[k], slice_h[k]), k
        assert slice_h["hier"][4] == "hierarchical"
        assert int(slice_h["halo_auto"][2].sum()) > 0
        # every collective, each backend operation beneath them included,
        # moves the card's tensors as the CPU's
        for k in coll_h:
            assert coll_c[k].tobytes() == coll_h[k].tobytes(), k
        for a, b in zip(state_c, state_h):
            assert a.tobytes() == b.tobytes()
        for k in stats_h:
            np.testing.assert_array_equal(stats_c[k], stats_h[k])
        assert rho_c.tobytes() == rho_h.tobytes()
        assert launches["overlay_scatter_planar"] == 1
        assert launches["tile_df_cumsum_rows"] == 1
        assert launches["drift_wrap_bin"] == 0
    assert int(cpu[0][1]["sent"].sum()) > 0


def _tree_on_cpu_equal(a, b) -> bool:
    """Bit equality of two outputs (tensors, tuples, dicts; ``None``
    leaves), the first from the card."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(
            _tree_on_cpu_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(
            _tree_on_cpu_equal(x, y) for x, y in zip(a, b))
    if a is None:
        return b is None
    return a.shape == b.shape and torch.equal(
        a.cpu().contiguous().view(torch.uint8),
        b.contiguous().view(torch.uint8))


def _capture_landings(macro, state):
    """Run ``macro`` once, copying the operands of its first and its last
    landing scatter: ``[(flat, targets, cols), ...]``."""
    seen = []
    orig = migrate._land_scatter

    def rec(flat, targets, cols, impl="overlay", plain=False):
        seen.append((flat.clone(), targets.clone(), cols.clone()))
        del seen[1:-1]
        return orig(flat, targets, cols, impl, plain)

    migrate._land_scatter = rec
    try:
        macro(*state)
    finally:
        migrate._land_scatter = orig
    return seen


@pytest.mark.cuda
def test_overlay_kernel_at_the_pipelined_landing_k8_k9(cuda):
    """Kernel 2 at the pipelined chunk's own landings: the augmented
    state with the next-step key row (K = 9, every landing but the last)
    and the final one (K = 8), bit-equal to the plain version."""
    from mpi_grid_redistribute_tpu_torch.bench import service_chunk

    rd, state = service_chunk.prepare(4096, cuda)
    _, pipe = service_chunk.build(rd, state, 4)
    seen = _capture_landings(pipe, state)
    assert [f.shape[0] for f, _, _ in seen] == [9, 8]
    for flat, t, cols in seen:
        assert int(((t >= 0) & (t < flat.shape[1])).sum()) > 0
        got = overlay.overlay_scatter_planar(flat.clone(), t, cols)
        want = overlay.overlay_scatter_planar_plain(flat.clone(), t, cols)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_service_chunks_on_card_match_cpu_run(cuda):
    """The sequential and the pipelined chunk (16 steps) on the card,
    bit-equal to the CPU run (state and ys); no host sync inside either
    (sync debug mode "error"); kernel 2 launched once a step by the
    pipelined chunk, no kernel by the sequential one."""
    from mpi_grid_redistribute_tpu_torch.bench import service_chunk
    from mpi_grid_redistribute_tpu_torch.ops import _build

    outs = {}
    for dev in (cuda, torch.device("cpu")):
        rd, state = service_chunk.prepare(4096, dev)
        macros = service_chunk.build(rd, state, 16)
        res = []
        for macro in macros:
            if dev.type == "cuda":
                torch.cuda.synchronize()
                _build.reset_counts()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = macro(*state)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                res.append((out, _build.counts()))
            else:
                res.append((macro(*state), None))
        outs[dev.type] = res
    (seq_c, seq_n), (pipe_c, pipe_n) = outs["cuda"]
    assert not any(seq_n.values())
    assert pipe_n["overlay_scatter_planar"] == 16
    assert sum(pipe_n.values()) == 16
    for (card, _), (cpu, _) in zip(outs["cuda"], outs["cpu"]):
        assert _tree_on_cpu_equal(card, cpu)
    service_chunk.check_pair(seq_c, pipe_c)


def _driver_cfg(dev, **kw):
    from mpi_grid_redistribute_tpu_torch.service import DriverConfig

    base = dict(grid_shape=(2, 2, 2), n_local=4096, steps=24, seed=3,
                device=dev)
    base.update(kw)
    return DriverConfig(**base)


def _driver_state(cfg, steps=None):
    from mpi_grid_redistribute_tpu_torch.service import ServiceDriver

    drv = ServiceDriver(cfg)
    drv.init_state()
    drv.run(max_steps=steps)
    drv.close()
    return drv, drv.host_state()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,pipeline", [(1, False), (7, False),
                                            (7, True)])
def test_service_driver_on_card_matches_cpu_run(cuda, chunk, pipeline):
    """The service driver's eager, chunked and pipelined legs on the
    card, byte-equal to the same legs on the CPU at n_local 4096; the
    state stays on the card."""
    drv, got = _driver_state(_driver_cfg(None, chunk=chunk,
                                         pipeline=pipeline))
    assert all(t.is_cuda for t in drv.state)
    _, want = _driver_state(_driver_cfg("cpu", chunk=chunk,
                                        pipeline=pipeline))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [False, True])
def test_service_driver_chunk_has_no_host_sync(cuda, pipeline):
    """Every chunk the driver issues (and the staging of its ys) runs
    under sync debug mode "error"; kernel 2 once a step when
    pipelined."""
    from mpi_grid_redistribute_tpu_torch.ops import _build
    from mpi_grid_redistribute_tpu_torch.service import ServiceDriver

    drv = ServiceDriver(_driver_cfg(None, chunk=8, steps=16,
                                    pipeline=pipeline))
    drv.init_state()
    real_macro, real_stage = drv._macro_fn, drv._stage_ys
    issued = []

    def guarded(n):
        macro, cap, out_cap = real_macro(n)

        def run(*state):
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = macro(*state)
                issued.append(n)
                return out
            finally:
                torch.cuda.set_sync_debug_mode("default")

        return run, cap, out_cap

    def stage(ys, start):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_stage(ys, start)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    drv._macro_fn, drv._stage_ys = guarded, stage
    torch.cuda.synchronize()
    _build.reset_counts()
    drv.run()
    torch.cuda.synchronize()
    assert issued == [8, 8]
    assert _build.counts()["overlay_scatter_planar"] == (16 if pipeline
                                                         else 0)
    drv.close()


@pytest.mark.cuda
def test_snapshot_from_the_card_restores_on_the_cpu(cuda, tmp_path):
    from mpi_grid_redistribute_tpu_torch.service import ServiceDriver

    cfg = _driver_cfg(None, chunk=4, snapshot_every=8, steps=16,
                      snapshot_dir=str(tmp_path))
    card, state = _driver_state(cfg)
    cpu = ServiceDriver(_driver_cfg("cpu", snapshot_every=8,
                                    snapshot_dir=str(tmp_path)))
    assert cpu.restore_latest() and cpu.step == 16
    assert all(t.device.type == "cpu" for t in cpu.state)
    for a, b in zip(cpu.host_state(), state):
        assert a.tobytes() == b.tobytes()


@pytest.mark.cuda
def test_chunk_ys_reach_the_host_before_the_next_chunk_ends(cuda):
    """The overlap: chunk k+1 is issued before chunk k's ys are read, and
    those reads (waiting on chunk k's own event) finish while chunk k+1
    is still running on the card."""
    from mpi_grid_redistribute_tpu_torch.service import ServiceDriver

    drv = ServiceDriver(_driver_cfg(None, n_local=1 << 18, chunk=8,
                                    steps=40))
    drv.init_state()
    ends, seen = [], []
    real_stage, real_wait = drv._stage_ys, drv._wait_staged

    def stage(ys, start):
        staged = real_stage(ys, start)
        ends.append(staged[2])
        return staged

    def wait(staged):
        out = real_wait(staged)
        out[0]["block"].numpy().sum()  # the host read of chunk k's ys
        i = ends.index(staged[2])
        if i + 1 < len(ends):  # a successor was issued before the read
            seen.append(ends[i + 1].query())
        return out

    drv._stage_ys, drv._wait_staged = stage, wait
    drv.run()
    drv.close()
    assert len(seen) >= 3, seen
    assert not any(seen), f"chunk k+1 had ended at chunk k's read: {seen}"


@pytest.mark.cuda
def test_store_drain_reads_nothing_from_the_card(cuda, tmp_path):
    """The history plane on the card: every store drain and an incident
    capture run under sync debug mode "error" (a read of a device value
    there raises); with a drain at the end of every chunk, each chunk
    but the last still has its successor issued before its host reads
    (whether the card is still busy then is timing, measured by
    ``bench/service_driver.py``'s store legs); the store verifies with
    the recorder's counts."""
    from mpi_grid_redistribute_tpu_torch.service import ServiceDriver
    from mpi_grid_redistribute_tpu_torch.telemetry.store import StoreReader

    drv = ServiceDriver(_driver_cfg(
        None, n_local=1 << 18, chunk=8, steps=40,
        store_dir=str(tmp_path / "store"),
        incident_dir=str(tmp_path / "inc")))
    drv.init_state()
    ends, ahead, drains = [], [], []
    real_stage, real_wait = drv._stage_ys, drv._wait_staged
    real_drain = drv._store.drain

    def stage(ys, start):
        staged = real_stage(ys, start)
        ends.append(staged[2])
        return staged

    def wait(staged):
        ahead.append(len(ends) - 1 - ends.index(staged[2]))
        return real_wait(staged)

    def drain(recorder):
        torch.cuda.set_sync_debug_mode("error")
        try:
            drains.append(real_drain(recorder))
        finally:
            torch.cuda.set_sync_debug_mode("default")

    drv._stage_ys, drv._wait_staged = stage, wait
    drv._store.drain = drain
    drv.run()
    torch.cuda.set_sync_debug_mode("error")
    try:
        drv._flight.capture(rule="probe", reason="a capture on the card")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    drv.close()
    assert len(drains) == 6  # the end of each chunk of 8, and close()
    assert ahead == [1, 1, 1, 1, 0], ahead
    reader = StoreReader(str(tmp_path / "store"), verify=True)
    assert reader.counts() == drv.recorder.counts()


# ------------------------------------------- counted rooflines (PR 15)


def _count_keys(c):
    return {k: c[k] for k in ("bytes_accessed", "flops", "kernels",
                              "collective_bytes")}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["migrate_sparse_vranks",
                                  "pipelined_macro_step",
                                  "resident_macro_step",
                                  "canonical_planar_vranks"])
def test_program_counts_the_same_on_card_and_cpu(cuda, name):
    from mpi_grid_redistribute_tpu_torch.analysis import progcheck
    from mpi_grid_redistribute_tpu_torch.telemetry import roofline

    spec = progcheck.default_programs()[name]
    counts = []
    for dev in ("cuda", "cpu"):
        fn, args = spec.build(device=dev)
        counts.append(_count_keys(roofline.count_cost(fn, args)))
    assert counts[0] == counts[1]


@pytest.mark.cuda
def test_planar_step_counts_the_same_on_card_and_cpu(cuda):
    from mpi_grid_redistribute_tpu_torch.bench import knockout_stages
    from mpi_grid_redistribute_tpu_torch.telemetry import roofline

    counts = []
    for dev in ("cuda", "cpu"):
        st = knockout_stages.make_state((2, 2, 2), 4096, dev)
        loop = knockout_stages.make_loop((2, 2, 2), 4096, 2, "planar", dev)
        counts.append(_count_keys(roofline.count_cost(loop, st)))
    assert counts[0] == counts[1]
    assert counts[0]["kernels"]["drift_wrap_bin"]["calls"] == 2
    assert counts[0]["kernels"]["overlay_scatter_planar"]["calls"] == 2


@pytest.mark.cuda
def test_migrate_planar_sharded_counts_the_same_on_card_and_cpu(cuda):
    from mpi_grid_redistribute_tpu_torch.analysis import progcheck

    names = ["migrate_planar_sharded"]
    card = progcheck.sharded_costs(names, device="cuda")
    cpu = progcheck.sharded_costs(names, device="cpu")
    assert _count_keys(card[names[0]]) == _count_keys(cpu[names[0]])
    assert card[names[0]]["kernels"]  # kernel 2 lands the flat engine


@pytest.mark.cuda
def test_measured_roofline_fractions_are_at_most_1_05(cuda):
    """At the card's width (2^20 rows a vrank), where a share is real and
    a count too high would read above the roof."""
    from mpi_grid_redistribute_tpu_torch.analysis import progcheck
    from mpi_grid_redistribute_tpu_torch.telemetry import metrics, roofline
    from mpi_grid_redistribute_tpu_torch.telemetry.recorder import (
        StepRecorder,
    )
    from mpi_grid_redistribute_tpu_torch.tools import attribution

    programs = {k: v for k, v in progcheck.default_programs().items()
                if v.topology == "vranks"}
    costs = {}
    measured = roofline.measure_programs(
        programs, device="cuda", n_local=attribution.WIDE_N_LOCAL,
        costs=costs)
    rec = StepRecorder()
    report = roofline.roofline_report(programs, measured, rec, costs=costs)
    assert rec.counts()["roofline"] == len(programs)
    for name, row in report.items():
        assert 0 < row["achieved_fraction"] <= 1.05, (name, row)
    assert roofline.over_roof(report) == []
    text = metrics.from_journal(rec).render_openmetrics()
    assert all(f'roofline_achieved_fraction{{program="{n}"' in text
               for n in programs)


@pytest.mark.cuda
def test_drift_demo_runs_on_the_card(cuda, capsys):
    from mpi_grid_redistribute_tpu_torch.examples import drift_demo

    drift_demo.main(["--n", "4096", "--steps", "3"])
    out = capsys.readouterr().out
    assert "every particle is inside its owner's subdomain" in out
    assert "no particles lost" in out


@pytest.mark.cuda
def test_kernelcheck_is_clean_on_the_card(cuda):
    """K000-K003 and K005 over the six registered cases, K003 against
    the committed footprint baseline and its nvcc."""
    from mpi_grid_redistribute_tpu_torch.analysis import kernelcheck as kc
    from mpi_grid_redistribute_tpu_torch.analysis import rules_kernel
    from mpi_grid_redistribute_tpu_torch.analysis.baseline import (
        load_kernelcheck_baseline,
    )
    from mpi_grid_redistribute_tpu_torch.ops import _build

    cases = kc.default_kernels()
    findings, footprints, _ = kc.run_kernelcheck(cases, device="cuda")
    findings += rules_kernel.compare_footprints(
        footprints, load_kernelcheck_baseline(), _build.nvcc_version(),
        check_stale=True)
    assert findings == []
    assert sorted(footprints) == sorted(cases)


@pytest.mark.cuda
def test_kernelcheck_catches_a_write_past_a_tensor_on_the_card(cuda):
    """K001 on the card: a launch writing one row past its output (the
    scatter kernel handed a view shifted one row) hits the guard band."""
    from mpi_grid_redistribute_tpu_torch.analysis import kernelcheck as kc

    spec = kc.default_kernels()["scatter_rows_16384x7"]

    # the interior shifted one row down: row n - 1 of that view is the
    # first 28 bytes of the guard band after the tensor
    def build_past():
        case = spec.build()
        real = case.run

        def run(t):
            flat = t["flat"]
            n = flat.shape[0]
            past = torch.as_strided(flat, (n, 7), (7, 1),
                                    flat.storage_offset() + 7)
            tg = t["targets"].clone()
            tg[1] = n - 1
            scatter.scatter_rows(past, tg, t["rows"])
            return real(t)

        case.run = run
        return case

    broken = {spec.name: kc.KernelSpec(spec.name, build_past, "",
                                       spec.kernel, spec.op, spec.plain_op,
                                       launches=2, scatter=True)}
    findings, _, _ = kc.run_kernelcheck(broken, rules=["K001"],
                                        device="cuda", partial=True)
    assert [f.rule for f in findings] == ["K001"]
    assert "'flat'" in findings[0].message and "28 after" in \
        findings[0].message


@pytest.mark.cuda
def test_deposit_span_table_reads_the_deposit_on_the_card(cuda):
    """The deposit's span table on the card: one profiled call of two
    whole deposits, every device operation charged to a row, the rows
    adding up to the call's device time within 1%, the fused kernel 5
    launched a channel group each, and the density bit-equal to the
    plain deposit's."""
    from mpi_grid_redistribute_tpu_torch.bench import knockout_deposit
    from mpi_grid_redistribute_tpu_torch.ops import _build
    from mpi_grid_redistribute_tpu_torch.telemetry import phases

    state = knockout_deposit.make_state((2, 2, 2), 1 << 12, cuda)
    loop = knockout_deposit.make_loop(2, mesh_cells=32)
    _build.reset_counts()
    out, trace = phases.profile_call(loop, state, "cuda")
    # the warm call and the profiled one, 2 deposits each, one launch a
    # deposit (below 2^24 rows all 8 channels are one group)
    assert _build.counts()["tile_df_cumsum_rows"] == 4
    rows = phases.phase_rows(trace, knockout_deposit.PHASES, steps=2)
    assert [r.phase for r in rows] == list(knockout_deposit.PHASES) + [
        phases.REST]
    assert all(r.delta_s > 0 for r in rows[:-1])
    assert sum(r.delta_s for r in rows) == pytest.approx(
        trace.seconds_in() / 2, rel=0.01)
    want = knockout_deposit.make_loop(1, mesh_cells=32, plain=True)(*state)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
