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
import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mpi_grid_redistribute_tpu.ops import deposit as jdeposit
from mpi_grid_redistribute_tpu.ops import pallas_dfscan
from mpi_grid_redistribute_tpu_torch.ops import binning
from mpi_grid_redistribute_tpu_torch.ops import deposit as tdeposit
from mpi_grid_redistribute_tpu_torch.ops import dfscan, rowsort

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


@pytest.mark.parametrize("tile", [3, 5, 33, 1000])
def test_plain_matches_xla_at_non_power_of_two_tiles(tile):
    """The tiles the card kernel pads to whole registers or packs several
    to a warp; the TPU kernel takes none of them."""
    r = np.random.default_rng(tile)
    _check(r.standard_normal((19, tile)).astype(np.float32), interpret=False)


@pytest.mark.parametrize("tile", [5, 256])
def test_plain_matches_jax_on_signed_zeros(tile):
    """Rows of -0.0 and rows mixing +-0.0 with values: every element takes
    every step, the add of the shifted-in +0.0 included, which turns a
    leading -0.0 into +0.0 on both sides."""
    r = np.random.default_rng(tile + 1)
    x = r.standard_normal((6, tile)).astype(np.float32)
    x[0] = -0.0
    x[1, ::2] = -0.0
    x[2] = np.where(r.random(tile) < 0.5, -0.0, 0.0)
    x[3, :3] = -0.0
    _check(x, interpret=tile == 256)
    hi, _ = dfscan.tile_df_cumsum_rows_plain(torch.from_numpy(x))
    assert not torch.signbit(hi[0]).any()


@pytest.mark.parametrize("tile,regs,rows_per_warp", [
    (1, 1, 32), (2, 1, 16), (3, 1, 10), (5, 1, 6), (16, 1, 2), (17, 1, 1),
    (31, 1, 1), (32, 1, 1), (33, 2, 1), (63, 2, 1), (64, 2, 1), (96, 3, 1),
    (255, 8, 1), (256, 8, 1), (257, 9, 1), (1000, 32, 1), (1024, 32, 1),
])
def test_kernel_geometry(tile, regs, rows_per_warp):
    """ceil(tile / 32) registers a lane; floor(32 / tile) rows a warp
    below 32, one row from there on."""
    assert dfscan.geometry(tile) == ("warp", regs, rows_per_warp)


def test_kernel_geometry_covers_every_tile_and_refuses_the_rest():
    for tile in range(1, dfscan.MAX_TILE + 1):
        route, regs, rpw = dfscan.geometry(tile)
        assert route == "warp"
        assert regs * 32 >= tile > (regs - 1) * 32
        assert rpw == 1 or (regs == 1 and rpw * tile <= 32)
    for tile in (0, -1):
        with pytest.raises(ValueError):
            dfscan.geometry(tile)


@pytest.mark.parametrize("tile,route", [
    (1024, "warp"), (1025, "block"), (2048, "block"), (8192, "block"),
    (14528, "block"), (14529, "plain"), (16384, "plain"), (1 << 20, "plain"),
])
def test_kernel_shape_rule_routes_large_tiles(tile, route):
    """Above 1024 a block per row holds the row's two (hi, lo) buffers in
    shared memory, 16 bytes an element: up to 232,448 // 16 = 14,528 on
    an H100. A larger tile goes to the plain version, by this rule alone."""
    assert dfscan.MAX_BLOCK_TILE == 232448 // 16 == 14528
    geo = dfscan.geometry(tile)
    assert geo.route == route
    if route != "warp":
        assert (geo.regs, geo.rows_per_warp) == (0, 0)


@pytest.mark.parametrize("tile", [1025, 2048])
def test_plain_matches_xla_at_block_route_tiles(tile):
    """The tiles of the block route: the plain version (the kernel's
    reference on the card) is bit-equal to the reference's jitted
    ``_df_cumsum``."""
    r = np.random.default_rng(tile)
    x = _signed(r.standard_normal((6, tile)).astype(np.float32), r)
    _check(x, interpret=tile == 2048)


def _signed(x, r):
    x[0] = -0.0
    x[1, ::7] = -0.0
    x[2, :: 3] = 0.0
    return x


def test_deposit_scan_at_tile_2048_matches_reference():
    """The scan deposit at tile 2048 (kernel 5's block route on the card)
    is bit-equal to the reference's ``cic_deposit_device_planar``."""
    r = np.random.default_rng(2048)
    n, block = 6000, (4, 4, 4)
    pos = r.random((3, n), dtype=np.float32)
    mass = r.random(n, dtype=np.float32)
    valid = r.random(n) < 0.9
    inv_h = np.float32(4.0)
    got = tdeposit.cic_deposit_device_planar(
        torch.from_numpy(pos), torch.from_numpy(mass),
        torch.from_numpy(valid), torch.zeros(3),
        torch.full((3,), inv_h), block, tile=2048,
    )
    want = jdeposit.cic_deposit_device_planar(
        jnp.asarray(pos), jnp.asarray(mass), jnp.asarray(valid),
        jnp.zeros(3, jnp.float32), jnp.full((3,), inv_h), block, tile=2048,
    )
    _assert_bits(got, want)


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


# ---- the scan deposit's entry: dfscan.cic_tile_prefix --------------------


def _frozen_deposit_stages(payload_s, local_shape, corners, K):
    """The scan deposit's stages around kernel 5 as ``ops/deposit.py``
    wrote them before they moved behind ``dfscan.cic_tile_prefix``, kept
    here unchanged: the base cells and fractions, the corner-weight rows,
    the stack, the pad, the within-tile prefixes and the pack."""
    D, n = payload_s.shape[0] - 1, payload_s.shape[1]
    rel_s, mass_s = payload_s[:D], payload_s[D]
    n_pad = -(-n // K) * K
    i0_s = torch.stack([
        binning.floor_to_int32(rel_s[d]).clamp(0, local_shape[d] - 1)
        for d in range(D)], dim=0)
    frac = (rel_s - i0_s.to(torch.float32)).clamp(0.0, 1.0)
    rows = []
    for corner in corners:
        w = None
        for d in range(D):
            t = frac[d] if corner[d] == 1 else 1.0 - frac[d]
            w = t if w is None else w * t
        rows.append(mass_s * w)
    wg = torch.stack(rows, dim=0)
    g = wg.shape[0]
    wt = torch.nn.functional.pad(wg, (0, n_pad - n)).reshape(
        g, n_pad // K, K)
    lhi, llo = dfscan.tile_df_cumsum_rows_plain(wt.reshape(g * n_pad // K,
                                                           K))
    return torch.cat([lhi.reshape(g, n_pad), llo.reshape(g, n_pad)], dim=0)


def _deposit_payload(r, D, n, local_shape):
    """A sorted scan-deposit payload ``[D + 1, n]``: coordinates in
    ``[0, local_shape]``, with rows exactly at ``local_shape`` (the last
    cell's far face), a few ulp below 0, at +-0.0, NaN and huge, masses
    that are not 1, and a tail of invalid rows (coordinates 0, mass 0) as
    the sentinel keys leave them."""
    rel = (r.random((D, n)) * np.asarray(local_shape)[:, None]).astype(
        np.float32)
    mass = r.uniform(0.25, 3.0, n).astype(np.float32)
    for d in range(D):
        rel[d, 3 + d] = np.float32(local_shape[d])
        rel[d, 10 + d] = -np.float32(1e-7) * (d + 1)
        rel[d, 20 + d] = np.nextafter(np.float32(0), np.float32(-1))
        rel[d, 30 + d] = -0.0
        rel[d, 40 + d] = 0.0
        rel[d, 50 + d] = np.nextafter(np.float32(local_shape[d]),
                                      np.float32(0))
        rel[d, 60 + d] = np.float32(3e38)
    rel[0, 70] = np.nan
    mass[80] = -0.0
    mass[81] = 1e-30
    tail = n // 10
    rel[:, n - tail:] = 0.0
    mass[n - tail:] = 0.0
    return torch.from_numpy(np.concatenate([rel, mass[None]], axis=0))


@pytest.mark.parametrize("group", ["pairs", "all"])
@pytest.mark.parametrize("D,local_shape", [
    (1, (16,)), (2, (8, 5)), (3, (8, 8, 8)),
])
@pytest.mark.parametrize("n,tile", [(1000, 256), (300, 64), (257, 256)])
def test_cic_plain_twin_matches_the_frozen_stages(D, local_shape, group, n,
                                                  tile):
    """``cic_tile_prefix_plain`` (and the entry on the CPU) is bit-equal to
    the deposit's former stages, channel group by channel group: in pairs,
    as the deposit takes them above 2^24 rows, or all 2^D at once."""
    payload = _deposit_payload(np.random.default_rng(D * 100 + n), D, n,
                               local_shape)
    corners = list(itertools.product((0, 1), repeat=D))
    g = 2 if group == "pairs" else 1 << D
    for c0 in range(0, 1 << D, g):
        want = _frozen_deposit_stages(payload, local_shape,
                                      corners[c0:c0 + g], tile)
        got = dfscan.cic_tile_prefix_plain(payload, local_shape, c0, g, tile)
        assert got.shape == (2 * g, -(-n // tile) * tile)
        _assert_bits(got, want.numpy())
        _assert_bits(dfscan.cic_tile_prefix(payload, local_shape, c0, g,
                                            tile), want.numpy())


def test_cic_entry_launches_nothing_on_the_cpu_and_checks_its_input():
    payload = _deposit_payload(np.random.default_rng(1), 3, 500, (8, 8, 8))
    before = (dfscan.KERNEL.launches, dict(dfscan.ROUTES))
    got = dfscan.cic_tile_prefix(payload, (8, 8, 8), 2, 2, 256)
    assert (dfscan.KERNEL.launches, dict(dfscan.ROUTES)) == before
    want = dfscan.cic_tile_prefix_plain(payload, (8, 8, 8), 2, 2, 256)
    _assert_bits(got, want.numpy())  # NaN rows: compare bits
    out = torch.empty((4, 512))
    assert dfscan.cic_tile_prefix(payload, (8, 8, 8), 2, 2, 256,
                                  _out=out) is out
    _assert_bits(out, want.numpy())
    with pytest.raises(TypeError):
        dfscan.cic_tile_prefix(payload.double(), (8, 8, 8), 0, 2, 256)
    for shape, c0, g in (((8, 8), 0, 2), ((8, 8, 8), 7, 2),
                         ((8, 8, 8), 0, 0)):
        with pytest.raises(ValueError):
            dfscan.cic_tile_prefix(payload, shape, c0, g, 256)


@pytest.mark.parametrize("tile,D,want", [
    (256, 3, ("cic", 8, 1)), (1, 3, ("cic", 1, 32)), (5, 2, ("cic", 1, 6)),
    (33, 1, ("cic", 2, 1)), (100, 3, ("cic", 4, 1)),
    (257, 3, ("cic", 16, 1)), (1000, 2, ("cic", 32, 1)),
    (1024, 3, ("cic", 32, 1)), (1025, 3, ("block", 0, 0)),
    (2048, 1, ("block", 0, 0)), (14529, 3, ("plain", 0, 0)),
    (256, 4, ("warp", 8, 1)),
])
def test_cic_shape_rule(tile, D, want):
    """The fused route takes the register route's tiles at D = 1..3, its
    registers rounded up to a power of two; other shapes keep
    ``geometry``'s route, which the plain stages take on the card."""
    assert dfscan.cic_geometry(tile, D) == want


def test_cic_shape_rule_covers_every_register_tile():
    for tile in range(1, dfscan.MAX_TILE + 1):
        route, regs, rpw = dfscan.cic_geometry(tile, 3)
        assert route == "cic" and regs & (regs - 1) == 0
        assert regs * 32 >= tile and regs < 2 * -(-tile // 32)
        assert (route, rpw) == ("cic", dfscan.geometry(tile).rows_per_warp)


def test_cic_kernel_cost_counts_the_fused_traffic():
    """The planar entry's count, as one pass would move it: 16 bytes a row
    read for the group at D = 3, 8 bytes written an element of each
    channel, the pad included; and the rows route's count is unchanged."""
    payload = torch.zeros((4, 1000))
    b, f = dfscan.cic_kernel_cost(payload, (8, 8, 8), 0, 2, 256)
    assert b == 16 * 1000 + 8 * 2 * 1024
    assert f == 2 * (11 * 8 + 6) * 2 * 1024
    assert dfscan.kernel_cost(torch.zeros((8, 256))) == (
        12 * 2048, 2 * 11 * 8 * 2048)


def test_reset_counts_zeroes_the_routes():
    from mpi_grid_redistribute_tpu_torch.ops import _build

    assert set(dfscan.ROUTES) == {"rows", "packed"}
    dfscan.ROUTES["rows"] += 3
    dfscan.ROUTES["packed"] += 2
    _build.reset_counts()
    assert dfscan.ROUTES == {"rows": 0, "packed": 0}
    assert dfscan.ROUTES is dfscan.KERNEL.routes


# ---- the same entry on the sorted rows: dfscan.cic_tile_prefix_rows -------


def _as_rows(payload):
    """The rows ``[n, 4]`` of ``ops.rowsort`` that hold a planar payload
    ``[D + 1, n]``: coordinates, then mass, then zeros."""
    return rowsort.pack_rows_plain(payload[:-1], payload[-1])


@pytest.mark.parametrize("group", ["pairs", "all"])
@pytest.mark.parametrize("D,local_shape", [
    (1, (16,)), (2, (8, 5)), (3, (8, 8, 8)),
])
@pytest.mark.parametrize("n,tile", [(1000, 256), (300, 64), (257, 256),
                                    (97, 1)])
def test_cic_rows_input_gives_the_planar_pack(D, local_shape, group, n,
                                              tile):
    """The packed input (the sorted rows) gives, through the plain twin,
    the pack of the planar input those rows hold, bit for bit, channel
    group by channel group, NaN and signed zeros included."""
    payload = _deposit_payload(np.random.default_rng(D * 10 + n), D, n,
                               local_shape)
    rows = _as_rows(payload)
    g = 2 if group == "pairs" else 1 << D
    for c0 in range(0, 1 << D, g):
        want = dfscan.cic_tile_prefix(payload, local_shape, c0, g, tile)
        got = dfscan.cic_tile_prefix_rows(rows, local_shape, c0, g, tile)
        assert got.shape == (2 * g, -(-n // tile) * tile)
        _assert_bits(got, want.numpy())


def test_cic_rows_entry_launches_nothing_on_the_cpu_and_checks_its_input():
    payload = _deposit_payload(np.random.default_rng(2), 3, 500, (8, 8, 8))
    rows = _as_rows(payload)
    before = (dfscan.KERNEL.launches, dict(dfscan.ROUTES))
    want = dfscan.cic_tile_prefix_plain(payload, (8, 8, 8), 2, 2, 256)
    out = torch.empty((4, 512))
    assert dfscan.cic_tile_prefix_rows(rows, (8, 8, 8), 2, 2, 256,
                                       _out=out) is out
    assert (dfscan.KERNEL.launches, dict(dfscan.ROUTES)) == before
    _assert_bits(out, want.numpy())
    with pytest.raises(TypeError):
        dfscan.cic_tile_prefix_rows(rows.double(), (8, 8, 8), 0, 2, 256)
    with pytest.raises(TypeError):  # the planar payload is not rows
        dfscan.cic_tile_prefix_rows(payload[:3].t(), (8, 8, 8), 0, 2, 256)
    for shape, c0, g in (((8, 8, 8, 8), 0, 2), ((8, 8, 8), 7, 2),
                         ((8, 8, 8), 0, 0), ((), 0, 1)):
        with pytest.raises(ValueError):
            dfscan.cic_tile_prefix_rows(rows, shape, c0, g, 256)


def test_cic_rows_kernel_cost_counts_a_row_a_particle():
    """A 16-byte row read a particle whatever D is, and the planar
    route's count otherwise."""
    rows = torch.zeros((1000, 4))
    b, f = dfscan.cic_rows_kernel_cost(rows, (8, 8, 8), 0, 2, 256)
    assert (b, f) == dfscan.cic_kernel_cost(torch.zeros((4, 1000)),
                                            (8, 8, 8), 0, 2, 256)
    b, f = dfscan.cic_rows_kernel_cost(rows, (8,), 0, 2, 256)
    assert b == 16 * 1000 + 8 * 2 * 1024
    assert f == 2 * (11 * 8 + 2) * 2 * 1024
