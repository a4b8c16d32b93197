"""The scan deposit's tile carries (``ops/tilecarry``) on the CPU.

``tile_carries`` on the CPU is its plain version: ``_df_cumsum`` over the
tiles' last elements and a zero column in front, the arithmetic the
deposit ran inline before. These tests hold the plain version to that
arithmetic, and hold the card's algorithm (``csrc/tilecarry.cu``: ten
doubling steps a launch over the residue classes of the stride, whole
classes several to a window, longer ones in chunks behind a halo of the
1023 elements before them), replayed here in PyTorch block by block, to
the plain version bit for bit, at the sizes where its launches and
windows change shape. The card's kernel is held to the plain version in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu_torch.ops import deposit, tilecarry
from mpi_grid_redistribute_tpu_torch.ops.dfscan import _df_add, _df_cumsum

WIN, OUT, HALO = 2047, 1024, 1023  # csrc/tilecarry.cu's TC_WIN, ...


def _bits(t):
    return t.contiguous().view(torch.int32)


def _pack(r, g, T, tile):
    """Within-tile prefixes of ``g`` channels, hi rows above lo rows, with
    -0.0, a NaN, an infinity and a denormal among the tile totals."""
    pack = r.normal(size=(2 * g, T * tile)).astype(np.float32)
    pack[g:] *= np.float32(2.0**-24)
    ends = pack[:, tile - 1::tile]
    ends[0, 0] = -0.0
    if T > 5:
        ends[g - 1, T // 2] = np.nan
        ends[0, T // 3] = np.inf
        ends[2 * g - 1, 3] = np.float32(1e-41)
    return torch.from_numpy(pack)


def _card_algorithm(pack, tile):
    """``csrc/tilecarry.cu`` replayed in PyTorch: each launch's blocks,
    their windows' loads, its steps on the windows (a zero read below a
    segment's start) and the writes from the halo on."""
    rows, n_pad = pack.shape
    g, T = rows // 2, n_pad // tile
    total = (T - 1).bit_length()
    n_launch = max(1, -(-total // 10))
    src = pack[:, tile - 1::tile]
    stride = 1
    for q in range(n_launch):
        steps = total - 10 * q if q == n_launch - 1 else 10
        classes, length = min(stride, T), -(-T // stride)
        whole = length <= WIN
        seg = length if whole else WIN
        per = WIN // seg if whole else 1
        chunks = 1 if whole else -(-length // OUT)
        halo = 0 if whole else HALO
        blocks = -(-classes // per) * chunks
        x = torch.arange(blocks)[:, None]
        p = torch.arange(seg * per)[None, :]
        r = (x // chunks) * per + p // seg
        k = (x % chunks) * OUT - halo + p % seg
        t = r + k * stride
        ok = (r < classes) & (k >= 0) & (t < T)
        at = t.clamp(0, T - 1)
        hi = torch.where(ok, src[:g][:, at], 0.0)
        lo = torch.where(ok, src[g:][:, at], 0.0)
        lp = (p % seg).expand_as(t)
        for e in range(steps):
            s = 1 << e
            sh_hi, sh_lo = torch.zeros_like(hi), torch.zeros_like(lo)
            sh_hi[..., s:], sh_lo[..., s:] = hi[..., :-s], lo[..., :-s]
            own = lp >= s
            hi, lo = _df_add(hi, lo, torch.where(own, sh_hi, 0.0),
                             torch.where(own, sh_lo, 0.0))
        write = ok & (lp >= halo)
        dst = torch.full((rows, T), float("nan"))
        dst[:g, t[write]] = hi[:, write]
        dst[g:, t[write]] = lo[:, write]
        src, stride = dst, stride << 10
    zero = torch.zeros((rows, 1))
    return torch.cat([zero, src], dim=1)


@pytest.mark.parametrize("g,T,tile", [
    (1, 1, 4), (2, 2, 1), (1, 3, 7), (2, 1023, 2), (1, 1024, 1),
    (2, 1025, 3), (1, 2047, 1), (2, 2048, 1), (1, 3000, 4),
    (2, 262_144, 1),  # the CIC cell's tiles: chunked, then 7 classes a block
    (1, (1 << 21) + 3, 1),  # three launches, the second chunked
])
def test_card_algorithm_is_the_plain_carries(g, T, tile):
    """The card's launches and windows give the plain version's bits:
    the steps' order kept in every window, each chunk's halo long enough,
    the shifted-in zeros where the plain version shifts them in."""
    pack = _pack(np.random.default_rng(T + g), g, T, tile)
    want = tilecarry.tile_carries_plain(pack, tile)
    assert want.shape == (2 * g, T + 1)
    assert torch.equal(_bits(_card_algorithm(pack, tile)), _bits(want))
    assert tilecarry.launches(T) == max(1, -(-(T - 1).bit_length() // 10))


@pytest.mark.parametrize("g,T,tile", [(1, 1, 1), (2, 300, 4), (4, 97, 16)])
def test_plain_carries_are_the_deposits_tile_prefixes(g, T, tile):
    """The plain version is the deposit's level-2 arithmetic: the
    inclusive ``_df_cumsum`` over the tiles' last elements, hi with its
    lo, a zero column in front: exclusive prefixes a tile."""
    pack = _pack(np.random.default_rng(g * T), g, T, tile)
    tiles = pack.view(2 * g, T, tile)
    thi, tlo = _df_cumsum(tiles[:g, :, -1], axis=1, x_lo=tiles[g:, :, -1])
    got = tilecarry.tile_carries(pack, tile)
    assert torch.equal(_bits(got[:g, 1:]), _bits(thi))
    assert torch.equal(_bits(got[g:, 1:]), _bits(tlo))
    assert not got[:, 0].any() and not torch.signbit(got[:, 0]).any()


def test_tile_carries_out_hook_and_checks():
    pack = _pack(np.random.default_rng(3), 2, 50, 4)
    before = tilecarry.KERNEL.launches
    want = tilecarry.tile_carries_plain(pack, 4)
    out = torch.empty((4, 51))
    assert tilecarry.tile_carries(pack, 4, _out=out) is out
    assert tilecarry.KERNEL.launches == before  # the CPU launches nothing
    assert torch.equal(_bits(out), _bits(want))
    with pytest.raises(ValueError):
        tilecarry.tile_carries(pack, 4, _out=torch.empty((4, 50)))
    with pytest.raises(TypeError):
        tilecarry.tile_carries(pack.double(), 4)
    with pytest.raises(TypeError):
        tilecarry.tile_carries(pack[0], 4)
    for bad, tile in ((pack[:3], 4), (pack, 3), (pack, 0), (pack, 400)):
        with pytest.raises(ValueError):
            tilecarry.tile_carries(bad, tile)


def test_tile_carries_cost_and_launches():
    """Each tile total read once and the result written once, hi and lo;
    a double-float add an element and step; two launches at the CIC
    cell's 262,144 tiles."""
    pack = torch.zeros((4, 3000 * 4))
    assert tilecarry.kernel_cost(pack, 4) == (
        4 * 4 * 3000 + 4 * 4 * 3001, 2 * 11 * 12 * 2 * 3000)
    assert [tilecarry.launches(T) for T in (1, 2, 1024, 1025, 262_144,
                                            1 << 20, (1 << 20) + 1)] == [
        1, 1, 1, 2, 2, 2, 3]
    assert tilecarry.launch_functions(pack, 4) == [
        ("tile_carry_kernel", 1024, 0)]


@pytest.mark.parametrize("plain", [False, True])
def test_deposit_takes_its_carries_from_the_op(monkeypatch, plain):
    """The scan deposit's tile prefixes come from ``tile_carries`` (its
    plain version when ``plain``), once a channel group."""
    calls, depth = [], [0]
    for name in ("tile_carries", "tile_carries_plain"):
        def spy(*a, _f=getattr(tilecarry, name), _name=name, **k):
            if not depth[0]:  # the deposit's own calls
                calls.append(_name)
            depth[0] += 1
            try:
                return _f(*a, **k)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(tilecarry, name, spy)
    r = np.random.default_rng(4)
    vblock = (4, 4, 4)
    pos = torch.from_numpy(r.random((3, 600), dtype=np.float32))
    mass = torch.from_numpy(r.uniform(0.5, 2.0, 600).astype(np.float32))
    valid = torch.from_numpy(r.random(600) < 0.9)
    lo = torch.zeros((1, 3))
    inv_h = torch.full((3,), 4.0)
    got = deposit.cic_deposit_vranks_planar(pos, mass, valid, lo, inv_h,
                                            vblock, tile=64, plain=plain)
    assert calls == ["tile_carries_plain" if plain else "tile_carries"]
    assert abs(float(got.double().sum()) - float(mass[valid].sum())) < 1e-3
