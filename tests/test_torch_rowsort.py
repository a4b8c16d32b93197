"""The scan deposit's payload sort (``ops/rowsort``) and its route through
the deposit, on the CPU.

``sort_keyed_rows`` on the CPU is its plain version: the deposit's keys
phase (``slab_keys_plain``), then ``sort_rows_plain``, a stable
``torch.sort`` of the key and one ``index_select`` of the packed rows.
These tests hold the sort to the one the deposit ran before (the planar
payload's gather), pin the row layout kernel 5 reads, hold the keyed
sort's plain version to an independent numpy reference of the keys
phase, and drive the deposit's rows route on the CPU (the route forced,
each op on its plain version): the same bits as the planar route, in the
whole deposit and in each channel group's intermediates. The card's
kernel is held to the plain version in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu_torch.ops import deposit, dfscan, rowsort


def _bits(t):
    return t.contiguous().view(torch.int32)


def _inputs(r, D, n, n_keys):
    """Keys dense with ties and a sentinel (``n_keys``), coordinates
    with signed zeros and a NaN, masses that are not 1."""
    key = r.integers(0, n_keys, size=n).astype(np.int32)
    key[r.random(n) < 0.15] = n_keys
    rel = (r.random((D, n)) * 8).astype(np.float32)
    mass = r.uniform(0.25, 3.0, n).astype(np.float32)
    if n > 3:
        rel[0, :3] = (-0.0, 0.0, np.nan)
        mass[3] = -0.0
    return (torch.from_numpy(key), torch.from_numpy(rel),
            torch.from_numpy(mass))


@pytest.mark.parametrize("D", [1, 2, 3])
@pytest.mark.parametrize("n,n_keys", [(1, 1), (1000, 7), (4099, 512)])
def test_sort_rows_is_the_stable_sort_and_gather(D, n, n_keys):
    """The sorted keys and rows are the stable key sort and the gather
    of the planar payload by its permutation, bit for bit; each row is
    the coordinates, then the mass, then zero lanes."""
    key, rel, mass = _inputs(np.random.default_rng(D * n), D, n, n_keys)
    keys_s, rows_s = rowsort.sort_rows_plain(key, rel, mass)
    want_k, order = torch.sort(key, stable=True)
    payload = torch.cat([rel, mass[None]], dim=0)
    want = torch.index_select(payload, 1, order)
    assert keys_s.dtype == torch.int32 and torch.equal(keys_s, want_k)
    assert rows_s.shape == (n, rowsort.ROW_FLOATS)
    assert torch.equal(_bits(rowsort.rows_as_payload(rows_s, D)),
                       _bits(want))
    assert not rows_s[:, D + 1:].any()


def test_pack_rows_keeps_every_bit_and_zeroes_the_rest():
    key, rel, mass = _inputs(np.random.default_rng(5), 2, 50, 4)
    rows = rowsort.pack_rows_plain(rel, mass)
    assert rows.shape == (50, 4) and rows.is_contiguous()
    assert torch.equal(_bits(rows[:, :2].t()), _bits(rel))
    assert torch.equal(_bits(rows[:, 2]), _bits(mass))
    assert torch.equal(_bits(rows[:, 3]), torch.zeros(50, dtype=torch.int32))
    view = rowsort.rows_as_payload(rows, 2)
    assert view.shape == (3, 50)
    assert view.data_ptr() == rows.data_ptr()  # a view, not a copy


def _keyed_inputs(r, D, V, n, vblock):
    """Slabs of V vranks side by side along axis 0 of the unit box (vrank
    ``v``'s block starts at ``v / V``): positions in their blocks, and on
    valid slots NaN, +-inf, -0.0 (on the block's lower face), positions
    outside the block and on its upper face; ~10% invalid slots, some
    holding NaN; masses that are not 1, with a -0.0 and a NaN."""
    m = V * n
    lo = np.zeros((V, D), np.float32)
    lo[:, 0] = np.arange(V, dtype=np.float32) / np.float32(V)
    width = np.ones(D, np.float32)
    width[0] = np.float32(1.0) / np.float32(V)
    inv_h = (np.asarray(vblock, np.float32) / width).astype(np.float32)
    v = np.repeat(np.arange(V), n)
    pos = (lo[v].T + r.random((D, m), dtype=np.float32)
           * width[:, None]).astype(np.float32)
    valid = r.random(m) < 0.9
    mass = r.uniform(0.5, 2.0, m).astype(np.float32)
    special = [np.nan, np.inf, -np.inf, -0.0, -0.25, 1.75, 1e10, -3e38]
    for d in range(D):
        for k in range(V):  # each vrank's first slots
            s0 = k * n
            pos[d, s0:s0 + len(special)] = special
            pos[d, s0 + 10] = lo[k, d] + width[d]  # the upper face
            pos[d, s0 + 11] = lo[k, d]  # the lower face
            valid[s0:s0 + 12] = True
    valid[n - 1] = False
    pos[:, n - 1] = np.nan  # an invalid slot's bytes are any bytes
    mass[2], mass[3] = -0.0, np.nan
    return [torch.from_numpy(a) for a in (pos, valid, mass, lo, inv_h)]


def _keys_reference(pos, valid, mass, lo, inv_h, vblock):
    """The deposit's keys phase and the stable sort in numpy, float32 op
    by op: ``(keys_s, rows_s)``."""
    pos, valid, mass, lo, inv_h = (t.numpy() for t in (pos, valid, mass, lo,
                                                       inv_h))
    D, m = pos.shape
    V = lo.shape[0]
    v = np.repeat(np.arange(V), m // V)
    with np.errstate(invalid="ignore", over="ignore"):
        rel = (pos - lo[v].T) * inv_h[:, None]
        rel = np.where(valid, rel, np.float32(0.0))
        f = np.floor(rel)
        f = np.clip(np.where(np.isnan(f), 0.0, f), -2.0**31, 2.0**31 - 128)
    cells = np.clip(f.astype(np.int64), 0,
                    np.asarray(vblock)[:, None] - 1)
    n_cells = int(np.prod(vblock))
    cell = sum(cells[d] * int(np.prod(vblock[d + 1:])) for d in range(D))
    key = np.where(valid, v * n_cells + cell, V * n_cells).astype(np.int32)
    rows = np.zeros((m, rowsort.ROW_FLOATS), np.float32)
    rows[:, :D] = rel.T
    rows[:, D] = np.where(valid, mass, np.float32(0.0))
    order = np.argsort(key, kind="stable")
    return torch.from_numpy(key[order]), torch.from_numpy(rows[order])


@pytest.mark.parametrize("D,vblock", [(1, (16,)), (2, (5, 4)),
                                      (3, (4, 3, 5))])
@pytest.mark.parametrize("V", [1, 3])
def test_keyed_sort_is_the_keys_phase_and_the_sort(D, vblock, V):
    """``sort_keyed_rows`` on the CPU (its plain version: the deposit's
    keys phase ``slab_keys_plain``, then ``sort_rows_plain``) against the
    keys phase and a stable sort in numpy, bit for bit: invalid slots on
    the sentinel with zero rows, NaN to cell 0, infinities and positions
    outside the block clipped to its edge cells, the upper face in the
    last cell, -0.0 kept."""
    args = _keyed_inputs(np.random.default_rng(10 * D + V), D, V, 500,
                         vblock)
    keys_s, rows_s = rowsort.sort_keyed_rows(*args, vblock)
    want_k, want_r = _keys_reference(*args, vblock)
    assert keys_s.dtype == torch.int32 and torch.equal(keys_s, want_k)
    assert torch.equal(_bits(rows_s), _bits(want_r))
    key, rel, mass_z = rowsort.slab_keys_plain(*args, vblock)
    plain = rowsort.sort_rows_plain(key, rel, mass_z)
    assert torch.equal(keys_s, plain[0])
    assert torch.equal(_bits(rows_s), _bits(plain[1]))
    n_cells = int(np.prod(vblock))
    assert int(keys_s[-1]) == V * n_cells  # the invalid slots sort last
    assert (keys_s < V * n_cells).sum() == int(args[1].sum())


def test_sort_keyed_rows_out_hook_and_checks():
    vblock = (4, 3)
    pos, valid, mass, lo, inv_h = _keyed_inputs(np.random.default_rng(11),
                                                2, 2, 100, vblock)
    before = (rowsort.KERNEL.launches, dict(rowsort.ROUTES))
    want = rowsort.sort_keyed_rows_plain(pos, valid, mass, lo, inv_h, vblock)
    out = (torch.empty(200, dtype=torch.int32), torch.empty((200, 4)))
    got = rowsort.sort_keyed_rows(pos, valid, mass, lo, inv_h, vblock,
                                  _out=out)
    assert got[0] is out[0] and got[1] is out[1]
    # the CPU launches nothing
    assert (rowsort.KERNEL.launches, dict(rowsort.ROUTES)) == before
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    bad = [
        (pos.double(), valid, mass, lo, inv_h, vblock),
        (torch.cat([pos, pos, pos, pos]), valid, mass,
         torch.cat([lo] * 4, 1), torch.cat([inv_h] * 4), vblock * 4),
        (pos, valid.int(), mass, lo, inv_h, vblock),
        (pos, valid, mass[:5], lo, inv_h, vblock),
        (pos, valid, mass, lo[:, :1], inv_h, vblock),
        (pos, valid, mass, torch.zeros((3, 2)), inv_h, vblock),  # V: 3 ∤ 200
        (pos, valid, mass, lo, inv_h.double(), vblock),
    ]
    for args in bad:
        with pytest.raises(TypeError):
            rowsort.sort_keyed_rows(*args)
    for vb in ((4,), (4, 0), (2**16, 2**15)):
        with pytest.raises(ValueError):
            rowsort.sort_keyed_rows(pos, valid, mass, lo, inv_h, vb)


def test_keyed_sort_cost_counts_each_byte_once():
    """37 bytes a slot at D = 3: 12 of positions, 1 of ``valid`` and 4
    of mass read, a 4-byte key and a 16-byte row written; ``lo_local``
    and ``inv_h`` once; a subtract and a multiply a coordinate."""
    vblock = (4, 4, 4)
    args = _keyed_inputs(np.random.default_rng(12), 3, 2, 50, vblock)
    assert rowsort.kernel_cost(*args, vblock) == (
        100 * 37 + 4 * 6 + 4 * 3, 2 * 3 * 100)
    assert rowsort.launch_functions(args[0][:2]) == [
        ("rowsort_keys_kernel<2>", 256, 0)]
    assert rowsort.keyed_bits(args[3], vblock) == (2 * 64).bit_length()


CUDA = torch.device("cuda")  # a device object: touches no card


@pytest.mark.parametrize("device,n,D,tile,plain,want", [
    (CUDA, 67_108_864, 3, 256, False, "rows"),  # the CIC cell's deposit
    (CUDA, 1, 1, 1, False, "rows"),
    (CUDA, 5000, 2, 1024, False, "rows"),
    (CUDA, 5000, 3, 256, True, "planar"),  # plain=True
    (CUDA, 5000, 3, 1025, False, "planar"),  # a tile off the fused route
    (CUDA, 50_000, 3, 2048, False, "planar"),
    (CUDA, 5000, 4, 256, False, "planar"),  # D above a row's lanes
    (CUDA, 0, 3, 1, False, "planar"),
    (CUDA, 2**31, 1, 256, False, "planar"),  # past cub's int count
    (torch.device("cpu"), 5000, 3, 256, False, "planar"),
])
def test_payload_route_rule(device, n, D, tile, plain, want):
    """The rows route serves the card's fused-route tiles at D = 1..3;
    a non-fused tile, ``plain=True``, the CPU and shapes a row cannot
    hold keep the planar sort and gather."""
    assert deposit._payload_route(device, n, D, tile, plain) == want


def _deposit_args(r, D, V, n, vblock):
    m = V * n
    pos = r.random((D, m), dtype=np.float32)
    pos[:, :4] = 0.0
    pos[0, 4:8] = np.float32(1.0) - np.float32(2 ** -24)
    mass = r.uniform(0.5, 2.0, m).astype(np.float32)
    valid = r.random(m) < 0.9
    lo = np.zeros((V, D), np.float32)
    lo[:, 0] = np.arange(V, dtype=np.float32) / V
    inv_h = np.asarray(vblock, np.float32) * np.float32(V) ** (
        np.arange(D) == 0)
    return [torch.from_numpy(a) for a in (pos, mass, valid, lo, inv_h)]


@pytest.fixture
def rows_route_on_the_cpu(monkeypatch):
    """The deposit's rows route forced on the CPU, where
    ``sort_keyed_rows`` and ``cic_tile_prefix_rows`` run their plain
    versions."""
    monkeypatch.setattr(deposit, "_payload_route",
                        lambda device, n, D, tile, plain:
                        "planar" if plain else "rows")


@pytest.mark.parametrize("D,vblock", [(1, (16,)), (2, (8, 4)),
                                      (3, (4, 4, 4))])
@pytest.mark.parametrize("tile", [256, 7])
def test_rows_route_deposit_is_bit_equal_to_the_planar_route(
        rows_route_on_the_cpu, monkeypatch, D, vblock, tile):
    """The rows route computes its keys in the keyed sort (one
    ``sort_keyed_rows`` call and no keys phase of its own) and gives the
    planar route's bits."""
    calls, depth = [], [0]
    for name in ("sort_keyed_rows", "slab_keys_plain"):
        def spy(*a, _f=getattr(rowsort, name), _name=name, **k):
            if not depth[0]:  # the deposit's own calls
                calls.append(_name)
            depth[0] += 1
            try:
                return _f(*a, **k)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(rowsort, name, spy)
    args = _deposit_args(np.random.default_rng(D + tile), D, 3, 700, vblock)
    got = deposit.cic_deposit_vranks_planar(*args, vblock, tile=tile)
    assert calls == ["sort_keyed_rows"]
    want = deposit.cic_deposit_vranks_planar(*args, vblock, tile=tile,
                                             plain=True)
    assert calls == ["sort_keyed_rows", "slab_keys_plain"]
    assert got.shape == (3,) + tuple(b + 1 for b in vblock)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("c0", [0, 2, 4, 6])
def test_rows_route_intermediates_hold_what_the_planar_route_holds(c0):
    """The rows route's intermediates, one channel group of 2 a case:
    ``sort_keyed_rows`` gives the keys and payload that the device-cell
    keys, ``torch.sort`` and a gather of the planar payload give, and
    ``cic_tile_prefix_rows`` on the sorted rows the pack that
    ``cic_tile_prefix_plain`` makes of the same sorted payload, bit for
    bit."""
    vblock = (4, 4, 4)
    pos, mass, valid, lo, inv_h = _deposit_args(
        np.random.default_rng(c0), 3, 1, 900, vblock)
    keys_s, rows_s = rowsort.sort_keyed_rows(pos, valid, mass, lo, inv_h,
                                             vblock)
    key, rel = deposit._device_keys_planar(pos, valid, lo[0], inv_h, vblock)
    mass = torch.where(valid, mass, 0.0)
    want_keys, order = torch.sort(key, stable=True)
    payload_s = torch.cat([rel, mass[None, :]], dim=0)[:, order]
    assert torch.equal(keys_s, want_keys)
    assert torch.equal(_bits(rowsort.rows_as_payload(rows_s, 3)),
                       _bits(payload_s))
    got = dfscan.cic_tile_prefix_rows(rows_s, vblock, c0, 2, 256)
    want = dfscan.cic_tile_prefix_plain(payload_s, vblock, c0, 2, 256)
    assert got.shape == want.shape == (4, 1024)
    assert torch.equal(_bits(got), _bits(want))


def test_cpu_deposit_takes_the_planar_route():
    """Unforced, the CPU deposit sorts with ``torch.sort`` and runs no
    kernel: neither the payload sort nor kernel 5 counts a launch."""
    vblock = (4, 4, 4)
    args = _deposit_args(np.random.default_rng(9), 3, 2, 500, vblock)
    before = (rowsort.KERNEL.launches, dfscan.KERNEL.launches,
              dict(dfscan.ROUTES))
    deposit.cic_deposit_vranks_planar(*args, vblock)
    assert (rowsort.KERNEL.launches, dfscan.KERNEL.launches,
            dict(dfscan.ROUTES)) == before
