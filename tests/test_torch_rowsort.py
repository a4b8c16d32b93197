"""The scan deposit's payload sort (``ops/rowsort``) and its route through
the deposit, on the CPU.

``sort_rows`` on the CPU is its plain version: a stable ``torch.sort``
of the key and one ``index_select`` of the packed rows. These tests hold
that version to the sort the deposit ran before (the planar payload's
gather), pin the row layout kernel 5 reads, and drive the deposit's
rows route on the CPU (the route forced, each op on its plain version):
the same bits as the planar route, at every cut of the knockout. The
card's kernel is held to the plain version in ``tests/test_torch_cuda.py``.
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
    keys_s, rows_s = rowsort.sort_rows(key, rel, mass,
                                       n_keys.bit_length())
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


def test_sort_rows_out_hook_and_checks():
    key, rel, mass = _inputs(np.random.default_rng(6), 3, 300, 40)
    before = rowsort.KERNEL.launches
    want = rowsort.sort_rows_plain(key, rel, mass, 6)
    out = (torch.empty(300, dtype=torch.int32), torch.empty((300, 4)))
    got = rowsort.sort_rows(key, rel, mass, 6, _out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert rowsort.KERNEL.launches == before  # the CPU launches nothing
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
    with pytest.raises(ValueError):
        rowsort.sort_rows(key, rel, mass, 6,
                          _out=(out[0], torch.empty((300, 3))))
    bad = [
        (key.long(), rel, mass, 6), (key, rel.double(), mass, 6),
        (key, torch.cat([rel, rel[:1]]), mass, 6), (key, rel[:, :5], mass, 6),
        (key, rel, mass[:5], 6), (key[None], rel, mass, 6),
    ]
    for args in bad:
        with pytest.raises(TypeError):
            rowsort.sort_rows(*args)
    for bits in (0, 33):
        with pytest.raises(ValueError):
            rowsort.sort_rows(key, rel, mass, bits)


def test_sort_rows_cost_counts_each_byte_once():
    key, rel, mass = _inputs(np.random.default_rng(7), 3, 100, 9)
    assert rowsort.kernel_cost(key, rel, mass, 4) == (100 * 20 + 100 * 20,
                                                      0)
    assert rowsort.launch_functions(key, rel[:2]) == [
        ("rowsort_pack_kernel<2>", 256, 0)]


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
    """The deposit's rows route forced on the CPU, where ``sort_rows``
    and ``cic_tile_prefix_rows`` run their plain versions."""
    monkeypatch.setattr(deposit, "_payload_route",
                        lambda device, n, D, tile, plain:
                        "planar" if plain else "rows")


@pytest.mark.parametrize("D,vblock", [(1, (16,)), (2, (8, 4)),
                                      (3, (4, 4, 4))])
@pytest.mark.parametrize("tile", [256, 7])
def test_rows_route_deposit_is_bit_equal_to_the_planar_route(
        rows_route_on_the_cpu, D, vblock, tile):
    args = _deposit_args(np.random.default_rng(D + tile), D, 3, 700, vblock)
    got = deposit.cic_deposit_vranks_planar(*args, vblock, tile=tile)
    want = deposit.cic_deposit_vranks_planar(*args, vblock, tile=tile,
                                             plain=True)
    assert got.shape == (3,) + tuple(b + 1 for b in vblock)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("cut", [2, 3, 4, 5])
def test_rows_route_knockout_cuts_hold_what_the_planar_route_holds(
        rows_route_on_the_cpu, cut):
    """``_stop_after`` on the rows route: after the sort (2) the sorted
    keys, coordinates and masses; after bounds, prefixes and gathers the
    same tensors as the planar route, bit for bit."""
    vblock = (4, 4, 4)
    args = _deposit_args(np.random.default_rng(cut), 3, 2, 900, vblock)
    got = deposit.cic_deposit_vranks_planar(*args, vblock, _stop_after=cut)
    want = deposit.cic_deposit_vranks_planar(*args, vblock, plain=True,
                                             _stop_after=cut)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g.contiguous().view(torch.uint8),
                           w.contiguous().view(torch.uint8))
    if cut == 2:
        key, rel, mass = deposit.cic_deposit_vranks_planar(
            *args, vblock, _stop_after=1)
        keys_s, order = torch.sort(key.reshape(-1), stable=True)
        assert torch.equal(got[0], keys_s)
        assert torch.equal(_bits(got[1]), _bits(rel[:, order]))
        assert torch.equal(_bits(got[2]), _bits(mass[order]))


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
