"""The port's halo exchange (``parallel/halo.py``, ``GridRedistribute.halo``
and ``oracle.brute_force_ghosts``, device="cpu") against the JAX
package's, bit for bit (tolerance 0) on ghost positions, fields, counts
and overflow: the row-major and planar vrank engines on grids (2,2,2)
periodic and open and (4,2,1) periodic, per-axis and zero widths, both
planar band paths (one banded sort, and two sorts at ``2w == cell_w``),
tight capacities that drop, a -0.0 face coordinate, fields of every
width, ``default_capacities`` over a sweep, the vectorised ghost oracle
against the reference's loops, and the public call under its three
overflow policies.

Each of the reference's ``tests/test_halo.py`` tests has a counterpart
here under the same name. Where the reference runs its ``shard_map``
engine on the 8-device CPU mesh, the port is held against the
reference's single-device vrank twin, which the reference's own tests
show is bit-identical to it; the public ``halo()`` is held against the
reference's ``GridRedistribute.halo`` itself (its mesh engines)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mpi_grid_redistribute_tpu as jgr
from mpi_grid_redistribute_tpu import oracle as joracle
from mpi_grid_redistribute_tpu.parallel import halo as jh
import mpi_grid_redistribute_tpu_torch as tgr
from mpi_grid_redistribute_tpu_torch import oracle
from mpi_grid_redistribute_tpu_torch.parallel import halo as th

torch.set_num_threads(1)

GRIDS = [((2, 2, 2), True), ((2, 2, 2), False), ((4, 2, 1), True)]


def _doms(periodic=True, lo=0.0, hi=1.0):
    return (jgr.Domain(lo, hi, periodic=periodic),
            tgr.Domain(lo, hi, periodic=periodic))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(np.ascontiguousarray(got).view(np.uint8),
                                  np.ascontiguousarray(want).view(np.uint8))


def _sorted_rows(a):
    """Rows sorted by their bit patterns (a set compared exactly)."""
    a = np.ascontiguousarray(_np(a))
    u = a.view(np.uint32)
    return u[np.lexsort(u.T[::-1])]


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _placed(rng, grid_shape, n_local, periodic=True, out_factor=3,
            clustered=False):
    """Uniform (or ``u**4``-clustered) rows moved onto their owners by the
    port's redistribute: ``(positions [R * oc, 3], count [R], oc)`` numpy,
    the padded layout the halo takes."""
    R = int(np.prod(grid_shape))
    pos = rng.uniform(0, 1, size=(R * n_local, 3))
    if clustered:
        pos = pos ** 4
    rd = tgr.GridRedistribute(tgr.Domain(0.0, 1.0, periodic=periodic),
                              grid_shape, device="cpu", capacity_factor=4.0,
                              out_capacity=out_factor * n_local)
    res = rd.redistribute(pos.astype(np.float32))
    oc = res.positions.shape[0] // R
    return res.positions.numpy(), res.count.numpy(), oc


def _rowmajor_pair(periodic, grid_shape, w, H, G, pos_v, count, *fields):
    """Both row-major vrank engines on the same arrays; asserts every
    output bit-equal and returns the port's outputs as numpy."""
    jd, td = _doms(periodic)
    want = jh.build_halo_vranks(jd, jgr.ProcessGrid(grid_shape), w, H, G)(
        pos_v, count, *fields)
    got = th.build_halo_vranks(td, tgr.ProcessGrid(grid_shape), w, H, G)(
        *_t(pos_v, count, *fields))
    assert len(got) == len(want)
    for g, x in zip(got, want):
        _same(g, x)
    return tuple(g.numpy() for g in got)


def _planar_pair(periodic, grid_shape, w, H, G, fused, count, domain=None):
    """Both planar vrank engines on the same ``[V, K, n]`` state."""
    jd, td = _doms(periodic) if domain is None else domain
    want = jh.build_halo_planar_vranks(jd, jgr.ProcessGrid(grid_shape), w,
                                       H, G)(fused, count)
    got = th.build_halo_planar_vranks(td, tgr.ProcessGrid(grid_shape), w, H,
                                      G)(*_t(fused, count))
    for g, x in zip(got, want):
        _same(g, x)
    return tuple(g.numpy() for g in got)


def _planar_of(pos_v, *rows):
    """``[V, n, 3]`` positions (+ ``[V, n]`` 32-bit fields) -> ``[V, K, n]``
    float32 fused state."""
    parts = [pos_v.transpose(0, 2, 1)]
    parts += [r[:, None, :].view(np.float32) for r in rows]
    return np.ascontiguousarray(np.concatenate(parts, axis=1))


def _check_brute_force(gpos, gcount, G, pos, count, oc, grid_shape, periodic,
                       w):
    """Per rank: the ghost count and the ghost row set (bit for bit)
    equal the port's oracle, which equals the reference's."""
    R = int(np.prod(grid_shape))
    shards = [pos[r * oc: r * oc + count[r]] for r in range(R)]
    jd, td = _doms(periodic)
    expected = oracle.brute_force_ghosts(td, tgr.ProcessGrid(grid_shape),
                                         shards, w)
    reference = joracle.brute_force_ghosts(jd, jgr.ProcessGrid(grid_shape),
                                           shards, w)
    for r in range(R):
        _same(expected[r], reference[r])
        got = gpos[r * G: r * G + gcount[r]]
        assert gcount[r] == len(expected[r]), (r, gcount[r],
                                               len(expected[r]))
        np.testing.assert_array_equal(_sorted_rows(got),
                                      _sorted_rows(expected[r]))


# ---- counterparts of the reference's tests/test_halo.py, in its order


@pytest.mark.parametrize("grid_shape,periodic", GRIDS)
def test_halo_matches_brute_force(rng, grid_shape, periodic):
    R = int(np.prod(grid_shape))
    pos, count, oc = _placed(rng, grid_shape, 64, periodic)
    w, H, G = 0.08, 256, 1024
    gpos, gcount, ov = _rowmajor_pair(periodic, grid_shape, w, H, G,
                                      pos.reshape(R, oc, 3), count)
    assert int(ov.sum()) == 0
    _check_brute_force(gpos.reshape(R * G, 3), gcount, G, pos, count, oc,
                       grid_shape, periodic, w)


def test_halo_fields_ride_along(rng):
    R, n_local = 8, 32
    pos, count, oc = _placed(rng, (2, 2, 2), n_local, out_factor=2)
    ids = np.arange(R * oc, dtype=np.int32)
    gpos, gcount, gids, _ = _rowmajor_pair(
        True, (2, 2, 2), 0.1, 128, 512, pos.reshape(R, oc, 3), count,
        ids.reshape(R, oc))
    # every ghost id names a real particle whose position matches the
    # ghost's modulo the extent
    for r in range(R):
        for k in range(gcount[r]):
            gid = int(gids[r, k])
            assert gid % oc < count[gid // oc]
            np.testing.assert_allclose(gpos[r, k] % 1.0, pos[gid] % 1.0,
                                       atol=1e-5)


def test_halo_width_validation():
    _, td = _doms()
    grid = tgr.ProcessGrid((2, 2, 2))
    for make in (th.vrank_halo_fn, th.vrank_halo_planar_fn):
        with pytest.raises(ValueError, match="exceeds subdomain width"):
            make(td, grid, 0.6, 8, 8)  # > cell width 0.5
        with pytest.raises(ValueError, match=">= 0"):
            make(td, grid, -0.1, 8, 8)
        with pytest.raises(ValueError, match="3 entries"):
            make(td, grid, (0.1, 0.1), 8, 8)


def test_halo_overflow_counted(rng):
    R, n_local = 8, 64
    pos, count, oc = _placed(rng, (2, 2, 2), n_local, out_factor=2)
    _, gcount, ov = _rowmajor_pair(True, (2, 2, 2), 0.25, 4, 8,
                                   pos.reshape(R, oc, 3), count)
    assert int(ov.sum()) > 0
    assert (gcount <= 8).all()
    _planar_pair(True, (2, 2, 2), 0.25, 4, 8,
                 _planar_of(pos.reshape(R, oc, 3)), count)


def test_default_capacities_uniform_headroom():
    jd, td = _doms()
    pc, gc = th.default_capacities(td, tgr.ProcessGrid((2, 2, 2)), 0.05,
                                   1000)
    # f = w/cell_w = 0.1 a direction; ghosts ~ (1.2^3 - 1) * 1000 = 728
    assert 728 * 2 <= gc <= 728 * 2 + 8
    assert pc >= 2 * 100
    with pytest.raises(ValueError):
        th.default_capacities(td, tgr.ProcessGrid((2, 2, 2)), 0.05, 0)
    # the config-6 numbers, and the reference's over a sweep
    assert th.default_capacities(td, tgr.ProcessGrid((2, 2, 2)), 0.05,
                                 1 << 20) == (301992, 1526728)
    assert th.default_capacities(td, tgr.ProcessGrid((2, 2, 2)), 0.05,
                                 1 << 18) == (75504, 381688)
    for shape in ((2, 2, 2), (4, 2, 1), (3, 5, 2)):
        for w in (0.0, 0.013, 0.05, (0.05, 0.1, 0.02), 0.1, 0.2):
            cw = min(tgr.ProcessGrid(shape).cell_widths(td))
            if isinstance(w, float) and w > cw:
                continue
            for n in (1, 7, 1000, 4099, 1 << 18):
                for headroom in (0.05, 1.0, 2.0, 3.7):
                    assert th.default_capacities(
                        td, tgr.ProcessGrid(shape), w, n, headroom
                    ) == jh.default_capacities(
                        jd, jgr.ProcessGrid(shape), w, n, headroom)


def test_halo_auto_capacities_no_overflow(rng):
    R, n_local = 8, 128
    pos, count, oc = _placed(rng, (2, 2, 2), n_local)
    _, td = _doms()
    pc, gc = th.default_capacities(td, tgr.ProcessGrid((2, 2, 2)), 0.08, oc)
    _, gcount, ov = _rowmajor_pair(True, (2, 2, 2), 0.08, pc, gc,
                                   pos.reshape(R, oc, 3), count)
    assert int(ov.sum()) == 0 and int(gcount.sum()) > 0


@pytest.mark.parametrize("grid_shape,periodic", GRIDS)
def test_vrank_halo_matches_brute_force(rng, grid_shape, periodic):
    """The planar engine (the public call's default) on the same cases:
    bit-equal to the reference's, and the oracle's ghost sets."""
    R = int(np.prod(grid_shape))
    pos, count, oc = _placed(rng, grid_shape, 64, periodic)
    w, H, G = 0.08, 256, 1024
    ghost, gcount, ov = _planar_pair(periodic, grid_shape, w, H, G,
                                     _planar_of(pos.reshape(R, oc, 3)), count)
    assert int(ov.sum()) == 0
    gpos = ghost.transpose(0, 2, 1).reshape(R * G, 3)
    _check_brute_force(gpos, gcount, G, pos, count, oc, grid_shape, periodic,
                       w)


def test_planar_halo_matches_rowmajor_bitlevel(rng):
    """The port's planar engine: the row-major engine's ghost set, order
    and bits, an int32 id row riding along; int32 input round-trips."""
    R, n_local = 8, 2048
    pos, count, oc = _placed(rng, (2, 2, 2), n_local, out_factor=2)
    ids = np.arange(R * oc, dtype=np.int32).reshape(R, oc)
    w, H, G = 0.1, 2048, 4096
    rpos, rcount, rids, rover = _rowmajor_pair(
        True, (2, 2, 2), w, H, G, pos.reshape(R, oc, 3), count, ids)
    fused = _planar_of(pos.reshape(R, oc, 3), ids)
    gplanar, pcount, pover = _planar_pair(True, (2, 2, 2), w, H, G, fused,
                                          count)
    np.testing.assert_array_equal(pcount, rcount)
    np.testing.assert_array_equal(pover, rover)
    for r in range(R):
        g = int(rcount[r])
        _same(gplanar[r, :3, :g].T.copy(), rpos[r, :g])
        _same(gplanar[r, 3, :g].view(np.int32), rids[r, :g])
    gi, ci, oi = th.build_halo_planar_vranks(
        tgr.Domain(0.0, 1.0, periodic=True), tgr.ProcessGrid((2, 2, 2)), w,
        H, G)(*_t(fused.view(np.int32), count))
    assert gi.dtype == torch.int32
    _same(gi.numpy().view(np.float32), gplanar)


def test_planar_halo_shard_map_matches_vranks(rng):
    """The reference's planar shard_map engine is bit-identical to its
    vrank twin; the port's planar engine equals that twin."""
    R, n_local = 8, 64
    pos, count, oc = _placed(rng, (2, 2, 2), n_local, out_factor=2)
    _planar_pair(True, (2, 2, 2), 0.1, 128, 512,
                 _planar_of(pos.reshape(R, oc, 3)), count)


def test_vrank_halo_matches_shard_map(rng):
    """The port's two engines give the same ghost multisets, the
    reference vrank twin's bits."""
    R, n_local = 8, 48
    pos, count, oc = _placed(rng, (2, 2, 2), n_local, out_factor=2)
    w, H, G = 0.1, 128, 512
    vpos, vcount, vov = _rowmajor_pair(True, (2, 2, 2), w, H, G,
                                       pos.reshape(R, oc, 3), count)
    ghost, pcount, pov = _planar_pair(True, (2, 2, 2), w, H, G,
                                      _planar_of(pos.reshape(R, oc, 3)),
                                      count)
    np.testing.assert_array_equal(pcount, vcount)
    np.testing.assert_array_equal(pov, vov)
    for r in range(R):
        np.testing.assert_array_equal(
            _sorted_rows(vpos[r, :vcount[r]]),
            _sorted_rows(ghost[r, :, :vcount[r]].T.copy()))


def _planar_matches_rowmajor(pos, count, oc, w, H, G):
    R = 8
    rpos, rcount, rover = _rowmajor_pair(True, (2, 2, 2), w, H, G,
                                         pos.reshape(R, oc, 3), count)
    gplanar, pcount, pover = _planar_pair(True, (2, 2, 2), w, H, G,
                                          _planar_of(pos.reshape(R, oc, 3)),
                                          count)
    np.testing.assert_array_equal(pcount, rcount)
    np.testing.assert_array_equal(pover, rover)
    for r in range(R):
        g = int(rcount[r])
        _same(gplanar[r, :3, :g].T.copy(), rpos[r, :g])
    return rover


@pytest.mark.parametrize("w", [0.2, 0.25, 0.3])
def test_planar_halo_band_widths_bitlevel(rng, w):
    """Both planar selection paths: one banded sort (w = 0.2) and two
    sorts (w = 0.25, where 2w == cell_w and the float32 thresholds can
    cross; w = 0.3)."""
    _, td = _doms()
    grid = tgr.ProcessGrid((2, 2, 2))
    widths, cell_w = th._validate_widths(td, grid, w)
    assert th._bands_disjoint(td, 0, widths, cell_w) == (w < 0.25)
    pos, count, oc = _placed(rng, (2, 2, 2), 512, out_factor=2)
    H, G = th.default_capacities(td, grid, w, oc)
    rover = _planar_matches_rowmajor(pos, count, oc, w, H, G)
    assert int(rover.sum()) == 0


@pytest.mark.parametrize("w", [0.2, 0.3])
def test_planar_halo_overflow_parity_bitlevel(rng, w):
    """Capacities far below the shell: both planar paths clip like the
    row-major engine (counters, counts, bits), as the reference's do."""
    pos, count, oc = _placed(rng, (2, 2, 2), 512, out_factor=2)
    rover = _planar_matches_rowmajor(pos, count, oc, w, 64, 160)
    assert int(rover.sum()) > 0


def _api_setup(rng, grid_shape=(2, 2, 2), n_local=64, periodic=True):
    pos, count, oc = _placed(rng, grid_shape, n_local, periodic)
    return pos, count


def _api_pair(grid_shape=(2, 2, 2), periodic=True, **kw):
    jd, td = _doms(periodic)
    return (tgr.GridRedistribute(td, grid_shape, device="cpu", **kw),
            jgr.GridRedistribute(jd, grid_shape, **kw))


def _same_halo(got, want):
    _same(got.ghost_positions, want.ghost_positions)
    _same(got.ghost_count, want.ghost_count)
    _same(got.overflow, want.overflow)
    assert len(got.ghost_fields) == len(want.ghost_fields)
    for g, w in zip(got.ghost_fields, want.ghost_fields):
        _same(g, w)


@pytest.mark.parametrize("engine", ["auto", "rowmajor"])
def test_api_halo_matches_brute_force(rng, engine):
    """``rd.halo(positions, width=...)`` with derived capacities: the
    reference's ``GridRedistribute.halo`` bits, and the oracle's sets."""
    pos, count = _api_setup(rng)
    t, j = _api_pair(engine=engine)
    w = 0.08
    got = t.halo(pos, width=w, count=count)
    assert isinstance(got, tgr.HaloResult)
    _same_halo(got, j.halo(pos, width=w, count=count))
    assert int(got.overflow.sum()) == 0
    G = got.ghost_positions.shape[0] // 8
    _check_brute_force(got.ghost_positions.numpy(), got.ghost_count.numpy(),
                       G, pos, count, pos.shape[0] // 8, (2, 2, 2), True, w)


def test_api_halo_fields_and_engine_parity(rng):
    """Fields ride through ``halo()``; the planar (auto) and row-major
    engines return the same ghosts in the same order; each ghost id maps
    back to its source modulo the extent."""
    pos, count = _api_setup(rng)
    ids = np.arange(pos.shape[0], dtype=np.int32)
    t_auto, j_auto = _api_pair()
    h_auto = t_auto.halo(pos, ids, width=0.07, count=count)
    _same_halo(h_auto, j_auto.halo(pos, ids, width=0.07, count=count))
    t_rm, _ = _api_pair(engine="rowmajor")
    h_rm = t_rm.halo(pos, ids, width=0.07, count=count)
    _same_halo(h_rm, h_auto)
    G = h_auto.ghost_positions.shape[0] // 8
    gp = h_auto.ghost_positions.numpy().reshape(8, G, 3)
    gi = h_auto.ghost_fields[0].numpy().reshape(8, G)
    for r in range(8):
        c = int(h_auto.ghost_count[r])
        d = np.abs(pos[gi[r, :c]] - gp[r, :c])
        assert np.minimum(d, 1.0 - d).max() < 1e-5


def test_api_halo_grow_on_overflow(rng):
    """Clustered rows overflow the starved budgets (``headroom=0.05``):
    ``"grow"`` heals them, reaching the reference's grown capacities and
    bits; ``"ignore"`` surfaces the overflow without a host read;
    ``"raise"`` raises."""
    pos, count, _ = _placed(rng, (2, 2, 2), 256, out_factor=8,
                            clustered=True)
    kw = dict(width=0.12, count=count, headroom=0.05)
    t_probe, j_probe = _api_pair(on_overflow="ignore")
    probe = t_probe.halo(pos, **kw)
    _same_halo(probe, j_probe.halo(pos, **kw))
    assert int(probe.overflow.sum()) > 0
    t, j = _api_pair()
    got = t.halo(pos, **kw)
    _same_halo(got, j.halo(pos, **kw))
    assert int(got.overflow.sum()) == 0
    widths = th._as_per_axis(0.12, 3)
    assert t._halo_caps == j._halo_caps and t._halo_caps
    dpc, dgc = th.default_capacities(tgr.Domain(0.0, 1.0, periodic=True),
                                     tgr.ProcessGrid((2, 2, 2)), widths,
                                     pos.shape[0] // 8, 0.05)
    spc, sgc = t._halo_caps[widths]
    assert spc >= dpc and sgc >= dgc and (spc, sgc) != (dpc, dgc)
    # the grown capacities stick: the next call starts from them
    _same_halo(t.halo(pos, **kw), got)
    t_raise, _ = _api_pair(on_overflow="raise")
    with pytest.raises(RuntimeError, match="halo overflow"):
        t_raise.halo(pos, **kw)
    # both capacities pinned: an overflow cannot be grown away
    t_pin, _ = _api_pair()
    with pytest.raises(RuntimeError, match="explicitly pinned"):
        t_pin.halo(pos, width=0.12, count=count, pass_capacity=16,
                   ghost_capacity=32)
    # one pinned: only the other grows
    t_one, j_one = _api_pair()
    got = t_one.halo(pos, width=0.12, count=count, headroom=0.05,
                     pass_capacity=4096)
    _same_halo(got, j_one.halo(pos, width=0.12, count=count, headroom=0.05,
                               pass_capacity=4096))
    assert t_one._halo_caps == j_one._halo_caps


def test_api_halo_grow_retries_with_grown_caps(rng):
    """Every capacity pair the loop grows to is run, capacities increase,
    and the pair that stuck is the last one run."""
    pos, count, _ = _placed(rng, (2, 2, 2), 256, out_factor=8,
                            clustered=True)
    t, _ = _api_pair()
    attempts = []
    real_once = t._halo_once

    def spy(positions, fields, count, widths, pc, gc, *planar_ok):
        attempts.append((pc, gc))
        return real_once(positions, fields, count, widths, pc, gc,
                         *planar_ok)

    t._halo_once = spy
    got = t.halo(pos, width=0.12, count=count, headroom=0.05)
    assert int(got.overflow.sum()) == 0
    assert len(attempts) >= 2
    for (pc0, gc0), (pc1, gc1) in zip(attempts, attempts[1:]):
        assert pc1 >= pc0 and gc1 >= gc0 and (pc1, gc1) != (pc0, gc0)
    assert t._halo_caps[th._as_per_axis(0.12, 3)] == attempts[-1]


def test_api_halo_grow_nonconvergence_reports_run_caps(rng):
    """Growth that never converges raises naming the capacities of the
    last run."""
    pos, count = _api_setup(rng)
    t, _ = _api_pair()
    attempts = []

    def always_overflow(positions, fields, count, widths, pc, gc,
                        *planar_ok):
        attempts.append((pc, gc))
        return th.HaloResult(positions, torch.zeros(8, dtype=torch.int32),
                             (), torch.ones(8, dtype=torch.int32))

    t._halo_once = always_overflow
    with pytest.raises(RuntimeError, match="did not converge") as ei:
        t.halo(pos, width=0.1, count=count)
    assert len(attempts) == 5
    last_pc, last_gc = attempts[-1]
    assert f"pass_capacity={last_pc}" in str(ei.value)
    assert f"ghost_capacity={last_gc}" in str(ei.value)


def test_api_halo_validation(rng):
    pos, count = _api_setup(rng)
    t, _ = _api_pair()
    with pytest.raises(ValueError, match="exceeds subdomain width"):
        t.halo(pos, width=0.9, count=count)
    with pytest.raises(ValueError, match=">= 0"):
        t.halo(pos, width=(0.1, -0.1, 0.1), count=count)
    _, td = _doms()
    tn = tgr.GridRedistribute(td, (2, 2, 2), backend="numpy")
    with pytest.raises(ValueError, match="brute_force_ghosts"):
        tn.halo(pos, width=0.05, count=count)
    e = tgr.GridEdges.balanced_for(
        td, tgr.ProcessGrid((2, 2, 2)),
        rng.uniform(0, 1, (4096, 3)).astype(np.float32))
    te = tgr.GridRedistribute(td, (2, 2, 2), device="cpu", edges=e)
    with pytest.raises(ValueError, match="uniform cells"):
        te.halo(pos, width=0.05, count=count)
    flag = np.zeros(pos.shape[0], bool)
    tp = tgr.GridRedistribute(td, (2, 2, 2), device="cpu", engine="planar")
    with pytest.raises(TypeError, match="32-bit"):
        tp.halo(pos, flag, width=0.05, count=count)
    with pytest.raises(ValueError, match="divide"):
        t.halo(pos[:9], width=0.05)


def test_api_halo_zero_width(rng):
    """width = 0: no ghosts anywhere, no overflow."""
    pos, count = _api_setup(rng)
    t, j = _api_pair()
    got = t.halo(pos, width=0.0, count=count)
    _same_halo(got, j.halo(pos, width=0.0, count=count))
    assert int(got.ghost_count.sum()) == 0 and int(got.overflow.sum()) == 0


# ---- where the bits are decided


@pytest.mark.parametrize("periodic", [True, False])
def test_negative_zero_face_coordinate_is_shifted_by_an_add(periodic):
    """On Domain(-1, 1) the interior faces are at 0.0. A row of cell
    (1, 1, 1) at (-0.0, -0.0, 0.5) is in the lo band of axes 0 and 1; its
    receivers are no wrap away, so the shift is zero, yet it is added:
    ``-0.0 + 0.0`` arrives as +0.0 on the pass's axis, the other axis
    keeping -0.0. The planar engine on open axes is the exception the
    reference's compiled program makes (its zero shift is folded away,
    every -0.0 keeps its sign; ROADMAP.md C7). Both engines, bit-equal
    to the reference's."""
    r = np.random.default_rng(21)
    R, n = 8, 40
    grid = jgr.ProcessGrid((2, 2, 2))
    pos = np.zeros((R, n, 3), np.float32)
    for v in range(R):
        pos[v] = -1.0 + (np.asarray(grid.cell_of_rank(v))
                         + r.random((n, 3), dtype=np.float32)).astype(
                             np.float32)
    src = grid.rank_of_cell((1, 1, 1))
    pos[src, 0] = (-0.0, -0.0, 0.5)
    count = np.full(R, n, np.int32)
    ids = np.arange(R * n, dtype=np.int32).reshape(R, n)
    doms = _doms(periodic, lo=-1.0, hi=1.0)
    jd, td = doms
    want = jh.build_halo_vranks(jd, grid, 0.2, 128, 512)(pos, count, ids)
    got = th.build_halo_vranks(td, tgr.ProcessGrid((2, 2, 2)), 0.2, 128,
                               512)(*_t(pos, count, ids))
    for g, x in zip(got, want):
        _same(g, x)
    gpos, gcount, gids = got[0].numpy(), got[1].numpy(), got[2].numpy()
    ghost, pcount, _ = _planar_pair(periodic, (2, 2, 2), 0.2, 128, 512,
                                    _planar_of(pos, ids), count, domain=doms)
    ppos = ghost[:, :3].transpose(0, 2, 1)
    pids = ghost[:, 3].view(np.int32)
    z, nz = 0, 0x80000000
    for cell, bits in (((0, 1, 1), [z, nz]), ((1, 0, 1), [nz, z]),
                       ((0, 0, 1), [z, z])):
        dst = grid.rank_of_cell(cell)
        k = np.flatnonzero(gids[dst, :gcount[dst]] == src * n)
        assert len(k) == 1
        assert list(gpos[dst, k[0], :2].view(np.uint32)) == bits, cell
        k = np.flatnonzero(pids[dst, :pcount[dst]] == src * n)
        assert list(ppos[dst, k[0], :2].view(np.uint32)) == (
            bits if periodic else [nz, nz]), cell
    if periodic:
        _same(ppos.copy(), gpos)


def test_fields_of_every_width_ride_the_rowmajor_engine(rng):
    """int32 ids, bool, int8 pairs, uint32, float16 and NaN-payload
    float32 fields keep their dtype and bits (the reference's ``where``
    lifts bool to int32 before its set into a bool buffer: still bool)."""
    R, n = 8, 200
    pos, count, oc = _placed(rng, (2, 2, 2), n, out_factor=2)
    pv = pos.reshape(R, oc, 3)
    b = rng.random((R, oc)) < 0.5
    i8 = rng.integers(-128, 127, (R, oc, 2)).astype(np.int8)
    u32 = rng.integers(0, 2**32, (R, oc), dtype=np.uint64).astype(np.uint32)
    f16 = rng.standard_normal((R, oc)).astype(np.float16)
    nan = rng.standard_normal((R, oc)).astype(np.float32)
    nan.view(np.uint32)[:, :3] = [0x7FC0BEEF, 0x00000001, 0x80000000]
    ids = np.arange(R * oc, dtype=np.int32).reshape(R, oc)
    out = _rowmajor_pair(True, (2, 2, 2), 0.1, 256, 1024, pv, count, ids, b,
                         i8, u32, f16, nan)
    assert [o.dtype for o in out[2:-1]] == [np.int32, np.bool_, np.int8,
                                            np.uint32, np.float16, np.float32]
    assert int(out[1].sum()) > 0


def test_select_cols_for_axis_equals_two_passes(rng):
    """One banded sort gives both directions' sends, counts and overflow
    bit for bit as two per-direction selections do, with and without
    clipping, periodic and open."""
    V, K, m = 8, 4, 3000
    dev = torch.device("cpu")
    cand = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (V, K, m),
                                         dtype=np.int64).astype(np.int32))
    cand[:, 0, :] = torch.from_numpy(
        rng.random((V, m), dtype=np.float32)).view(torch.int32)
    cand_valid = torch.from_numpy(rng.random((V, m)) < 0.9)
    coord = th._vrank_coords(tgr.ProcessGrid((2, 2, 2)))(0, dev)
    lo_a, hi_a = th._bounds_at(tgr.Domain(0.0, 1.0), 0, 0.5, coord,
                               torch.float32)
    lo_a, hi_a = lo_a * 0, hi_a * 0 + 1.0  # every vrank sees [0, 1)
    w = th._fill(0.3, torch.float32, dev)
    ext = th._fill(1.0, torch.float32, dev)
    at_hi, at_lo = coord == 1, coord == 0
    for periodic in (True, False):
        for H in (50, 800, 4000):
            merged = th._select_cols_for_axis(
                cand, cand_valid, 0, lo_a, hi_a, w, at_hi, at_lo, periodic,
                ext, H)
            hi = th._select_cols_for_pass(cand, cand_valid, 0, 1, lo_a, hi_a,
                                          w, at_hi, periodic, ext, H)
            lo = th._select_cols_for_pass(cand, cand_valid, 0, -1, lo_a,
                                          hi_a, w, at_lo, periodic, ext, H)
            for a, b in zip(merged, hi + lo):
                assert torch.equal(a, b)


def test_axis_band_order_fallback_matches_packed(rng, monkeypatch):
    """The two-key branch (taken past 29 bits of position) orders like the
    packed one."""
    mask_hi = torch.from_numpy(rng.random((3, 5000)) < 0.2)
    mask_lo = torch.from_numpy(rng.random((3, 5000)) < 0.2) & ~mask_hi
    packed = th._axis_band_order(mask_hi, mask_lo)
    monkeypatch.setattr(th, "_BAND_PACK_BITS", 0)
    assert torch.equal(th._axis_band_order(mask_hi, mask_lo), packed)


@pytest.mark.parametrize("grid_shape,periodic", GRIDS)
def test_brute_force_ghosts_matches_the_reference_oracle(rng, grid_shape,
                                                         periodic):
    """The vectorised oracle returns the reference's rows in its order
    (per-axis and scalar widths, ragged and empty shards)."""
    R = int(np.prod(grid_shape))
    jd, td = _doms(periodic)
    pos, count, oc = _placed(rng, grid_shape, 40, periodic)
    count[1] = 0
    shards = [pos[r * oc: r * oc + count[r]] for r in range(R)]
    for w in (0.1, (0.05, 0.2, 0.0), 0.0):
        got = oracle.brute_force_ghosts(td, tgr.ProcessGrid(grid_shape),
                                        shards, w)
        want = joracle.brute_force_ghosts(jd, jgr.ProcessGrid(grid_shape),
                                          shards, w)
        assert len(got) == len(want)
        for g, x in zip(got, want):
            _same(g, x)


def test_config6_bench_matches_the_reference_setup():
    """The config-6 twin builds the reference's state, width and
    capacities; its timing loops (both engines, the ghost statistic
    carried forward) run on the CPU at a small width, every exchange
    equal to the reference's engine on the same state."""
    from mpi_grid_redistribute_tpu.bench import common as jcommon
    from mpi_grid_redistribute_tpu_torch.bench import config6_halo

    n = 512
    pos_v, count, w, pc, gc = config6_halo.setup(n)
    jd = jgr.Domain(0.0, 1.0, periodic=True)
    jgrid = jgr.ProcessGrid((2, 2, 2))
    jpos, _, _ = jcommon.uniform_state((2, 2, 2), n, 1.0,
                                       np.random.default_rng(0))
    _same(pos_v, jpos.reshape(8, n, 3))
    assert w == 0.1 * min(jgrid.cell_widths(jd)) == 0.05
    assert (pc, gc) == jh.default_capacities(jd, jgrid, w, n)
    np.testing.assert_array_equal(count, np.full(8, n, np.int32))
    want = jh.build_halo_vranks(jd, jgrid, w, pc, gc)(pos_v, count)
    case = config6_halo.prepare(n, "cpu")
    assert (case.n_local, case.w) == (n, w)
    assert (case.pass_capacity, case.ghost_capacity) == (pc, gc)
    _same(case.states["rowmajor"], pos_v)
    _same(case.states["planar"], _planar_of(pos_v))
    for engine in ("rowmajor", "planar"):
        run = config6_halo.make_loop(engine, case.fns[engine],
                                     case.states[engine], case.count)(3)
        p, gcounts, overflows = run()
        _same(p, case.states[engine])
        for s in range(3):
            _same(gcounts[s], want[1])
            _same(overflows[s], want[2])
    with pytest.raises(RuntimeError, match="CUDA"):
        config6_halo.run(n)
