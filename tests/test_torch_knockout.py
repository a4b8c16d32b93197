"""The knockout twins (``bench/knockout_stages.py``,
``bench/knockout_pipeline.py``, ``bench/knockout_deposit.py``) on the
CPU: every phase runs, a cut before the landing leaves the state the
drift made, and the last phase's state is bit-equal to the reference's
step on the same state: the JAX package's
``make_migrate_loop(engine="planar")`` for the migrate step, and its
``service.pipeline`` chunk for the pipelined step (dt a power of two: no
FMA can change a bit). The deposit's cuts hold what each phase made (the
keys, the sorted payload, the bounds, the prefixes, the per-cell sums),
and its last phase is ``cic_deposit_vranks_planar`` and the ghost fold,
bit for bit (the port's deposit is held against the reference's in
``tests/test_torch_deposit.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu import api as japi
from mpi_grid_redistribute_tpu.domain import Domain as JDomain
from mpi_grid_redistribute_tpu.domain import ProcessGrid as JGrid
from mpi_grid_redistribute_tpu.models import nbody as jnbody
from mpi_grid_redistribute_tpu.parallel import mesh as jmesh
from mpi_grid_redistribute_tpu.service import pipeline as jpipeline
from mpi_grid_redistribute_tpu_torch.bench import (
    knockout_deposit, knockout_pipeline, knockout_stages,
)
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops import deposit, driftbin
from mpi_grid_redistribute_tpu_torch.telemetry import phases as phases_lib

GRID = (2, 2, 2)
N = 512
STEPS = 3


def _u8(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _drift_only(fused, steps):
    f = fused.clone()
    for _ in range(steps):
        driftbin.drift_wrap(f, knockout_stages.DT,
                            Domain(0.0, 1.0, periodic=True))
    return f


@pytest.mark.parametrize("phase", knockout_stages.PHASES)
def test_stages_every_phase_runs(phase):
    st = knockout_stages.make_state(GRID, N, "cpu")
    out = knockout_stages.loop_builder(GRID, N)(phase, STEPS)(*st)
    alive0 = int((st.fused[-1] > 0).sum())
    if phase != 7:  # 7 lands without the stack update: pops go stale
        assert int((out.fused[-1] > 0).sum()) == alive0  # nothing lost
    if phase <= 6:
        # cut before the landing: the state is the drift's alone
        assert torch.equal(out.fused, _drift_only(st.fused, STEPS))
        assert torch.equal(out.free_stack, st.free_stack)
    elif phase == 7:
        assert torch.equal(out.n_free, st.n_free)  # no stack update yet
    # the state the loop was given is left as it was
    assert torch.equal(st.fused, knockout_stages.make_state(
        GRID, N, "cpu").fused)


def test_stages_phase_8_is_the_references_planar_step():
    st = knockout_stages.make_state(GRID, N, "cpu")
    out = knockout_stages.loop_builder(GRID, N)(8, STEPS)(*st)
    C, M = knockout_stages.sizing(GRID, N)
    f = st.fused.numpy()
    cfg = jnbody.DriftConfig(
        domain=JDomain(0.0, 1.0, periodic=True), grid=JGrid((1, 1, 1)),
        dt=knockout_stages.DT, capacity=C, n_local=N, local_budget=M,
        engine="planar")
    mesh = jmesh.make_mesh(JGrid((1, 1, 1)), jax.devices()[:1])
    p, v, a, _ = jnbody.make_migrate_loop(cfg, mesh, STEPS,
                                          vgrid=JGrid(GRID))(
        jnp.asarray(f[:3].view(np.float32).reshape(-1)),
        jnp.asarray(f[3:6].view(np.float32).reshape(-1)),
        jnp.asarray(f[6] > 0))
    got = out.fused.numpy()
    assert np.array_equal(_u8(got[:3].view(np.float32).reshape(-1)), _u8(p))
    assert np.array_equal(_u8(got[3:6].view(np.float32).reshape(-1)),
                          _u8(v))
    assert np.array_equal(got[6] > 0, np.asarray(a))
    # and the port's own loop: the same step, not a copy
    from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid
    from mpi_grid_redistribute_tpu_torch.models import nbody

    tcfg = nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True), grid=ProcessGrid((1, 1, 1)),
        dt=knockout_stages.DT, capacity=C, n_local=N, local_budget=M,
        engine="planar")
    tp, tv, ta, _ = nbody.make_migrate_loop(
        tcfg, STEPS, vgrid=ProcessGrid(GRID), device="cpu")(
        st.fused[:3].view(torch.float32).reshape(-1).clone(),
        st.fused[3:6].view(torch.float32).reshape(-1).clone(),
        st.fused[6] > 0)
    assert torch.equal(tp.view(torch.int32),
                       out.fused[:3].reshape(-1))
    assert torch.equal(ta, out.fused[6] > 0)


@pytest.mark.parametrize("phase", knockout_pipeline.PHASES)
def test_pipeline_every_phase_runs(phase):
    """Each phase cuts the chunk's own steady-state step: a cut drops
    what its step made, so a cut chunk ends as a chunk of one step does
    whatever its length, and only the whole step reports every step."""
    st = knockout_pipeline.make_state(GRID, N, "cpu")
    build = knockout_pipeline.loop_builder(GRID, N, st)
    (pos, vel, ids, count), ys = build(phase, STEPS)(*st)
    assert int(count.sum()) == int(st[3].sum())  # nothing lost
    assert ys["count"].shape[0] == (
        STEPS + 1 if phase == knockout_pipeline.PHASES[-1] else 1)
    if phase != knockout_pipeline.PHASES[-1]:
        (pos2, vel2, ids2, count2), _ = build(phase, 1)(*st)
        for a, b in ((pos, pos2), (vel, vel2), (ids, ids2),
                     (count, count2)):
            assert torch.equal(a, b)
    # the template the chunk was given is left as it was
    for a, b in zip(st, knockout_pipeline.make_state(GRID, N, "cpu")):
        assert torch.equal(a, b)


def test_pipeline_cut_refuses_the_sequential_chunk():
    from mpi_grid_redistribute_tpu_torch import api
    from mpi_grid_redistribute_tpu_torch.service import pipeline

    st = knockout_pipeline.make_state(GRID, N, "cpu")
    rd = api.GridRedistribute(grid=GRID, lo=(0.0,) * 3, hi=(1.0,) * 3,
                              periodic=(True,) * 3, device="cpu")
    with pytest.raises(ValueError, match="armed pipelined step"):
        # a chunk of one step degrades to the sequential chunk
        pipeline.make_pipelined_chunk_fn(rd, knockout_pipeline.DT, 1,
                                         *st[:3], _stop_after=1)
    with pytest.raises(ValueError, match="_stop_after must be"):
        pipeline.make_pipelined_chunk_fn(rd, knockout_pipeline.DT, 4,
                                         *st[:3], _stop_after=4)


def test_pipeline_last_phase_is_the_references_step():
    """The whole phase is the port's pipelined chunk, bit-equal to the
    reference's ``service.pipeline`` chunk on the same state (a (2, 2,
    4) grid: the reference arms its pipeline on vranks only, more ranks
    than its 8 CPU devices; every step of this start has backlog)."""
    grid = (2, 2, 4)
    st = knockout_pipeline.make_state(grid, N, "cpu")
    (pos, vel, ids, count), ys = knockout_pipeline.loop_builder(
        grid, N, st)(knockout_pipeline.PHASES[-1], STEPS - 1)(*st)
    jrd = japi.GridRedistribute(grid=JGrid(grid), lo=(0.0,) * 3,
                                hi=(1.0,) * 3, periodic=(True,) * 3,
                                engine="auto")
    js = tuple(jnp.asarray(x.numpy()) for x in st)
    macro, _, _ = jpipeline.make_pipelined_chunk_fn(
        jrd, knockout_pipeline.DT, STEPS, *js[:3])
    (wp, wv, wi, wc), wys = jax.tree.map(np.asarray, macro(*js))
    for got, want in ((pos, wp), (vel, wv), (ids, wi), (count, wc),
                      (ys["count"], wys["count"]),
                      (ys["stats"].send_counts, wys["stats"].send_counts),
                      (ys["stats"].dropped_send,
                       wys["stats"].dropped_send)):
        assert np.array_equal(_u8(got.numpy()), _u8(want))
    assert int(ys["stats"].send_counts.sum()) > 0


@pytest.mark.parametrize("mod", [knockout_stages, knockout_pipeline,
                                 knockout_deposit])
def test_attribution_rows_on_the_cpu(mod):
    kw = {"mesh_cells": MESH} if mod is knockout_deposit else {}
    rows = mod.run(256, GRID, device="cpu", s1=1, s2=2, reps=1, **kw)
    assert [r.phase for r in rows] == list(mod.PHASES)
    assert all(isinstance(r, phases_lib.PhaseTiming) for r in rows)
    assert all(r.logical_bytes is not None for r in rows)
    # the roofline column divides by HBM3's 3.35 TB/s
    r = rows[1]
    assert r.roofline_s == pytest.approx(r.logical_bytes / 3.35e12)
    # each cumulative reading carries the range of its samples
    assert all(r.spread_s is not None and r.spread_s >= 0 for r in rows)


def test_stages_cut_refuses_the_sparse_engine():
    from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid
    from mpi_grid_redistribute_tpu_torch.parallel import migrate

    fn = migrate.shard_migrate_vranks_fn(
        Domain(0.0, 1.0, periodic=True), ProcessGrid((1, 1, 1)),
        ProcessGrid(GRID), 64, mover_cap=16)
    st = knockout_stages.make_state(GRID, N, "cpu")
    with pytest.raises(ValueError, match="one-device dense step"):
        fn(st, _stop_after=3)


MESH = 16  # the deposit's mesh cells per axis at the CPU's size


@pytest.mark.parametrize("phase", knockout_deposit.PHASES)
def test_deposit_every_cut_runs(phase):
    st = knockout_deposit.make_state(GRID, N, "cpu")
    k = knockout_deposit.PHASES.index(phase) + 1
    out = knockout_deposit.loop_builder(MESH)(phase, 2)(*st)
    m, n_cells = st[0].shape[1], MESH ** 3
    live = int(st[2].sum())
    if k == 1:
        key, rel, mass_z = out
        key = key.reshape(-1)  # [V = 1, m]
        assert key.shape == (m,) and rel.shape == (3, m)
        assert int((key < n_cells).sum()) == live
        assert float(mass_z.sum()) == live
    elif k == 2:
        keys_s, rel_s, mass_s = out
        assert bool((keys_s[1:] >= keys_s[:-1]).all())
        assert rel_s.shape == (3, m) and float(mass_s.sum()) == live
    elif k == 3:
        bounds, frac = out
        assert bounds.shape == (n_cells + 1,)
        assert bool((bounds[1:] >= bounds[:-1]).all())
        assert int(bounds[-1]) == live and bool((frac >= 0).all())
    elif k == 4:
        assert len(out) == 4  # (hi, lo) tile prefixes, tile-total scans
        assert out[0].shape[0] == 8 and out[0].shape[-1] == 256
    elif k == 5:
        assert out.shape == (8, n_cells)
        assert float(out.double().sum()) == pytest.approx(live)
    else:
        assert out.shape == (MESH,) * 3
        assert float(out.double().sum()) == pytest.approx(live)
    # the deposit reads its inputs only
    assert all(torch.equal(a, b) for a, b in zip(
        st, knockout_deposit.make_state(GRID, N, "cpu")))


def test_deposit_phase_6_is_the_deposit_and_its_fold():
    st = knockout_deposit.make_state(GRID, N, "cpu")
    out = knockout_deposit.loop_builder(MESH)(knockout_deposit.PHASES[-1],
                                              1)(*st)
    lo = torch.zeros((1, 3), dtype=torch.float32)
    inv_h = torch.full((3,), float(MESH), dtype=torch.float32)
    ghost = deposit.cic_deposit_vranks_planar(
        st[0], st[1], st[2], lo, inv_h, (MESH,) * 3)[0]
    want = deposit.fold_ghosts(ghost, ProcessGrid((1, 1, 1)))
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_deposit_cut_refuses_an_unknown_phase():
    st = knockout_deposit.make_state(GRID, 64, "cpu")
    lo = torch.zeros((1, 3), dtype=torch.float32)
    inv_h = torch.full((3,), float(MESH), dtype=torch.float32)
    with pytest.raises(ValueError, match="_stop_after must be 1 to 5"):
        deposit.cic_deposit_vranks_planar(st[0], st[1], st[2], lo, inv_h,
                                          (MESH,) * 3, _stop_after=6)
