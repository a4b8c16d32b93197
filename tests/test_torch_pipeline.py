"""The port's software-pipelined service chunk
(``service.pipeline.make_pipelined_chunk_fn``) against the JAX package's
on the CPU.

The reference arms its pipeline only on vranks (more ranks than its 8
forced CPU devices), so the armed path is held on a 16-rank ``(2, 2,
4)`` grid: the port's macro is bit-equal to the reference's pipelined
macro, state and ys, and has the sequential chunk's particle set and
counts. The reference picks the sequential ordering with a ``lax.cond``
on steps whose grants withheld movers; the port always runs the
pipelined one and is bit-equal there too (a backlog case). Each degrade
(chunk 1, a ragged receive capacity, several devices) journals the
reference's reason and hands back the sequential chunk. ``dt`` is a
power of two: jitted JAX on the CPU fuses ``p + v*dt`` into an FMA, the
port and the chip do not (ROADMAP C10). Every comparison is bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu import api as japi
from mpi_grid_redistribute_tpu.domain import ProcessGrid as JGrid
from mpi_grid_redistribute_tpu.parallel import mesh as jmesh
from mpi_grid_redistribute_tpu.service import elastic as jelastic
from mpi_grid_redistribute_tpu.service import pipeline as jpipeline
from mpi_grid_redistribute_tpu.service import resident as jresident
from mpi_grid_redistribute_tpu_torch import api
from mpi_grid_redistribute_tpu_torch.service import (
    ResidentLayoutError, elastic, make_chunk_fn, make_pipelined_chunk_fn,
    pipeline,
)
from torch_rank_cases import SERVICE_DT
from torch_rank_cases import service_state as template_state

torch.set_num_threads(1)

GRID = (2, 2, 4)
DT = SERVICE_DT


def _rds(**kw):
    base = dict(grid=GRID, lo=(0.0,) * 3, hi=(1.0,) * 3,
                periodic=(True,) * 3, engine="auto")
    base.update(kw)
    jkw = dict(base)
    jkw["grid"] = JGrid(tuple(base["grid"]))
    return (japi.GridRedistribute(**jkw),
            api.GridRedistribute(device="cpu", **base))


def _t(state):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in state)


def _j(state):
    return tuple(jnp.asarray(a) for a in state)


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x).view(np.uint8)


def assert_tree_bits(got, want, path="ys"):
    """Every leaf of a port output (tensors, stats tuples, dicts) equal
    in bits to the reference's; ``None`` leaves on both sides."""
    if isinstance(got, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in got:
            assert_tree_bits(got[k], want[k], f"{path}.{k}")
    elif isinstance(got, tuple):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            name = getattr(got, "_fields", None)
            assert_tree_bits(g, w, f"{path}.{name[i] if name else i}")
    elif got is None:
        assert want is None, path
    else:
        w = np.asarray(want)
        assert tuple(got.shape) == w.shape, (path, got.shape, w.shape)
        assert _bits(got).tobytes() == _bits(w).tobytes(), path


def _pipeline_reasons(rec):
    return [e.data["reason"] for e in rec.events("engine_resolved")
            if str(e.data.get("reason", "")).startswith("pipeline:")]


@pytest.mark.parametrize("chunk", [2, 7, 16])
def test_armed_macro_bit_equal_to_reference(chunk):
    jrd, trd = _rds()
    state = template_state(GRID, 64)
    want_macro, jcap, jout = jpipeline.make_pipelined_chunk_fn(
        jrd, DT, chunk, *_j(state)[:3])
    macro, cap, out_cap = make_pipelined_chunk_fn(trd, DT, chunk,
                                                  *_t(state)[:3])
    assert (cap, out_cap) == (jcap, jout)
    assert _pipeline_reasons(trd.telemetry) == _pipeline_reasons(
        jrd.telemetry) == ["pipeline: armed (vranks planar two-phase)"]
    want = jax.tree.map(np.asarray, want_macro(*_j(state)))
    got = macro(*_t(state))
    assert_tree_bits(got[0], tuple(want[0]), "state")
    assert_tree_bits(got[1], want[1])
    assert bool(got[1]["stats"].pipeline.all())
    assert int(got[1]["stats"].send_counts.sum()) > 0


def test_armed_macro_matches_sequential_particle_set():
    """The pipelined chunk ends with the sequential chunk's particles,
    counts, per-step counts and send tables, nothing dropped and every
    step's pipeline flag set (the reference's own check, on the
    port)."""
    _, trd = _rds()
    state = _t(template_state(GRID, 64))
    seq, _, _ = make_chunk_fn(trd, DT, 7, *state[:3])
    pipe, _, _ = make_pipelined_chunk_fn(trd, DT, 7, *state[:3])
    (sp, sv, si, sc), s_ys = seq(*state)
    (pp, pv, pi, pc), p_ys = pipe(*state)
    assert elastic.particle_set(pp, pv, pi, pc) == elastic.particle_set(
        sp, sv, si, sc)
    assert torch.equal(pc, sc)
    assert torch.equal(p_ys["count"], s_ys["count"])
    assert torch.equal(p_ys["stats"].send_counts, s_ys["stats"].send_counts)
    for leaf in ("dropped_send", "dropped_recv"):
        assert int(getattr(p_ys["stats"], leaf).sum()) == 0
        assert int(getattr(s_ys["stats"], leaf).sum()) == 0
    assert p_ys["stats"].pipeline.shape == (7, 16)
    assert bool(p_ys["stats"].pipeline.all())
    assert s_ys["stats"].pipeline is None


def test_backlog_steps_bit_equal_to_the_references_sequential_branch():
    """A convergent flow into one rank: its free slots run out after
    three steps and the grants withhold movers from then on
    (``stats.pipeline`` 0 there), where the reference's ``cond`` runs
    its sequential ordering. The port's one ordering gives the same
    bits, state and ys, over clean and backlog steps."""
    jrd, trd = _rds()
    pos, vel, ids, count = template_state(GRID, 32, seed=5)
    sink = np.asarray([0.3, 0.3, 0.1], np.float32)
    vel = ((sink - pos) * np.float32(0.5)).astype(np.float32)
    state = (pos, vel, ids, count)
    want_macro, _, _ = jpipeline.make_pipelined_chunk_fn(
        jrd, DT, 8, *_j(state)[:3])
    macro, _, _ = make_pipelined_chunk_fn(trd, DT, 8, *_t(state)[:3])
    want = jax.tree.map(np.asarray, want_macro(*_j(state)))
    got = macro(*_t(state))
    flags = np.asarray(want[1]["stats"].pipeline)
    assert not flags.all() and flags.any(), flags[:, 0]
    assert int(got[1]["stats"].dropped_send.sum()) > 0
    assert_tree_bits(got[0], tuple(want[0]), "state")
    assert_tree_bits(got[1], want[1])


def test_chunk1_degrades_to_the_sequential_chunk():
    jrd, trd = _rds()
    state = template_state(GRID, 32)
    jpipeline.make_pipelined_chunk_fn(jrd, DT, 1, *_j(state)[:3])
    macro, cap, out_cap = make_pipelined_chunk_fn(trd, DT, 1,
                                                  *_t(state)[:3])
    assert _pipeline_reasons(trd.telemetry) == _pipeline_reasons(
        jrd.telemetry) == ["pipeline: chunk < 2 — sequential body"]
    seq, seq_cap, seq_out = make_chunk_fn(trd, DT, 1, *_t(state)[:3])
    assert (cap, out_cap) == (seq_cap, seq_out)
    got = macro(*_t(state))
    want = seq(*_t(state))
    assert_tree_bits(got, want, "macro")
    assert got[1]["stats"].pipeline is None


def test_ragged_capacity_degrades_with_sequential_error():
    jrd, trd = _rds(out_capacity=128)
    state = template_state(GRID, 64)
    with pytest.raises(jresident.ResidentLayoutError):
        jpipeline.make_pipelined_chunk_fn(jrd, DT, 4, *_j(state)[:3])
    with pytest.raises(ResidentLayoutError, match="out_capacity 128"):
        make_pipelined_chunk_fn(trd, DT, 4, *_t(state)[:3])
    assert _pipeline_reasons(trd.telemetry) == _pipeline_reasons(
        jrd.telemetry) == [
            "pipeline: ragged receive capacity — sequential body"]


def test_payload_not_planar_degrades():
    """Velocities of another width than the positions: the drift cannot
    run inside the planar matrix."""
    jrd, trd = _rds()
    pos, vel, ids, count = template_state(GRID, 32)
    vel2 = np.ascontiguousarray(vel[:, :2])
    jpipeline.make_pipelined_chunk_fn(jrd, DT, 4, jnp.asarray(pos),
                                      jnp.asarray(vel2), jnp.asarray(ids))
    make_pipelined_chunk_fn(trd, DT, 4, *_t((pos, vel2, ids)))
    assert _pipeline_reasons(trd.telemetry) == _pipeline_reasons(
        jrd.telemetry) == [
            "pipeline: payload not planar-eligible — sequential body"]
    assert not pipeline._drift_compatible(None, 3)


def test_multidevice_topology_degrades_as_the_reference():
    """The reference's 8-rank grid on its 8 CPU devices (a mesh) and the
    port's rank mesh both degrade with the multi-device reason; the
    port's world run lives in ``test_torch_migrate_ranks.py``, this
    holds the reference's journal to the port's resolution rule."""
    from mpi_grid_redistribute_tpu_torch.parallel import exchange

    grid = JGrid((2, 2, 2))
    mesh = jmesh.make_mesh(grid, jax.devices()[:8])
    jrd = japi.GridRedistribute(grid=grid, lo=(0.0,) * 3, hi=(1.0,) * 3,
                                periodic=(True,) * 3, engine="auto",
                                mesh=mesh)
    state = template_state((2, 2, 2), 32)
    macro, _, _ = jpipeline.make_pipelined_chunk_fn(jrd, DT, 4,
                                                    *_j(state)[:3])
    assert not getattr(macro.__wrapped__, "_progcheck_pipeline", False)
    port = exchange.resolve_two_phase("auto", chunk=4, vranks=False,
                                      n_devices=8)
    assert _pipeline_reasons(jrd.telemetry) == [port.reason] == [
        "pipeline: multi-device topology — sequential body"]


def test_landing_targets_unique_under_overlay_debug(monkeypatch):
    """``MPI_GRID_OVERLAY_DEBUG=1`` checks every landing scatter's
    in-range targets for duplicates: the pipelined chunk's landings
    (K = 9 with the key row, then 8) pass it, one check a step."""
    from mpi_grid_redistribute_tpu_torch.ops import overlay

    calls = []
    check = overlay._raise_on_duplicate_targets

    def counted(targets, m):
        calls.append(m)
        return check(targets, m)

    monkeypatch.setenv("MPI_GRID_OVERLAY_DEBUG", "1")
    monkeypatch.setattr(overlay, "_raise_on_duplicate_targets", counted)
    _, trd = _rds()
    state = _t(template_state(GRID, 64))
    macro, _, _ = make_pipelined_chunk_fn(trd, DT, 7, *state[:3])
    macro(*state)
    assert calls == [16 * 64] * 7
    with pytest.raises(ValueError, match="duplicate"):
        overlay.overlay_scatter_planar(
            torch.zeros((9, 8), dtype=torch.int32),
            torch.tensor([1, 1], dtype=torch.int32),
            torch.ones((9, 2), dtype=torch.int32))
