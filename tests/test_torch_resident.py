"""The port's chunked service step (``service.resident.make_chunk_fn``)
against the JAX package's on the CPU: for chunks of 1, 7 and 16 steps the
macro's state and ys (every stats leaf, the per-step counts) are
bit-equal to the reference's macro on the same inputs, with capacities
roomy and tight (drops reported, not healed, as there); a chunk equals
the eager per-step loop of ``service_drift`` and ``redistribute``;
``ResidentLayoutError`` on a ragged carry; and the macro reads nothing
back to the host (every host read of a tensor made to raise).

The grid is ``(2, 2, 4)``: 16 ranks on the reference's 8 CPU devices run
as vranks there, as on the port's one device. ``dt`` is a power of two
(ROADMAP C10). Every comparison is bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu.models import nbody as jnbody
from mpi_grid_redistribute_tpu.service import resident as jresident
from mpi_grid_redistribute_tpu_torch.models import nbody
from mpi_grid_redistribute_tpu_torch.service import (
    ResidentLayoutError, final_stats, make_chunk_fn, resident,
)
from test_torch_pipeline import (
    DT, GRID, _j, _rds, _t, assert_tree_bits, template_state,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("capacity", [None, 1], ids=["roomy", "tight"])
@pytest.mark.parametrize("chunk", [1, 7, 16])
def test_macro_bit_equal_to_reference(chunk, capacity):
    jrd, trd = _rds(capacity=capacity)
    # tight: one slot a pair and fast particles, so every step drops
    state = template_state(GRID, 64, vel=0.2 if capacity is None else 1.6)
    want_macro, jcap, jout = jresident.make_chunk_fn(jrd, DT, chunk,
                                                     *_j(state)[:3])
    macro, cap, out_cap = make_chunk_fn(trd, DT, chunk, *_t(state)[:3])
    assert (cap, out_cap) == (jcap, jout)
    want = jax.tree.map(np.asarray, want_macro(*_j(state)))
    got = macro(*_t(state))
    assert_tree_bits(got[0], tuple(want[0]), "state")
    assert_tree_bits(got[1], want[1])
    dropped = int(got[1]["stats"].dropped_send.sum())
    assert (dropped > 0) == (capacity is not None), dropped
    assert got[1]["count"].shape == (chunk, 16)
    last = final_stats(got[1]["stats"])
    assert torch.equal(last.send_counts, got[1]["stats"].send_counts[-1])
    assert last.fallback is None


def test_chunk_equals_the_eager_loop():
    """16 steps as one chunk, or as 16 eager ``service_drift`` +
    ``redistribute`` steps (the overflow policy does not fire: nothing
    drops): the same state bits."""
    _, trd = _rds()
    pos, vel, ids, count = _t(template_state(GRID, 64))
    macro, _, _ = make_chunk_fn(trd, DT, 16, pos, vel, ids)
    (cp, cv, ci, cc), _ = macro(pos, vel, ids, count)
    for _ in range(16):
        pos = nbody.service_drift(pos, vel, DT)
        res = trd.redistribute(pos, vel, ids, count=count)
        pos, (vel, ids), count = res.positions, res.fields, res.count
    trd.flush_overflow_checks()
    for a, b in ((cp, pos), (cv, vel), (ci, ids), (cc, count)):
        assert a.numpy().tobytes() == b.numpy().tobytes()


def test_service_drift_matches_reference():
    """``(p + v*dt) % 1`` and the fold at 1.0, bit-equal to the
    reference's jitted ``service_drift`` at power-of-two dt, including
    -0.0, a tiny negative (rounds to 1.0, folds to 0) and values just
    below 1."""
    rng = np.random.default_rng(3)
    p = rng.uniform(-0.2, 1.2, 4096).astype(np.float32)
    p[:4] = [-0.0, -1e-30, np.float32(0.99999994), 1.0]
    v = rng.uniform(-1, 1, 4096).astype(np.float32)
    v[:4] = [0.0, 0.0, 0.0, 0.0]
    for dt in (1.0, 0.0625, 0.03125):
        want = np.asarray(jax.jit(lambda a, b: jnbody.service_drift(
            a, b, dt))(jnp.asarray(p), jnp.asarray(v)))
        got = nbody.service_drift(torch.from_numpy(p), torch.from_numpy(v),
                                  dt).numpy()
        assert got.tobytes() == want.tobytes(), dt
        assert (got >= 0).all() and (got < 1).all()


def test_ragged_carry_raises():
    _, trd = _rds(out_capacity=128)
    pos, vel, ids, _ = _t(template_state(GRID, 64))
    with pytest.raises(ResidentLayoutError, match="out_capacity 128"):
        make_chunk_fn(trd, DT, 4, pos, vel, ids)


def test_arguments_are_validated():
    _, trd = _rds()
    pos, vel, ids, _ = _t(template_state(GRID, 16))
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        make_chunk_fn(trd, DT, 0, pos, vel, ids)
    with pytest.raises(ValueError):
        make_chunk_fn(trd, DT, 2, pos, vel, ids, unroll="many")
    # unroll selects nothing: any valid value gives the same macro output
    outs = [make_chunk_fn(trd, DT, 3, pos, vel, ids, unroll=u)[0](
        *_t(template_state(GRID, 16))) for u in (1, 8, 100)]
    for o in outs[1:]:
        assert_tree_bits(o, outs[0], "macro")


_HOST_READS = ("item", "cpu", "numpy", "tolist", "__bool__", "__int__",
               "__float__", "__index__")


def test_macro_reads_nothing_back(monkeypatch):
    """With every host read of a tensor made to raise, the sequential
    and the pipelined macro (probes armed too) still run: nothing in a
    chunk waits for the device."""
    from mpi_grid_redistribute_tpu_torch.service import (
        make_pipelined_chunk_fn,
    )
    from mpi_grid_redistribute_tpu_torch.telemetry import ProbeConfig

    _, trd = _rds()
    state = _t(template_state(GRID, 64))
    macros = [
        build(trd, DT, 4, *state[:3], probes=probes)[0]
        for build in (make_chunk_fn, make_pipelined_chunk_fn)
        for probes in (None, ProbeConfig("moments"))
    ]

    def refuse(*args, **kwargs):
        raise AssertionError("a host read inside the chunk")

    for name in _HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, refuse)
    outs = [m(*state) for m in macros]
    monkeypatch.undo()
    assert len(outs) == 4
    with pytest.raises(AssertionError, match="host read"):
        monkeypatch.setattr(torch.Tensor, "item", refuse)
        torch.zeros(()).item()


def test_stack_ys_keeps_none_leaves():
    from mpi_grid_redistribute_tpu_torch.parallel.exchange import (
        RedistributeStats,
    )

    steps = [{"stats": RedistributeStats(*(torch.full((2,), i)
                                             for _ in range(5))),
              "count": torch.tensor([i, i])} for i in range(3)]
    ys = resident.stack_ys(steps)
    assert ys["count"].shape == (3, 2)
    assert ys["stats"].pipeline is None and ys["stats"].fallback is None
    assert ys["stats"].send_counts[:, 0].tolist() == [0, 1, 2]
