"""The clustered deployment (log-normal ``rows`` that turn around at
phases of their own, ``cells`` assigned to the slabs by LPT): its draw, its
frozen copy of the program's LPT, the reference's ownership and turns, the
faults it can have, and the rows of the other configurations left as they
were."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from benchmark import program, reference, spec, state
from benchmark.tests.test_benchmark_cell import (DEVICES, _device, measure,
                                                 tiny_cell)

LGN = ("lognormal_4x4x4", "m2_s4")


def test_draw_is_deterministic_by_seed():
    cell = tiny_cell(*LGN, slots=2048)
    a = state.draw(cell, 2**40 + 3, 0, "cpu")
    b = state.draw(cell, 2**40 + 3, 0, "cpu")
    c = state.draw(cell, 2**40 + 4, 0, "cpu")
    assert a[0] == b[0]
    assert all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))
    assert not torch.equal(a[1], c[1])
    done, pos, vel, alive = a
    assert done.assignment is not None and cell.assignment is None
    assert int(alive.sum()) == cell.live_total == 8192
    assert float(vel.abs().max()) <= max(cell.vel_scale)
    assert cell.vel_scale == pytest.approx((0.02 / 3 * 2 / 4,) * 3)
    # every row on the slab its cell is assigned to, at its slab's head
    cols = alive.nonzero().squeeze(1)
    slab = cols // cell.n_local
    assert torch.equal(reference.owner_slab(done, pos[:, cols]), slab)
    k = torch.bincount(slab, minlength=cell.V)
    for v in range(cell.V):
        head = alive[v * cell.n_local:(v + 1) * cell.n_local]
        kv = int(k[v])
        assert bool(head[:kv].all()) and not bool(head[kv:].any())
    # sized from the hottest slab as the port's script sizes it
    hot = int(k.max())
    assert (done.capacity, done.budget) == spec.hot_slab_sizing(hot, 0.02)
    assert done.budget == max(256, int(np.ceil(hot * 0.02 * 2.0)))


def test_clustered_rows_are_clustered():
    cell = tiny_cell(*LGN, slots=2**14)
    done, pos, _, alive = state.draw(cell, 7, 0, "cpu")
    hist = torch.bincount(reference.cell_index(done.cells, pos[:, alive]),
                          minlength=64)
    share = hist.double() / hist.sum()
    # cell (0,0,0) holds ~0.483^3 of the rows, the lightest ~0.111^3
    assert float(share[0]) == pytest.approx(0.1125, abs=0.01)
    assert float(share.min()) < 0.004
    bins = torch.bincount(torch.as_tensor(done.assignment),
                          weights=hist.double(), minlength=cell.V)
    assert float(bins.max() / bins.mean()) < 1.05


@pytest.mark.parametrize("loads", [
    [5, 1, 9, 9, 0, 3, 7, 7, 2, 2, 8, 1],
    [4] * 16,
    list(range(64, 0, -1)),
    [0] * 8 + [1],
    "lognormal"])
@pytest.mark.parametrize("n_ranks", [3, 8])
def test_frozen_lpt_equals_the_program(loads, n_ranks):
    from mpi_grid_redistribute_tpu_torch.parallel import migrate

    if loads == "lognormal":
        loads = np.random.default_rng(3).lognormal(10, 2, size=64).astype(
            np.int64)
    assert spec.lpt_assignment(loads, n_ranks) == migrate.balanced_assignment(
        loads, n_ranks)


def test_frozen_lpt_refuses_too_few_cells():
    with pytest.raises(ValueError):
        spec.lpt_assignment([1, 2], 3)


def test_reference_ownership_follows_the_assignment():
    cell = tiny_cell(*LGN, slots=64)
    assign = tuple((7 * c + 3) % cell.V for c in range(64))
    done = dataclasses.replace(cell, assignment=assign)
    # one position in each of the 64 cells, and the edges of cell (3,3,3)
    centre = (np.arange(4) + 0.5) / 4
    grid = np.stack(np.meshgrid(centre, centre, centre, indexing="ij"))
    pos = torch.tensor(grid.reshape(3, 64), dtype=torch.float32)
    got = reference.owner_slab(done, pos)
    assert got.tolist() == list(assign)
    edge = torch.tensor([[0.75, 0.99999994], [0.75, 0.99999994],
                         [0.75, 0.99999994]], dtype=torch.float32)
    assert reference.owner_slab(done, edge).tolist() == [assign[63]] * 2
    # not the canonical grid's owner
    canon = reference.owner_slab(tiny_cell("uniform_2x2x2", "m2_s4",
                                           slots=64), pos)
    assert not torch.equal(got, canon)
    with pytest.raises(ValueError):
        cell.slab_of_cell_table()  # no assignment before the draw


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_turning_drift_exact_for_signs_and_zeros():
    """The program's drift and wrap (``ops/driftbin.drift_wrap``, the plain
    ops the loop runs under an assignment) on velocities turned by
    ``state.turn`` against the reference's drift and its own turns, a call
    of one step, each row turning every 1 to 16 calls: bit for bit, zeros'
    signs included, velocities too."""
    from mpi_grid_redistribute_tpu_torch.domain import Domain
    from mpi_grid_redistribute_tpu_torch.ops import driftbin

    f = np.float32
    ps = [0.0, -0.0, 1e-45, 1e-9, 0.00333, 0.25, 0.5, 0.75, f(0.99999994),
          f(1) - f(0.00333)]
    vs = [0.0, -0.0, 1e-9, -1e-9, 0.00333, -0.00333, f(0.99999994),
          -f(0.99999994)]
    p0 = np.array([p for p in ps for _ in vs], np.float32)
    v0 = np.array([v for _ in ps for v in vs], np.float32)
    v0 = np.concatenate([v0, p0])  # v = p: the backward step lands on 0
    p0 = np.concatenate([p0, p0])
    rng = np.random.default_rng(5)
    p0 = np.concatenate([p0, rng.random(4096, np.float32)])
    v0 = np.concatenate([v0, (rng.random(4096, np.float32) * 2 - 1) * f(0.01)])
    pos = torch.from_numpy(np.stack([p0, p0[::-1].copy(), p0])).contiguous()
    vel = torch.from_numpy(np.stack([v0, v0, -v0])).contiguous()
    n = pos.shape[1]
    alive = torch.ones(n, dtype=torch.bool)
    ref = reference.Drift(pos, vel, alive, 1.0, turn_calls=1)
    period, phase = reference.turn_schedule(vel[0], 1)
    due = ((phase[None] + torch.arange(6)[:, None]) % period == 0).any(0)
    assert 0 < int(due.sum()) < n  # rows that turn and rows that do not
    flat = torch.cat([pos.view(torch.int32), vel.view(torch.int32),
                      alive.to(torch.int32)[None]])
    dom = Domain(0.0, 1.0, periodic=True)
    for call in range(6):
        state.turn(flat[3:6].view(torch.float32), call, 1)
        driftbin.drift_wrap(flat, 1.0, dom)
        ref.advance(1)
        assert torch.equal(flat[:3], _bits(ref.pos)), call
        assert torch.equal(flat[3:6], _bits(ref.vel)), call
    zeros = ref.pos == 0
    assert bool(zeros.any())
    assert not bool((_bits(ref.pos)[zeros] != 0).any())  # all +0.0
    assert float(ref.pos.max()) < 1.0 and float(ref.pos.min()) >= 0.0


def _keyed_velocities(n_keys=4096):
    """``[3, n_keys]`` velocities near 1e-3 whose low 12 bits are every
    key once."""
    vx = torch.full((n_keys,), 1e-3).view(torch.int32)
    vx = (vx & ~4095) | torch.arange(n_keys, dtype=torch.int32)
    return vx.view(torch.float32).expand(3, n_keys).clone()


def test_reference_turns_each_row_on_its_schedule():
    """A row of period ``P`` and phase ``k`` turns before the calls ``c``
    with ``(c + k) % P == 0``: it swings within ``P`` calls' travel of its
    start, where a constant drift carries it away; its velocity's bits but
    the sign stay as drawn."""
    P0, S = 2, 2
    vel = _keyed_velocities(256)
    n = vel.shape[1]
    period, phase = reference.turn_schedule(vel[0], P0)
    key = torch.arange(n)
    assert torch.equal(period, P0 + key % 16)
    assert torch.equal(phase, (key // 16) % period)
    pos = torch.full((3, n), 0.5)
    alive = torch.ones(n, dtype=torch.bool)
    turning = reference.Drift(pos, vel, alive, 1.0, turn_calls=P0,
                              steps_per_call=S)
    const = reference.Drift(pos, vel, alive, 1.0)
    travel = float(vel[0].abs().max()) * S  # one call's travel, at most
    turns = torch.zeros(n, dtype=torch.int64)
    for call in range(4 * (P0 + 15)):
        turns += ((phase + call) % period == 0).long()
        turning.advance(S)
        const.advance(S)
        sign = 1.0 - 2.0 * (turns % 2).float()
        assert torch.equal(turning.vel[0].sign(), sign), call
        d = (turning.pos - 0.5)[0].abs() / travel
        assert bool((d <= period + 0.01).all()), call
    assert bool((turns >= 3).all())
    assert float((const.pos - 0.5).abs().min()) > 0.9 * 4 * 17 * travel
    assert torch.equal(turning.vel.abs(), vel.abs())


def test_turn_table_is_the_reference_schedule():
    """``state.turn`` (the table the program's rows are turned by) turns
    the same rows as the reference's own schedule, over all 4,096 keys and
    three of the longest periods, zeros included."""
    P0 = 16
    vel = _keyed_velocities()
    vel[:, :2] = torch.tensor([0.0, -0.0])  # keys 0 and 0: zeros
    ref = reference.Drift(torch.full_like(vel, 0.5), vel,
                          torch.ones(vel.shape[1], dtype=torch.bool), 1.0,
                          turn_calls=P0)
    flat = vel.clone().reshape(-1)
    for call in range(3 * (P0 + 15)):
        state.turn(flat, call, P0)
        ref.advance(1)
        assert torch.equal(_bits(flat.view(3, -1)), _bits(ref.vel)), call


def test_slab_overflow_at_the_draw_raises():
    cell = tiny_cell(*LGN, slots=1024, particles=8 * 1024)
    with pytest.raises(ValueError, match="rows on a slab"):
        state.draw(cell, 11, 0, "cpu")


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("seed", [3, 2**31 + 99, 4_000_000_017])
def test_drift_bf16_control_fails_clustered(device, seed):
    line = measure(tiny_cell(*LGN), seed, _device(device),
                   control="drift_bf16")
    assert not line["correct"]
    assert line["checks"]["slabs_differing"]["value"] > 0


def _build_as(monkeypatch, **change):
    """The program built from the cell with ``change`` applied: what it
    would run with that part of the configuration dropped."""
    real = program.build

    def build(cell, device, mesh=None):
        return real(dataclasses.replace(cell, **change), device, mesh)

    monkeypatch.setattr(program, "build", build)


def test_clustered_fault_binning_by_the_canonical_grid(monkeypatch):
    _build_as(monkeypatch, cells=None, assignment=None)
    line = measure(tiny_cell(*LGN), 2**31 + 5)
    assert not line["correct"], line["checks"]


def test_clustered_fault_rows_never_turn(monkeypatch):
    """The program's rows never turned (the reference's still do)."""
    monkeypatch.setattr(state, "turn", lambda vel, call, turn_calls: None)
    line = measure(tiny_cell(*LGN), 2**31 + 5)
    assert not line["correct"], line["checks"]


def test_traced_clustered_run_reads_with_its_suffix():
    line = measure(tiny_cell(*LGN), 13, traced=1)
    assert line["correct"]
    assert line["metrics"]["host_ms.step.lgn"]["value"] > 0
    assert all(n.endswith(".lgn") for n in line["metrics"])
    assert "driftbin_roofline.lgn" not in line["metrics"]  # kernel 1 is off
    assert line["metrics"]["fast_share.lgn"]["value"] == 100.0


# sha256 of (pos, vel, alive) of a tiny card at seed 2**33 + 12345, drawn
# by the harness before the clustered rows were added
PARENT_DIGESTS = {
    ("uniform_2x2x2", "m2_s4", 0):
        "866370af6262f7c1d9f65cabb4e7332fe11ea118f30e989431c43b03c31a3cb4",
    ("uniform_2x2x2_cic128", "m2_s1", 0):
        "866370af6262f7c1d9f65cabb4e7332fe11ea118f30e989431c43b03c31a3cb4",
    ("slab_8x8", "m2_s4", 0):
        "e2d453a517c284aac2c51386d6c38e7871f8463e01efc736b1282471a6b1da54",
    ("uniform_2x2x2_4card", "m2_s4", 3):
        "3b9473648745c87046d61227b7beefc0214b26215d0a81e2d4974d571d95408a",
}


@pytest.mark.parametrize("key", sorted(PARENT_DIGESTS))
def test_uniform_rows_unchanged(key):
    config, traffic, rank = key
    cell = tiny_cell(config, traffic, slots=512)
    done, *rows = state.draw(cell, 2**33 + 12345, rank, "cpu")
    assert done is cell
    h = hashlib.sha256()
    for t in rows:
        h.update(t.contiguous().numpy().tobytes())
    assert h.hexdigest() == PARENT_DIGESTS[key]
