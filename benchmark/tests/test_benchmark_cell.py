"""A tiny cell end to end: the program's plain path agrees with the
reference, the bfloat16 control does not, and the frozen copies in the
benchmark agree with the program's originals."""

import json
import types

import numpy as np
import pytest
import torch

from benchmark import costs, reference, run, spec, state, worker

ROOT = spec.ROOT


def tiny_cell(config="uniform_2x2x2_cic128", traffic="m2_s4", slots=4096,
              mesh=(16, 16, 16), particles=None):
    """A configuration at a tiny size; clustered rows fill half the slots
    unless ``particles`` says otherwise."""
    cfg = json.loads((ROOT / "configs" / f"{config}.json").read_text())
    cfg["slots_per_vrank"] = slots
    if cfg.get("deposit"):
        cfg["deposit"]["shape"] = list(mesh)
    if cfg.get("rows"):
        n_slots = slots * np.prod(cfg["grid"])
        cfg["rows"]["particles"] = particles or int(n_slots // 2)
    tr = json.loads((ROOT / "traffic" / f"{traffic}.json").read_text())
    return spec.make_cell(f"{config}.{traffic}", cfg, tr)


def measure(cell, seed, device="cpu", traced=0, control=False, seconds=0.3):
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=traced,
                                 control=control)
    res = run.run_local(args, cell, torch.device(device))
    return run.assemble(cell, bool(traced), res, run.T0)


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return name


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("config,traffic", [
    ("uniform_2x2x2", "m2_s4"), ("uniform_2x2x2_cic128", "m2_s1"),
    ("uniform_2x2x2", "m2_s1"), ("lognormal_4x4x4", "m2_s4")])
def test_program_agrees_with_reference(device, config, traffic):
    cell = tiny_cell(config, traffic)
    line = measure(cell, 2**31 + 7, _device(device))
    assert line["correct"], line["checks"]
    assert line["checks"]["count_gap"]["value"] == 0
    assert line["checks"]["slabs_differing"]["value"] == 0
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    sfx = cell.metric_suffix
    assert set(line["metrics"]) == {"particles_per_s" + sfx,
                                    "call_ms_p95" + sfx, "peak_mem_gib",
                                    "setup_s"}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("seed", [3, 2**31 + 99, 4_000_000_017])
def test_drift_bf16_control_fails(device, seed):
    cell = tiny_cell("uniform_2x2x2_cic128", "m2_s1")
    line = measure(cell, seed, _device(device), control="drift_bf16")
    assert not line["correct"]
    assert line["checks"]["slabs_differing"]["value"] > 0
    assert line["failed"] == line["attempted"]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("seed", [3, 2**31 + 99, 4_000_000_017])
def test_deposit_f32_control_fails(device, seed):
    """The density summed in float32 from exact positions: the rows agree,
    the density does not (as many particles a node as the cell has)."""
    cell = tiny_cell("uniform_2x2x2_cic128", "m2_s1", slots=2**15,
                     mesh=(10, 10, 10))
    line = measure(cell, seed, _device(device), control="deposit_f32")
    c = line["checks"]
    assert not line["correct"]
    assert c["slabs_differing"]["value"] == 0
    assert c["rho_gap"]["value"] > c["rho_gap"]["limit"]


def test_traced_run_reads_host_spans():
    line = measure(tiny_cell("uniform_2x2x2", "m2_s4"), 11, traced=1)
    assert line["correct"]
    assert line["metrics"]["host_ms.step"]["value"] > 0
    assert {"busy_s", "window_s"} <= set(line["device"])
    # on the CPU nothing runs on a device: no idle share to read
    assert "idle_share" not in line["metrics"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_state_from_seed():
    cell = tiny_cell("uniform_2x2x2_4card", "m2_s4", slots=1024)
    a = state.card_state(cell, 2**40 + 3, 2, "cpu")
    b = state.card_state(cell, 2**40 + 3, 2, "cpu")
    c = state.card_state(cell, 2**40 + 4, 2, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    pos, vel, alive = a
    slab = 2 * cell.V + torch.arange(pos.shape[1]) // cell.n_local
    assert torch.equal(reference.owner_slab(cell, pos), slab)
    assert int(alive.sum()) == cell.V * cell.live_per_slab
    assert float(vel.abs().max()) <= max(cell.vel_scale)


def test_reference_drift_and_wrap():
    pos = torch.tensor([[0.25, 0.999, 0.0, 1e-9]], dtype=torch.float32)
    vel = torch.tensor([[0.5, 0.002, -1e-9, -2e-9]], dtype=torch.float32)
    d = reference.Drift(pos.expand(3, 4).clone(), vel.expand(3, 4).clone(),
                        torch.ones(4, dtype=torch.bool), 1.0)
    d.advance(1)
    want = torch.tensor([0.75, 0.001, 0.0, 0.0], dtype=torch.float32)
    want[1] = (torch.tensor(0.999) + torch.tensor(0.002)) - 1.0
    want[3] = (torch.tensor(1e-9) + torch.tensor(-2e-9)) + 1.0
    want[3] = 0.0 if want[3] >= 1.0 else want[3]
    assert torch.equal(d.pos[0], want)
    assert float(d.pos.max()) < 1.0 and float(d.pos.min()) >= 0.0


def test_cic_density_conserves_mass_and_splits():
    pos = torch.tensor([[0.5 / 16, 15.5 / 16], [0.0, 0.25], [0.0, 0.0]],
                       dtype=torch.float32)
    rho = reference.cic_density(pos, (16, 16, 16))
    assert float(rho.sum()) == pytest.approx(2.0)
    assert float(rho[0, 0, 0]) == pytest.approx(0.5)
    assert float(rho[1, 0, 0]) == pytest.approx(0.5)
    # the second particle wraps: half on node 15, half on node 0
    assert float(rho[15, 4, 0]) == pytest.approx(0.5)
    assert float(rho[0, 4, 0]) == pytest.approx(0.5)


def test_frozen_copies_match_the_program():
    from mpi_grid_redistribute_tpu_torch.bench import common
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.ops import dfscan, driftbin, overlay

    for g, n, f, m in [((2, 2, 2), 2**23, 0.9, 0.02), ((4, 4, 1), 1000,
                                                       0.5, 0.2)]:
        a = spec.drift_sizing(g, n, f, m)
        b = common.drift_sizing(g, n, f, m)
        assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]
    flat = torch.zeros((7, 64), dtype=torch.int32)
    dom = Domain(0.0, 1.0, periodic=True)
    assert costs.driftbin_cost(64) == driftbin.kernel_cost(
        flat, 1.0, dom, ProcessGrid((2, 2, 2)), 8, 8)
    targets = torch.tensor([0, 5, 63, 64, -1, 9], dtype=torch.int32)
    assert costs.overlay_cost(6, 4) == overlay.kernel_cost(flat, targets,
                                                           None)
    x = torch.zeros((10, 256))
    assert costs.dfscan_cost(10, 256) == dfscan.kernel_cost(x)


def test_generator_matches_the_program_placement():
    """The frozen generator draws on the device, but places rows as the
    program's ``bench/common.uniform_state`` does: the same cell a slab."""
    from mpi_grid_redistribute_tpu_torch.bench import common

    cell = tiny_cell("uniform_2x2x2", "m2_s4", slots=512)
    pos, _, alive = state.card_state(cell, 1, 0, "cpu")
    npos, _, nalive = common.uniform_state(
        cell.grid, cell.n_local, cell.fill, np.random.default_rng(0))
    npos = torch.from_numpy(np.ascontiguousarray(npos.T))
    assert torch.equal(reference.owner_slab(cell, pos),
                       reference.owner_slab(cell, npos))
    assert torch.equal(alive, torch.from_numpy(nalive))


def test_judge_counts_slabs_and_rows():
    cell = tiny_cell("uniform_2x2x2", "m2_s4", slots=256)
    pos, vel, alive = state.card_state(cell, 5, 0, "cpu")
    st = (pos.reshape(-1), vel.reshape(-1), alive, None)
    checks = worker.judge(cell, 5, 0, worker.Solo(), torch.device("cpu"),
                          worker.digest(cell, st, 0), {}, 0)
    assert all(c["value"] == 0 for c in checks.values())
    # one row moved to the next slab's first hole: one slab loses it,
    # another gains it, and it lies outside its owner
    st2 = (pos.clone(), vel.clone(), alive.clone(), None)
    hole = cell.n_local + cell.live_per_slab
    st2[0][:, hole] = pos[:, 0]
    st2[1][:, hole] = vel[:, 0]
    st2[2][hole], st2[2][0] = True, False
    st2 = (st2[0].reshape(-1), st2[1].reshape(-1), st2[2], None)
    checks = worker.judge(cell, 5, 0, worker.Solo(), torch.device("cpu"),
                          worker.digest(cell, st2, 0), {}, 0)
    assert checks["count_gap"]["value"] == 2
    assert checks["misplaced_rows"]["value"] == 1
    assert checks["slabs_differing"]["value"] == 2
