"""The canonical drift loop (``models.nbody.make_drift_step`` /
``make_drift_loop``: drift, periodic wrap, the row-major canonical
exchange with the velocities riding along, and the CIC deposit) and the
standalone deposits (``build_deposit_step``, ``build_deposit_masked``),
held against the JAX package.

Across ranks (one world of 8 gloo processes on the CPU,
``torch_rank_cases.run_drift``) rank ``r``'s state is the reference's
shard ``r`` on its 8-virtual-device mesh, byte for byte, and the stats
(stacked per step, gathered) are its global stats. The ``"scan"``
density (kernel 5 on the card) is byte-equal to the reference's shard of
it. The reference's drift step takes ``"scan"`` and ``"segment"`` only;
the port's ``"mxu"`` density (kernel 4 on the card) is held within the
``rtol = atol = 2e-5`` already stated for kernel 4 of the reference's
``"scan"`` density of the same (byte-equal) state. dt is a power of two:
the reference's jitted drift may fuse ``p + v*dt`` on the CPU.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_rank_cases as cases
from mpi_grid_redistribute_tpu.domain import Domain as JDomain
from mpi_grid_redistribute_tpu.domain import ProcessGrid as JGrid
from mpi_grid_redistribute_tpu.models import nbody as jnbody
from mpi_grid_redistribute_tpu.ops import deposit as jdep
from mpi_grid_redistribute_tpu.parallel import mesh as jmesh
from mpi_grid_redistribute_tpu_torch.convert import split_grid, split_rows
from mpi_grid_redistribute_tpu_torch.domain import Domain as TDomain
from mpi_grid_redistribute_tpu_torch.domain import ProcessGrid as TGrid
from mpi_grid_redistribute_tpu_torch.models import nbody as tnbody
from mpi_grid_redistribute_tpu_torch.ops import deposit as tdep

W = 8
STATS = ("send_counts", "recv_counts", "dropped_send", "dropped_recv",
         "needed_capacity")
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return cases.shared_world(tmp_path_factory, "drift",
                              "torch_rank_cases:run_drift", W)


def _jcfg(name, method=None):
    shape, periodic, n, _, cap, dt, _, dep, _ = cases.DRIFT_CASES[name]
    kw = {}
    if dep is not None:
        # the reference's drift step has no "mxu": its scan density is
        # what the port's mxu one is held against
        kw = dict(deposit_method=method or dep[0], deposit_shape=dep[1])
    return jnbody.DriftConfig(
        domain=JDomain(0.0, 1.0, periodic=periodic), grid=JGrid(shape),
        dt=dt, capacity=cap, n_local=n, **kw)


def _reference(name):
    shape, _, _, _, _, _, steps, dep, each = cases.DRIFT_CASES[name]
    cfg = _jcfg(name, None if dep is None or dep[0] != "mxu" else "scan")
    mesh = jmesh.make_mesh(cfg.grid, jax.devices()[:cfg.grid.nranks])
    pos, vel, count = cases.drift_inputs(name)
    if steps == 1:
        out = jnbody.make_drift_step(cfg, mesh)(pos, vel, count)
    else:
        out = jnbody.make_drift_loop(cfg, mesh, steps,
                                     deposit_each_step=each)(pos, vel, count)
    return cfg, jax.tree.map(np.asarray, out)


def _density_shards(rho, cfg):
    if all(cfg.domain.periodic):
        return split_grid(rho, cfg.grid.shape)
    return [rho] * cfg.grid.nranks


@pytest.mark.parametrize("name", list(cases.DRIFT_CASES))
def test_drift_matches_reference(world, name):
    """State (positions, velocities, counts) and the per-step stats are
    the reference's shards, byte for byte; the density is the
    reference's shard (``"scan"``: byte-equal; ``"mxu"``: within
    2e-5), the same with ``plain=True``."""
    cfg, want = _reference(name)
    R = cfg.grid.nranks
    steps = cases.DRIFT_CASES[name][6]
    w_state = [split_rows(a, R) for a in want[:3]]
    rho_w = None if len(want) < 5 else _density_shards(want[4], cfg)
    method = (cases.DRIFT_CASES[name][7] or (None,))[0]
    for r in range(R):
        state, stats, rho = world[r][name]
        for g, w in zip(state, w_state):
            assert g.tobytes() == w[r].tobytes(), r
        for f in STATS:
            np.testing.assert_array_equal(stats[f], getattr(want[3], f),
                                          err_msg=f)
        assert "fallback" not in stats  # five leaves, as the reference's
        if rho_w is None:
            continue
        plain = world[r][(name, "plain")]
        if method == "scan":
            assert rho.tobytes() == rho_w[r].tobytes(), r
            assert plain.tobytes() == rho.tobytes()
        else:
            np.testing.assert_allclose(rho, rho_w[r], **TOL)
            np.testing.assert_allclose(plain, rho, **TOL)
    if steps > 1:
        assert want[3].send_counts.shape[0] == steps  # stacked per step
    if rho_w is not None:
        # the density's mass is the live count after the last step
        total = sum(world[r][name][2].sum() for r in range(R)) if all(
            cfg.domain.periodic) else world[0][name][2].sum()
        np.testing.assert_allclose(total, want[2].sum(), rtol=1e-5)


def test_standalone_deposits_match_reference(world):
    """``build_deposit_step`` (count prefix) and ``build_deposit_masked``
    (a mask) on random masses: each rank's shard of the reference's
    density, byte for byte."""
    cfg = _jcfg("scan-final")
    mesh = jmesh.make_mesh(cfg.grid, jax.devices()[:W])
    pos, _, count = cases.drift_inputs("scan-final")
    mass = np.random.default_rng(77).random(W * 200).astype(np.float32)
    want = np.asarray(jnbody.build_deposit_step(cfg, mesh)(pos, mass, count))
    masked = np.asarray(jnbody.build_deposit_masked(cfg, mesh)(
        pos, mass, mass > 0.3))
    for r, (a, b) in enumerate(zip(split_grid(want, (2, 2, 2)),
                                   split_grid(masked, (2, 2, 2)))):
        assert world[r]["deposit_step"].tobytes() == a.tobytes(), r
        assert world[r]["deposit_masked"].tobytes() == b.tobytes(), r


def _one_rank(method, each, steps, dt=0.0625):
    n = 300
    rng = np.random.default_rng(3)
    pos = rng.random((n, 3), dtype=np.float32)
    vel = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    count = np.array([250], np.int32)
    kw = dict(dt=dt, capacity=n, n_local=n, deposit_shape=(8, 8, 8))
    jcfg = jnbody.DriftConfig(domain=JDomain(0.0, 1.0, periodic=True),
                              grid=JGrid((1, 1, 1)), deposit_method=(
                                  "scan" if method == "mxu" else method),
                              **kw)
    tcfg = tnbody.DriftConfig(domain=TDomain(0.0, 1.0, periodic=True),
                              grid=TGrid((1, 1, 1)), deposit_method=method,
                              **kw)
    mesh = jmesh.make_mesh(jcfg.grid, jax.devices()[:1])
    want = jax.tree.map(np.asarray, jnbody.make_drift_loop(
        jcfg, mesh, steps, deposit_each_step=each)(pos, vel, count))
    got = tnbody.make_drift_loop(tcfg, steps, deposit_each_step=each,
                                 device="cpu")(pos, vel, 250)
    return (pos, vel, count), tcfg, want, got


@pytest.mark.parametrize("method", ["scan", "mxu", "segment"])
@pytest.mark.parametrize("each", [True, False])
def test_one_rank_grid_runs_without_a_process_group(method, each):
    """``mesh=None`` on a one-rank grid: one process, no
    ``torch.distributed``; byte-equal to the reference on one device
    (mxu density within 2e-5), and the loop equals its steps one by
    one."""
    inputs, tcfg, want, got = _one_rank(method, each, 3)
    for g, w in zip(got[:3], want[:3]):
        assert g.numpy().tobytes() == w.tobytes()
    for f in STATS:
        np.testing.assert_array_equal(getattr(got[3], f).numpy(),
                                      getattr(want[3], f), err_msg=f)
    if method != "mxu":
        assert got[4].numpy().tobytes() == want[4].tobytes()
    else:
        np.testing.assert_allclose(got[4].numpy(), want[4], **TOL)
    if each:
        step = tnbody.make_drift_step(tcfg, device="cpu")
        p, v, c = inputs
        for _ in range(3):
            p, v, c, _, rho = step(p, v, c)
        assert p.numpy().tobytes() == got[0].numpy().tobytes()
        assert rho.numpy().tobytes() == got[4].numpy().tobytes()


def test_zero_steps_and_validation():
    """Zero steps return the input state, stats of ``[0, ...]`` and a zero
    density shard; a deposit each step needs ``deposit_shape``; a grid of
    several ranks without a process group raises."""
    tcfg = tnbody.DriftConfig(domain=TDomain(0.0, 1.0, periodic=True),
                              grid=TGrid((1, 1, 1)), dt=0.25, capacity=8,
                              n_local=8, deposit_shape=(4, 4, 4))
    pos = np.random.default_rng(0).random((8, 3), dtype=np.float32)
    out = tnbody.make_drift_loop(tcfg, 0, deposit_each_step=True,
                                 device="cpu")(pos, pos, 5)
    assert out[0].numpy().tobytes() == pos.tobytes()
    assert out[2].tolist() == [5]
    assert out[3].send_counts.shape == (0, 1, 1)
    assert out[4].shape == (4, 4, 4) and not out[4].any()
    with pytest.raises(ValueError, match="deposit_shape"):
        tnbody.make_drift_loop(dataclasses.replace(tcfg, deposit_shape=None),
                               2, deposit_each_step=True, device="cpu")
    with pytest.raises(ValueError, match="torch.distributed"):
        tnbody.make_drift_loop(dataclasses.replace(
            tcfg, grid=TGrid((2, 1, 1))), 2, device="cpu")
    with pytest.raises(ValueError, match="deposit_shape"):
        tnbody.build_deposit_step(dataclasses.replace(
            tcfg, deposit_shape=None))


def test_deposit_out_spec_matches_reference():
    """The density's shard rule: split over the grid axes on a fully
    periodic domain, replicated otherwise (the reference's out_spec)."""
    for periodic in (True, False, (True, False, True)):
        want = jdep.deposit_out_spec(JDomain(0.0, 1.0, periodic=periodic),
                                     JGrid((2, 2, 2)))
        got = tdep.deposit_out_spec(TDomain(0.0, 1.0, periodic=periodic),
                                    TGrid((2, 2, 2)))
        assert got == tuple(want)


def test_ranks_import_no_jax(world):
    for r in range(W):
        assert world[r][("imports",)] == []
