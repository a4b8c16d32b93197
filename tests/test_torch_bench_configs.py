"""Port bench configs 2 (clustered, load-balanced) and 3 (8x8 slabs), and
``utils/stats``, against the JAX package on the CPU at small sizes.

The configs' inputs are the reference's bits (the same draws from the
same seeds, the same binning, assignment and sizing); the config-2
steady state's first steps are BIT-equal to the reference's
``engine="planar"`` loop on the same inputs (its default engine does not
trace under an assignment on this jax, ROADMAP C1); each ``run()``
returns the reference's keys, less its telemetry report, with nothing
dropped. The stats summaries equal the reference's on the same stats."""

import json
import math

import numpy as np
import pytest

import jax
import torch

from mpi_grid_redistribute_tpu import domain as jdomain
from mpi_grid_redistribute_tpu.bench import common as jcommon
from mpi_grid_redistribute_tpu.models import nbody as jnbody
from mpi_grid_redistribute_tpu.ops import binning as jbinning
from mpi_grid_redistribute_tpu.parallel import exchange as jexchange
from mpi_grid_redistribute_tpu.parallel import mesh as mesh_lib
from mpi_grid_redistribute_tpu.parallel import migrate as jmig
from mpi_grid_redistribute_tpu.utils import stats as jstats
from mpi_grid_redistribute_tpu_torch import domain as tdomain
from mpi_grid_redistribute_tpu_torch.bench import common as tcommon
from mpi_grid_redistribute_tpu_torch.bench import config2_clustered as c2
from mpi_grid_redistribute_tpu_torch.bench import config3_slab as c3
from mpi_grid_redistribute_tpu_torch.models import nbody as tnbody
from mpi_grid_redistribute_tpu_torch.parallel import exchange as texchange
from mpi_grid_redistribute_tpu_torch.parallel import migrate as tmig
from mpi_grid_redistribute_tpu_torch.utils import stats as tstats

torch.set_num_threads(1)

# the keys of the reference's run() results (bench/config2_clustered.py,
# bench/config3_slab.py), less their telemetry reports
CONFIG2_KEYS = {
    "metric", "value", "unit", "pps_imbalanced", "pps_uniform_ref",
    "imbalanced_over_uniform", "ownership_imbalance", "slot_waste_factor",
    "balanced_bin_imbalance", "dropped_recv", "placement_dropped_recv",
    "placement_pps", "placement_rounds", "n_total", "chips",
}
CONFIG3_KEYS = {"metric", "value", "unit", "grid", "n_total", "chips",
                "ms_per_step"}


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x).view(np.uint8)


def _reference_steady(total):
    """The reference's config-2 steady-state set-up (its run() body up to
    ``measure``), NumPy only: rows, owners, assignments and sizing, then
    each workload's slab state, in its order of draws."""
    rng = np.random.default_rng(107)
    domain = jdomain.Domain(0.0, 1.0, periodic=True)
    full_grid = jdomain.ProcessGrid((4, 4, 4))
    cluster = (rng.lognormal(-1.0, 1.5, size=(total, 3)) % 1.0).astype(
        np.float32
    )
    cell_c = jbinning.rank_of_position(cluster, domain, full_grid, xp=np)
    counts = np.bincount(cell_c, minlength=64)
    assign_c = jmig.balanced_assignment(counts, 8)
    owner_c = np.asarray(assign_c)[cell_c]
    bins_c = np.bincount(owner_c, minlength=8)
    uniform = rng.random((total, 3), dtype=np.float32)
    cell_u = jbinning.rank_of_position(uniform, domain, full_grid, xp=np)
    assign_u = jmig.balanced_assignment(np.bincount(cell_u, minlength=64), 8)
    owner_u = np.asarray(assign_u)[cell_u]
    bins_u = np.bincount(owner_u, minlength=8)
    n_slab = -(-math.ceil(max(bins_c.max(), bins_u.max()) * 1.3)
               // 4096) * 4096
    hot = max(bins_c.max(), bins_u.max())
    v_scale = 0.02 / 3.0 * 2.0 / np.asarray((4, 4, 4), np.float32)
    out = {
        "imbalance": float(counts.max() / counts.mean()),
        "n_slab": n_slab,
        "capacity": max(64, math.ceil(hot * 0.02 * 2.0)),
        "budget": max(256, math.ceil(hot * 0.02 * 2.0)),
        "waste": 8 * n_slab / total,
        "bbi": float(bins_c.max() / bins_c.mean()),
    }
    for name, rows, owner, assign in (("imbalanced", cluster, owner_c,
                                       assign_c),
                                      ("uniform", uniform, owner_u,
                                       assign_u)):
        vel_np = (v_scale * (rng.random(rows.shape, dtype=np.float32) * 2
                             - 1)).astype(np.float32)
        pos_np = np.zeros((8 * n_slab, 3), np.float32)
        vel_p = np.zeros((8 * n_slab, 3), np.float32)
        alive = np.zeros((8 * n_slab,), bool)
        for v in range(8):
            m = owner == v
            k = int(m.sum())
            pos_np[v * n_slab : v * n_slab + k] = rows[m]
            vel_p[v * n_slab : v * n_slab + k] = vel_np[m]
            alive[v * n_slab : v * n_slab + k] = True
        out[name] = (owner, assign, jnbody.rows_to_planar(pos_np, 1),
                     jnbody.rows_to_planar(vel_p, 1), alive)
    return out


@pytest.mark.parametrize("n_local", [256, 1024])
def test_config2_steady_inputs_match_reference(n_local):
    total = c2.steady_total(n_local)
    want = _reference_steady(total)
    setup = c2.steady_setup(total, "cpu")
    assert setup["n_slab"] == want["n_slab"]
    assert (setup["capacity"], setup["budget"]) == (want["capacity"],
                                                    want["budget"])
    assert setup["imbalance"] == want["imbalance"]
    assert setup["waste"] == want["waste"]
    assert setup["balanced_bin_imbalance"] == want["bbi"]
    for name in c2.WORKLOADS:
        owner, assign, pos, vel, alive = want[name]
        _, t_assign, t_owner, _ = setup["layout"][name]
        assert t_assign == assign
        np.testing.assert_array_equal(t_owner.numpy(), owner)
        cfg, vgrid, (tp, tv, ta) = c2.steady_workload(setup, name)
        assert cfg.assignment == assign and cfg.cells.shape == (4, 4, 4)
        assert vgrid.shape == (2, 2, 2) and cfg.n_local == want["n_slab"]
        for g, w in ((tp, pos), (tv, vel), (ta, alive)):
            np.testing.assert_array_equal(_bits(g), _bits(w))


def test_config2_steady_state_bit_equal_to_reference_loop():
    """The imbalanced workload's first steps through both packages' loops
    (the port's default engine and the reference's planar one)."""
    total = c2.steady_total(256)
    setup = c2.steady_setup(total, "cpu")
    cfg, vgrid, state = c2.steady_workload(setup, "imbalanced")
    got = tnbody.make_migrate_loop(cfg, 4, vgrid=vgrid, device="cpu")(*state)
    dev_grid = jdomain.ProcessGrid((1, 1, 1))
    jcfg = jnbody.DriftConfig(
        domain=jdomain.Domain(0.0, 1.0, periodic=True), grid=dev_grid,
        dt=1.0, capacity=cfg.capacity, n_local=cfg.n_local,
        local_budget=cfg.local_budget, cells=jdomain.ProcessGrid((4, 4, 4)),
        assignment=cfg.assignment, engine="planar",
    )
    want = jax.tree.map(np.asarray, jnbody.make_migrate_loop(
        jcfg, mesh_lib.make_mesh(dev_grid, devices=jax.devices()[:1]), 4,
        vgrid=jdomain.ProcessGrid((2, 2, 2)),
    )(*(x.numpy() for x in state)))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    for f in ("sent", "received", "population", "backlog", "dropped_recv",
              "flow"):
        np.testing.assert_array_equal(_bits(getattr(got[3], f)),
                                      _bits(getattr(want[3], f)), f)
    assert int(got[3].sent.sum()) > 0


def test_slab_state_refuses_an_overfull_slab():
    owner = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    rows = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="slab"):
        c2.slab_state(rows, rows, owner, 2, 2)


def test_config2_run_small_on_cpu():
    res = c2.run(n_local=256, device="cpu")
    assert set(res) == CONFIG2_KEYS
    assert res["dropped_recv"] == 0 and res["placement_dropped_recv"] == 0
    assert res["n_total"] == 4096 and res["chips"] == 1
    assert res["placement_rounds"] <= 64 and res["placement_pps"] > 0
    assert res["ownership_imbalance"] > 3  # the clustered data is skewed
    assert res["balanced_bin_imbalance"] < 1.1  # and LPT balanced it
    assert res["value"] == res["pps_imbalanced"] > 0


def test_config2_placement_drains_and_owns():
    last, placed, _, rounds, (p, _, a) = c2.placement(256, device="cpu")
    assert int(last.dropped_recv.sum()) == 0
    assert int(last.backlog[-1].sum()) == 0 and int(last.sent[-1].sum()) == 0
    assert placed > 0 and rounds <= 64
    # every live row sits on the vrank owning its position
    rows = tnbody.planar_to_rows(p, 3, 1)
    cell = jbinning.rank_of_position(
        rows, jdomain.Domain(0.0, 1.0, periodic=True),
        jdomain.ProcessGrid((4, 4, 4)), xp=np,
    )
    slot = np.arange(rows.shape[0]) // 256
    alive = a.numpy()
    assert (cell[alive] == slot[alive]).all()
    assert alive.sum() == 64 * 128


def test_config3_build_matches_reference_and_runs():
    cfg, vgrid, (pos, vel, alive) = c3.build(n_local=1024)
    rng = np.random.default_rng(3)
    v_scale, cap, budget = jcommon.drift_sizing((8, 8, 1), 1024, 0.9, 0.02,
                                                headroom=1.5)
    jpos, _, jalive = jcommon.uniform_state((8, 8, 1), 1024, 0.9, rng)
    jvel = (v_scale * (rng.random(jpos.shape, dtype=np.float32) * 2.0
                       - 1.0)).astype(np.float32)
    for g, w in ((pos, jpos), (vel, jvel), (alive, jalive)):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert (cfg.capacity, cfg.local_budget) == (cap, budget)
    assert vgrid.shape == (8, 8, 1) and cfg.grid.shape == (1, 1, 1)
    res = c3.run(n_local=1024, device="cpu")
    assert CONFIG3_KEYS <= set(res) and res["dropped_recv"] == 0
    assert res["n_total"] == int(0.9 * 1024) * 64 and res["chips"] == 1


def test_pick_layout_is_one_device():
    dev_grid, vgrid, n_chips = tcommon.pick_layout((8, 8, 1))
    assert dev_grid.shape == (1, 1, 1) and vgrid.shape == (8, 8, 1)
    assert n_chips == 1


@pytest.mark.parametrize("sigma", [1.0, 1.5])
def test_lognormal_state_matches_reference(sigma):
    a = tcommon.lognormal_state((4, 4, 4), 64, 0.5,
                                np.random.default_rng(7), sigma=sigma)
    b = jcommon.lognormal_state((4, 4, 4), 64, 0.5,
                                np.random.default_rng(7), sigma=sigma)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_bits(x), _bits(y))


# ---- utils/stats -----------------------------------------------------------


def _migrate_stats(seed):
    r = np.random.default_rng(seed)
    S, V = 6, 8
    leaves = {f: r.integers(0, 50, (S, V)).astype(np.int32)
              for f in ("sent", "received", "population", "backlog")}
    leaves["dropped_recv"] = np.zeros((S, V), np.int32)
    if seed % 2:
        leaves["backlog"][-3:] = 7  # a stationary stall
        leaves["dropped_recv"][2, 3] = 4
    flow = r.integers(0, 9, (S, V, V)).astype(np.int32)
    t = tmig.MigrateStats(**{k: torch.from_numpy(v)
                             for k, v in leaves.items()},
                          flow=torch.from_numpy(flow))
    j = jmig.MigrateStats(**leaves, flow=flow)
    return t, j


@pytest.mark.parametrize("seed", [0, 1])
def test_migrate_summaries_match_reference(seed):
    t, j = _migrate_stats(seed)
    assert tstats.summarize_migrate(t) == jstats.summarize_migrate(j)
    for w in (3, 8):
        assert tstats.detect_stall(t, w) == jstats.detect_stall(j, w)
    one = tmig.MigrateStats(*[None if x is None else x[0] for x in t])
    assert tstats.summarize_migrate(one) == jstats.summarize_migrate(
        jmig.MigrateStats(*[None if x is None else x[0] for x in j])
    )
    if seed % 2:
        with pytest.raises(RuntimeError, match="dropped_recv=4"):
            tstats.check_no_loss(t)
        with pytest.raises(RuntimeError, match="dropped_recv=4"):
            jstats.check_no_loss(j)
    else:
        tstats.check_no_loss(t)


@pytest.mark.parametrize("stacked", [False, True])
def test_redistribute_summary_matches_reference(stacked):
    r = np.random.default_rng(3 + stacked)
    lead = (4,) if stacked else ()
    send = r.integers(0, 100, lead + (8, 8)).astype(np.int32)
    leaves = dict(
        send_counts=send,
        recv_counts=np.swapaxes(send, -1, -2).copy(),
        dropped_send=r.integers(0, 2, lead + (8,)).astype(np.int32),
        dropped_recv=np.zeros(lead + (8,), np.int32),
        needed_capacity=r.integers(0, 90, lead + (8,)).astype(np.int32),
    )
    t = texchange.RedistributeStats(**{k: torch.from_numpy(v)
                                       for k, v in leaves.items()})
    want = jstats.summarize_redistribute(jexchange.RedistributeStats(
        **leaves))
    assert tstats.summarize_redistribute(t) == want
    with pytest.raises(RuntimeError, match="dropped_send"):
        tstats.check_no_loss(t)


# ----------------------------------------------------------- configs 7, 4

from mpi_grid_redistribute_tpu.bench import config4_drift as jc4  # noqa: E402
from mpi_grid_redistribute_tpu.bench import config7_stress as jc7  # noqa: E402
from mpi_grid_redistribute_tpu_torch.bench import config4_drift as c4  # noqa: E402
from mpi_grid_redistribute_tpu_torch.bench import config7_stress as c7  # noqa: E402

# config 7's keys whose values are timings, or rates over a roof (the
# port's is the H100's HBM3, the reference's a TPU's)
C7_TIMED = {"value", "ms_per_step", "timing_spread", "pps",
            "exchange_bytes_per_sec", "exchange_gb_per_sec", "bw_util"}


def test_config7_run_one_matches_reference():
    """``_run_one`` at 2^12 rows, ``reps`` 1: the same keys, and every
    value the reference's but the timed and roof ones (its stats over
    the same 20-step long run: bytes a step, moved bytes, migration
    fraction, rows); nearly every row moves, none is dropped."""
    got = c7._run_one(1 << 12, reps=1, device="cpu")
    want = jc7._run_one(1 << 12, reps=1)
    assert list(got) == list(want)
    for k in set(got) - C7_TIMED:
        assert got[k] == want[k], k
    assert got["exchange_domain"] == "hbm"
    assert got["migration_fraction"] > 0.8
    assert got["bw_util"] == pytest.approx(
        got["exchange_bytes_per_sec"] / 3.35e12, rel=1e-3, abs=1e-6)


def test_config7_steps_bit_equal_to_reference():
    """Three stress steps (wrap, planar exchange): the port's state and
    stats bit for bit the reference's body on the same state."""
    n = 1 << 12
    fused, count, _ = c7.initial_state(n)
    step, cap = c7.make_step(n)
    dom = jdomain.Domain(0.0, 1.0, periodic=True)
    xfn = jexchange.vrank_redistribute_planar_fn(
        dom, jdomain.ProcessGrid((2, 2, 2)), cap, fused.shape[2])

    @jax.jit
    def jstep(f, c):
        p = jbinning.wrap_periodic_planar(f[:, :3, :] + f[:, 3:6, :], dom)
        return xfn(jax.numpy.concatenate([p, f[:, 3:, :]], axis=1), c)

    f, c = torch.from_numpy(fused), torch.from_numpy(count)
    jf, jcnt = jax.numpy.asarray(fused), jax.numpy.asarray(count)
    for _ in range(3):
        f, c, st = step(f, c)
        jf, jcnt, jst = jstep(jf, jcnt)
        assert _bits(f).tobytes() == _bits(jf).tobytes()
        assert _bits(c).tobytes() == _bits(jcnt).tobytes()
        for k in ("send_counts", "recv_counts", "dropped_send",
                  "dropped_recv", "needed_capacity"):
            np.testing.assert_array_equal(getattr(st, k).numpy(),
                                          np.asarray(getattr(jst, k)), k)


def test_config7_sweep_and_env(monkeypatch):
    """The sweep reports its peak-utilization size with every size under
    ``"sweep"``; ``BENCH_STRESS_N`` picks one size."""
    calls = []

    def fake(n, reps, device):
        calls.append(n)
        return {"rows": n, "bw_util": 1.0 / n, "ms_per_step": 1.0,
                "exchange_gb_per_sec": 2.0}

    monkeypatch.setattr(c7, "_run_one", fake)
    monkeypatch.setenv("BENCH_SCALE", "0.0625")
    out = c7.run()
    assert calls == [1 << 14, 1 << 15, 1 << 16]
    assert out["rows"] == 1 << 14 and len(out["sweep"]) == 3
    monkeypatch.setenv("BENCH_STRESS_N", "5000")
    assert c7.run()["rows"] == 5000


@pytest.mark.parametrize("grid_shape", [(2, 2, 2), (2, 2, 4)])
def test_config4_wire_captures_match_reference(grid_shape):
    """The canonical and the hierarchical wire captures return the
    reference's dicts (engine, scheduled and dense wire bytes, the
    two-level split), on 8 ranks (the reference's mesh) and on 16 (its
    vranks)."""
    got = c4.canonical_wire_capture(grid_shape, 0.02, device="cpu")
    want = jc4.canonical_wire_capture(grid_shape, 0.02)
    assert got == want and got["engine"] == "sparse"
    got = c4.hierarchical_wire_capture(grid_shape, (2, 1, 1), 0.02,
                                       device="cpu")
    want = jc4.hierarchical_wire_capture(grid_shape, (2, 1, 1), 0.02)
    assert got == want and got["engine"] == "hierarchical"
    assert got["dcn_bytes_per_step"] > 0 and got["ici_bytes_per_step"] > 0


def _reference_config4_state(n_local, migration, bias, s2):
    rng = np.random.default_rng(0)
    v_scale, _, _ = jcommon.drift_sizing((2, 2, 2), n_local, 0.9, migration)
    pos, _, alive = jcommon.uniform_state((2, 2, 2), n_local, 0.9, rng)
    if bias:
        sink = np.asarray([0.25, 0.25, 0.25], np.float32)
        vel = ((sink[None, :] - pos) / s2 * 0.65).astype(np.float32)
    else:
        vel = (v_scale * (rng.random(pos.shape, dtype=np.float32) * 2.0
                          - 1.0)).astype(np.float32)
    return pos, vel, alive


@pytest.mark.parametrize("bias", [False, True])
def test_config4_start_state_is_the_references(bias):
    got = c4.start_state(2048, 0.02, bias, 16)
    want = _reference_config4_state(2048, 0.02, bias, 16)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


C4_KEYS = ["metric", "value", "unit", "n_total", "chips", "ms_per_step",
           "report", "health", "flow", "fast_path_hit_rate"]


def test_config4_run_small_on_cpu():
    """The loop at 2^12 rows a vrank: the reference's keys, nothing
    dropped, health OK, the wire captures under ``"report"``; with the
    convergent bias the verdict is ALERT."""
    res = c4.run(n_local=1 << 12, steps=16, device="cpu")
    assert list(res) == C4_KEYS
    assert res["health"]["status"] == "OK"
    rep = res["report"]
    assert rep["stats"]["dropped_recv"] == 0 and rep["exchange_domain"] == "hbm"
    assert rep["wire_engine"] == "sparse"
    assert rep["hier_wire_engine"] == "hierarchical"
    assert rep["dcn_bytes_per_step"] > 0
    assert res["fast_path_hit_rate"] == 1.0
    biased = c4.run(n_local=1 << 12, steps=16, bias=True, device="cpu")
    assert biased["metric"] == "config4_drift_bias_pps_per_chip"
    assert biased["bias"] is True and "wire_engine" not in biased["report"]
    assert biased["health"]["status"] == "ALERT"


def test_config_entry_points_need_a_card_unless_asked_for_the_cpu():
    """Config 7, config 4 (its loop and both captures) and the service
    bench run on the GPU by default and raise without one."""
    from mpi_grid_redistribute_tpu_torch.bench import service_chunk

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: device=None runs there")
    for call in (lambda: c7._run_one(1 << 12, reps=1),
                 lambda: c4.run(n_local=1 << 12, steps=16),
                 lambda: c4.canonical_wire_capture((2, 2, 2), 0.02),
                 lambda: c4.hierarchical_wire_capture((2, 2, 2)),
                 lambda: service_chunk.prepare(64)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_rebalance_leg_runs_on_the_card_by_default():
    """The rebalance leg, its gate and ``--rebalance`` take the torch
    backend on the GPU unless the caller asks for the host loop or the
    CPU, and raise without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: device=None runs there")
    for call in (lambda: c4.run_rebalance(n_local=512, steps=8),
                 lambda: c4.rebalance_smoke(n_local=512, steps=8),
                 lambda: c4.main(["--rebalance"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_rebalance_smoke_gate_on_cpu(backend, capsys):
    """The reference's CI-sized gate (n_local 512, 48 steps, as its
    ``test_config4_rebalance_smoke_gate``): every clause holds on the
    host loop and on the torch backend on the CPU."""
    kw = {} if backend == "numpy" else {"device": "cpu"}
    assert c4.rebalance_smoke(backend=backend, n_local=512, steps=48,
                              **kw) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(c4.rebalance_checks(res).values())
    assert res["metric"] == "config4_rebalance_steady_ms"
