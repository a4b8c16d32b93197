"""The port's closed rebalance loop against the JAX package's on the CPU:
``RebalancePlanner.occupancy`` (integer counts, exactly the
reference's), ``plan`` and every ``AmortizationGuard`` decision on the
same inputs, ``apply_assignment`` as a pure permutation, and the
driver's closed loop (ALERT -> plan -> guard -> apply) journaling the
reference's ``rebalance`` events."""

import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu import service as jservice
from mpi_grid_redistribute_tpu.domain import Domain as JDomain
from mpi_grid_redistribute_tpu.domain import ProcessGrid as JGrid
from mpi_grid_redistribute_tpu.telemetry import rebalance as jreb
from mpi_grid_redistribute_tpu_torch import GridRedistribute
from mpi_grid_redistribute_tpu_torch import service as tservice
from mpi_grid_redistribute_tpu_torch.domain import Domain, GridEdges, \
    ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops import binning
from mpi_grid_redistribute_tpu_torch.telemetry import rebalance as reb
from mpi_grid_redistribute_tpu.telemetry import StepRecorder as JRecorder
from mpi_grid_redistribute_tpu_torch.telemetry import StepRecorder
from torch_service_cases import (
    assert_same_journal, cfg_pair, host, journal, steady_monitor,
)

DOM, JDOM = Domain(0.0, 1.0, periodic=True), JDomain(0.0, 1.0,
                                                     periodic=True)


def _skewed(rng, grid, n_local=256, hot_frac=0.9, spill=False):
    R = int(np.prod(grid))
    pos = rng.random((R * n_local, 3), dtype=np.float32)
    hot = rng.random(R * n_local) < hot_frac
    pos[hot] = (pos[hot] * 0.5).astype(np.float32)
    if spill:  # rows outside the box and on its faces: the wrap's work
        pos[::7] -= np.float32(1.0)
        pos[3::11] = np.float32(1.0)
        pos[5::13] = np.float32(0.0)
    count = rng.integers(0, n_local + 1, R).astype(np.int32)
    return pos, count


def _pair(grid, k):
    return (reb.RebalancePlanner(DOM, ProcessGrid(grid),
                                 cells_per_rank_axis=k),
            jreb.RebalancePlanner(JDOM, JGrid(grid), cells_per_rank_axis=k))


@pytest.mark.parametrize("grid,k,spill", [
    ((2, 2, 2), 1, False), ((2, 2, 2), 4, True), ((2, 2, 4), 2, True),
    ((1, 2, 3), 3, True), ((4, 1, 1), 8, False),
])
def test_occupancy_and_plan_equal_reference(rng, grid, k, spill):
    pos, count = _skewed(rng, grid, spill=spill)
    p, jp = _pair(grid, k)
    want = jp.occupancy(pos, count=count)
    for positions, c in ((pos, count),
                         (torch.from_numpy(pos), torch.from_numpy(count))):
        got = p.occupancy(positions, count=c)
        assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(p.occupancy(pos), jp.occupancy(pos))
    plan, jplan = p.plan(pos, count=count), jp.plan(pos, count=count)
    assert plan.edges.edges == jplan.edges.edges
    assert tuple(plan.edges.assignment) == tuple(jplan.edges.assignment)
    assert plan[1:] == jplan[1:]
    plan.edges.validate_against(DOM, ProcessGrid(grid))
    # the projection is realized: re-bin the live rows under the plan
    live = p._live_rows(torch.from_numpy(pos), torch.from_numpy(count))
    ranks = binning.rank_of_position(live, DOM, ProcessGrid(grid),
                                     edges=plan.edges)
    c = np.bincount(ranks.numpy(), minlength=int(np.prod(grid)))
    assert c.max() / c.mean() == pytest.approx(plan.projected_imbalance)


def test_planner_refusals_and_empty_state():
    p, jp = _pair((2, 2, 2), 2)
    assert p.plan(np.zeros((64, 3), np.float32),
                  count=np.zeros(8, np.int32)) is None
    for mod, grid in ((reb, ProcessGrid((2, 2, 2))),
                      (jreb, JGrid((2, 2, 2)))):
        dom = DOM if mod is reb else JDOM
        with pytest.raises(ValueError, match="cells_per_rank_axis must be"):
            mod.RebalancePlanner(dom, grid, cells_per_rank_axis=0)
    msgs = []
    for planner in (p, jp):
        with pytest.raises(ValueError) as ei:
            planner.occupancy(np.zeros((8 * 4 + 1, 3), np.float32))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


GAUGES = [
    dict(step=50, step_seconds=0.010, old_imbalance=2.0,
         projected_imbalance=1.0),
    dict(step=50, step_seconds=0.010, old_imbalance=1.04,
         projected_imbalance=1.02),
    dict(step=0, step_seconds=0.01, old_imbalance=0.0,
         projected_imbalance=1.0),
    dict(step=9, step_seconds=0.0, old_imbalance=3.0,
         projected_imbalance=1.2),
    dict(step=70, step_seconds=-1.0, old_imbalance=1.5,
         projected_imbalance=1.4),
    dict(step=200, step_seconds=0.0021, old_imbalance=6.2,
         projected_imbalance=1.003),
]


@pytest.mark.parametrize("kw", [
    {}, dict(horizon_steps=4), dict(horizon_steps=100, cooldown_steps=16),
    dict(min_improvement=0.5, initial_cost_factor=1.0),
    dict(cost_alpha=0.25, cooldown_steps=0),
])
def test_guard_decisions_equal_reference(kw):
    """Every decision, reason text included, and the cost EMA after each
    realized apply, over a script of gauges."""
    g, jg = reb.AmortizationGuard(**kw), jreb.AmortizationGuard(**kw)
    for i, gauges in enumerate(GAUGES * 2):
        d, jd = g.consider(**gauges), jg.consider(**gauges)
        assert tuple(d) == tuple(jd), (i, d, jd)
        assert isinstance(d, reb.GuardDecision)
        if d.apply:
            g.note_applied(gauges["step"], 0.003 * (i + 1))
            jg.note_applied(gauges["step"], 0.003 * (i + 1))
        assert (g.cost_ema_s, g.last_applied_step, g.applies) == (
            jg.cost_ema_s, jg.last_applied_step, jg.applies)


@pytest.mark.parametrize("kw", [dict(horizon_steps=0),
                                dict(cooldown_steps=-1),
                                dict(min_improvement=1.0),
                                dict(cost_alpha=0.0)])
def test_guard_validation_equal_reference(kw):
    msgs = []
    for mod in (reb, jreb):
        with pytest.raises(ValueError) as ei:
            mod.AmortizationGuard(**kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_apply_assignment_is_a_pure_permutation(rng):
    grid = ProcessGrid((2, 2, 2))
    pos, _ = _skewed(rng, (2, 2, 2), n_local=128)
    count = np.full(8, 64, np.int32)
    vel = rng.random((8 * 128, 3), dtype=np.float32)
    ids = np.arange(8 * 128, dtype=np.int32)
    rd = GridRedistribute(DOM, grid, device="cpu", capacity=128)
    before = rd.redistribute(pos, vel, ids, count=count)
    state = (before.positions, *before.fields, before.count)
    plan = reb.RebalancePlanner(DOM, grid, cells_per_rank_axis=4).plan(
        before.positions, count=before.count)
    res = rd.apply_assignment(plan.edges, *state[:3], count=state[3])
    assert tservice.particle_set(res.positions, *res.fields, res.count) == \
        tservice.particle_set(*state)
    assert rd.edges is plan.edges
    c = res.count.numpy().astype(np.float64)
    assert c.max() / c.mean() <= 1.1


def _drift_driver(mod, backend, rebalance, grid=(2, 2, 2), n_local=512,
                  steps=48, **kw):
    """A driver of ``mod``'s package under a convergent drift into one
    octant, with the stock health rules but the wall-time ones (so two
    runs journal the same alerts)."""
    cfg = cfg_pair(backend, grid_shape=grid, n_local=n_local, fill=0.5,
                   steps=steps, health_every=4, rebalance=rebalance,
                   rebalance_threshold=1.5, rebalance_cells=4,
                   rebalance_horizon=512, **kw)[mod is tservice]
    rec = (JRecorder if mod is jservice else StepRecorder)()
    drv = mod.ServiceDriver(cfg, recorder=rec,
                            monitor=steady_monitor(mod, rec))
    drv.init_state()
    pos, vel, ids, count = host(drv.state)
    sink = np.asarray([0.25, 0.25, 0.25], np.float32)
    vel = ((sink[None, :] - pos) / np.float32(2 * steps)).astype(np.float32)
    if mod is tservice:
        drv.state = drv._to_state(pos, vel, ids, count)
    else:
        drv.state = (pos, vel, ids, count)
    drv.run()
    drv.close()
    return drv


# one apply at most (the cooldown outlasts the run): every later decision
# is a cooldown, so no decision depends on a wall time
ONE_APPLY = dict(rebalance_cooldown=1000)


@pytest.mark.parametrize("backend,grid", [("numpy", (2, 2, 2)),
                                          ("torch", (2, 2, 4))])
def test_closed_loop_journal_equals_reference(backend, grid):
    """The closed loop in both drivers: the same alerts, the same
    ``rebalance`` events (applied and declined, every field that is not
    a wall time), the same final bytes."""
    j = _drift_driver(jservice, backend, True, grid=grid, **ONE_APPLY)
    t = _drift_driver(tservice, backend, True, grid=grid, **ONE_APPLY)
    kinds = {"alert", "rebalance", "capacity_grow", "flow_snapshot"}
    assert_same_journal(j.recorder, t.recorder, kinds)
    events = [d for k, d in journal(t.recorder, {"rebalance"})]
    applied = [e for e in events if e["applied"]]
    assert len(applied) == 1 and applied[0]["realized_imbalance"] <= 1.1
    assert applied[0]["rows_moved"] > 0
    a, b = host(j.state), host(t.state)
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_closed_loop_applies_and_keeps_the_particle_set(backend):
    base = _drift_driver(tservice, backend, False, rebalance_cooldown=8)
    drv = _drift_driver(tservice, backend, True, rebalance_cooldown=8)
    alerts = [e for e in drv.recorder.events("alert")
              if e.data.get("rule") == "imbalance_ratio"]
    assert alerts
    applied = [e.data for e in drv.recorder.events("rebalance")
               if e.data.get("applied")]
    assert applied
    for e in applied:
        assert e["realized_imbalance"] <= 1.1 and e["cost_s"] > 0
        assert "trigger" in e and "reason" in e
    assert sum(e.data["dropped"]
               for e in drv.recorder.events("step_latency")) == 0
    assert tservice.particle_set(*drv.state) == tservice.particle_set(
        *base.state)
    assert isinstance(drv._edges, GridEdges)


def test_closed_loop_decline_journaled():
    drv = tservice.ServiceDriver(tservice.DriverConfig(
        grid_shape=(2, 2, 2), n_local=256, fill=0.5, steps=32,
        backend="torch", device="cpu", health_every=4, rebalance=True,
        rebalance_threshold=1.2, rebalance_min_improvement=0.999))
    drv.init_state()
    pos, vel, ids, count = host(drv.state)
    sink = np.asarray([0.25, 0.25, 0.25], np.float32)
    vel = ((sink[None, :] - pos) / np.float32(64)).astype(np.float32)
    drv.state = drv._to_state(pos, vel, ids, count)
    drv.run()
    drv.close()
    events = [e.data for e in drv.recorder.events("rebalance")]
    assert events and all(not e["applied"] for e in events)
    declined = [e for e in events if "old_imbalance" in e]
    assert declined
    for e in declined:
        assert "below the" in e["reason"]
        assert e["projected_imbalance"] <= e["old_imbalance"]


def _backlog_events(rec, backlogs):
    for s, b in enumerate(backlogs):
        rec.record("migrate_step", step=s, sent=10, received=10, backlog=b,
                   dropped_recv=0, population=100)


@pytest.mark.parametrize("rebalance_on,fires", [
    (("imbalance_ratio", "backlog_growth"), True),
    (("imbalance_ratio",), False),
])
def test_backlog_growth_trigger_filtered_by_rebalance_on(rebalance_on,
                                                         fires):
    out = []
    for mod in (jservice, tservice):
        cfg = cfg_pair("numpy", grid_shape=(2, 2, 2), steps=8,
                       rebalance=True, rebalance_on=rebalance_on)[
            mod is tservice]
        drv = mod.ServiceDriver(cfg)
        drv.init_state()
        _backlog_events(drv.recorder, [0, 5, 9, 14, 20])
        verdict = drv._health_check()
        assert any(f["rule"] == "backlog_growth"
                   for f in verdict["findings"])
        out.append(journal(drv.recorder, {"rebalance", "alert"}))
    assert out[0] == out[1]
    evs = [d for k, d in out[1] if k == "rebalance"]
    assert len(evs) == (1 if fires else 0)
    if fires:
        assert evs[0]["rule"] == "backlog_growth"
