"""The port's grid observatory (telemetry/flow.py, health.py,
traceview.py), the JAX package's ``tests/test_flow.py`` on the port:

* flow: the ``[R, R]`` matrix's row sums equal ``sent`` and its column
  sums ``received`` EXACTLY on every engine path, the vrank loop on one
  device and the flat and vrank engines across a gloo world of 8 ranks
  (``torch_rank_cases.shared_world``), and its capture adds no read off
  the device to the loop; the accumulator's gauges by hand math and
  against the reference's on the same matrices;
* health: synthetic journals drive each rule and the alert, callback and
  dedup contract, with the reference's findings on the same journal;
* traceview: valid Chrome-trace JSON (every event carries ``ph``/``pid``,
  non-metadata events ``ts``), the reference's trace on the same
  journal."""

import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_rank_cases as cases
from mpi_grid_redistribute_tpu import telemetry as jtel
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.models import nbody
from mpi_grid_redistribute_tpu_torch.parallel.migrate import MigrateStats
from mpi_grid_redistribute_tpu_torch.telemetry import (
    FlowAccumulator,
    HealthMonitor,
    PhaseTiming,
    StepRecorder,
    default_rules,
    flow_matrix_of,
    record_flow_snapshot,
    record_migrate_steps,
    to_chrome_trace,
    write_trace,
)
from mpi_grid_redistribute_tpu_torch.telemetry import flow as flow_lib
from mpi_grid_redistribute_tpu_torch.telemetry import health as health_lib

torch.set_num_threads(1)

DOMAIN = Domain(0.0, 1.0, periodic=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return cases.shared_world(tmp_path_factory, "migrate",
                              "torch_rank_cases:run_migrate", 8)


# ------------------------------------------------------------ hand math


def _stats2(flow_steps, population):
    """A 2-rank step-stacked MigrateStats from hand flow matrices."""
    f = torch.tensor(flow_steps, dtype=torch.int32)  # [S, 2, 2]
    return MigrateStats(
        sent=f.sum(dim=2, dtype=torch.int32),
        received=f.sum(dim=1, dtype=torch.int32),
        population=torch.tensor(population, dtype=torch.int32),
        backlog=torch.zeros(f.shape[:2], dtype=torch.int32),
        dropped_recv=torch.zeros(f.shape[:2], dtype=torch.int32),
        flow=f,
    )


def test_flow_accumulator_hand_math():
    # step 1: rank 0 sends 3 to rank 1; step 2: 1 back, 5 forward
    stats = _stats2([[[0, 3], [0, 0]], [[0, 5], [1, 0]]], [[7, 3], [4, 6]])
    acc = FlowAccumulator(ema_alpha=0.5)
    acc.update(stats)
    np.testing.assert_array_equal(acc.cumulative, [[0, 8], [1, 0]])
    # the EMA is seeded with step 1, then 0.5-blended with step 2
    np.testing.assert_allclose(acc.ema, [[0.0, 4.0], [0.5, 0.0]])
    assert acc.steps == 2
    # imbalance from the LAST step's population: max/mean of [4, 6]
    assert acc.imbalance == pytest.approx(6.0 / 5.0)
    assert acc.top_pairs(k=5) == [(0, 1, 8), (1, 0, 1)]
    snap = acc.snapshot(k=1)
    assert snap["moved_rows_total"] == 9
    assert snap["n_ranks"] == 2
    assert snap["top_pairs"] == [[0, 1, 8]]
    json.dumps(snap)
    with pytest.raises(ValueError, match="ema_alpha"):
        FlowAccumulator(ema_alpha=0.0)


def test_flow_accumulator_matches_reference():
    """Random step matrices and populations: the port's gauges and
    snapshots are the reference's."""
    r = np.random.default_rng(9)
    t, j = FlowAccumulator(ema_alpha=0.3), jtel.FlowAccumulator(ema_alpha=0.3)
    for _ in range(4):
        m = r.integers(0, 40, (3, 6, 6))
        pop = r.integers(0, 100, (3, 6))
        t.update(torch.from_numpy(m), population=torch.from_numpy(pop))
        j.update(m, population=pop)
        np.testing.assert_array_equal(t.cumulative, j.cumulative)
        np.testing.assert_array_equal(t.ema, j.ema)
        assert t.snapshot(k=4) == j.snapshot(k=4)
        assert t.top_pairs(k=3, ema=True) == j.top_pairs(k=3, ema=True)


def test_imbalance_gauge_empty_and_partial_population():
    acc = FlowAccumulator()
    assert acc.imbalance == 0.0  # never fed
    acc.update(np.zeros((2, 2), np.int64), population=[0, 0])
    assert acc.imbalance == 1.0  # all empty = balanced
    assert acc.snapshot()["population"] == [0, 0]
    acc.update(np.zeros((2, 2), np.int64), population=[0, 6])
    assert acc.imbalance == pytest.approx(2.0)  # max 6 / mean 3
    assert acc.snapshot()["population"] == [0, 6]
    # [S, R] population: only the LAST step's gauge sticks
    acc.update(np.zeros((2, 2, 2), np.int64), population=[[9, 1], [4, 4]])
    assert acc.imbalance == pytest.approx(1.0)
    assert acc.snapshot()["population"] == [4, 4]
    with pytest.raises(ValueError, match="non-negative"):
        acc.update(np.zeros((2, 2), np.int64), population=[3, -1])


def test_snapshot_population_none_until_fed():
    acc = FlowAccumulator()
    acc.update(np.asarray([[0, 2], [1, 0]], np.int64))
    snap = acc.snapshot()
    assert snap["population"] is None
    assert snap["imbalance"] == 0.0
    json.dumps(snap)


def test_top_pairs_ordering_diag_and_zeros():
    m = np.asarray([[9, 4, 0], [4, 9, 2], [0, 0, 9]])
    # the diagonal is excluded by default; (0,1) vs (1,0) ties break
    # toward the lower pair; zero links are never reported
    assert flow_lib.top_pairs(m, k=10) == [(0, 1, 4), (1, 0, 4), (1, 2, 2)]
    assert flow_lib.top_pairs(torch.from_numpy(m), k=1,
                              include_diag=True) == [(0, 0, 9)]
    with pytest.raises(ValueError):
        flow_lib.top_pairs(np.zeros((2, 3)))


def test_flow_matrix_of_validation():
    stats = _stats2([[[0, 1], [2, 0]]], [[3, 3]])
    m = flow_matrix_of(stats)
    assert m.shape == (1, 2, 2) and m.dtype == np.int64
    with pytest.raises(ValueError, match="flow is None"):
        flow_matrix_of(stats._replace(flow=None))
    with pytest.raises(TypeError):
        flow_matrix_of(object())
    acc = FlowAccumulator(n_ranks=4)
    with pytest.raises(ValueError, match="built for 4 ranks"):
        acc.update(stats)


def test_link_report_per_link_bw():
    m = np.asarray([[0.0, 100.0], [25.0, 0.0]])
    rep = flow_lib.link_report(m, row_bytes=28, step_seconds=1e-3)
    assert rep["domain"] == "nvlink"
    assert rep["link_roof_bytes_per_sec"] == 450e9  # NVLink 4, each way
    top = rep["links"][0]
    assert (top["src"], top["dst"]) == (0, 1)
    assert top["bytes_per_step"] == pytest.approx(2800.0)
    assert top["bytes_per_sec"] == pytest.approx(2.8e6)
    assert top["bw_util"] == pytest.approx(2.8e6 / 450e9)
    rep2 = flow_lib.link_report(m, row_bytes=28)
    assert rep2["links"][0]["bw_util"] is None
    hbm = flow_lib.link_report(m, row_bytes=28, step_seconds=1e-3,
                               domain="hbm")
    assert hbm["link_roof_bytes_per_sec"] == 3.35e12
    with pytest.raises(ValueError):
        flow_lib.link_report(m, row_bytes=28, domain="ici")


# --------------------------------------- engine exactness (one device)


def _vrank_loop(steps, engine="auto"):
    r = np.random.default_rng(21)
    vgrid = ProcessGrid((2, 2, 2))
    n_local = 64
    n = vgrid.nranks * n_local
    pos = r.random((n, 3), dtype=np.float32)
    vel = (0.6 * (r.random((n, 3), dtype=np.float32) - 0.5)).astype(
        np.float32)
    alive = r.random(n) > 0.125
    cfg = nbody.DriftConfig(domain=DOMAIN, grid=ProcessGrid((1, 1, 1)),
                            dt=0.0625, capacity=n_local, n_local=n_local,
                            engine=engine)
    loop = nbody.make_migrate_loop(cfg, steps, vgrid=vgrid, device="cpu")
    return lambda: loop(pos, vel, alive)


@pytest.mark.parametrize("engine", ["auto", "planar"])
def test_flow_row_col_sums_exact_vranks(engine):
    """The 8-vrank loop on one device: rows == sent, columns ==
    received, every step; the diagonal is structurally zero."""
    stats = _vrank_loop(5, engine)()[3]
    m = flow_matrix_of(stats)
    assert m.shape == (5, 8, 8)
    np.testing.assert_array_equal(m.sum(axis=2), stats.sent.numpy())
    np.testing.assert_array_equal(m.sum(axis=1), stats.received.numpy())
    assert np.einsum("sii->s", m).sum() == 0


@pytest.mark.parametrize("name", ["flat-222", "flat-421", "vr-221x122",
                                  "vr-211x221"])
def test_flow_row_col_sums_exact_across_ranks(world, name):
    """A gloo world of 8 ranks (the flat engine, and vranks on several
    devices): every rank holds the same gathered flow, rows == sent and
    columns == received, every step."""
    dev_shape = cases.MIGRATE_CASES[name][0]
    Dev = int(np.prod(dev_shape))
    flows = [world[r][name][1]["flow"] for r in range(Dev)]
    for f in flows[1:]:
        np.testing.assert_array_equal(f, flows[0])
    st = world[0][name][1]
    m = flow_matrix_of(MigrateStats(
        sent=st["sent"], received=st["received"],
        population=st["population"], backlog=st["backlog"],
        dropped_recv=st["dropped_recv"], flow=st["flow"]))
    np.testing.assert_array_equal(m.sum(axis=2), st["sent"])
    np.testing.assert_array_equal(m.sum(axis=1), st["received"])
    assert m.sum() > 0


class _ScalarReads(TorchDispatchMode):
    """Counts reads of a tensor's value to the host."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_flow_capture_adds_no_host_read():
    """The dense loop, flow leaf included, reads no value off its tensors
    while it runs (the mover-sparse engine reads exactly its one guard a
    step, flow or not)."""
    run = _vrank_loop(3, "planar")
    with _ScalarReads() as mode:
        stats = run()[3]
    assert stats.flow is not None and mode.n == 0
    run = _vrank_loop(3, "auto")
    with _ScalarReads() as mode:
        stats = run()[3]
    assert stats.flow is not None and mode.n == 3


# --------------------------------------------------------------- health


def _backlog_events(rec, backlogs):
    for s, b in enumerate(backlogs):
        rec.record("migrate_step", step=s, sent=10, received=10, backlog=b,
                   dropped_recv=0, population=100)


def test_backlog_growth_alert_and_callback():
    rec = StepRecorder()
    fired = []
    mon = HealthMonitor(rec, on_alert=fired.append)
    _backlog_events(rec, [0, 5, 9, 14, 20])
    verdict = mon.evaluate()
    assert verdict["status"] == health_lib.ALERT
    assert [f["rule"] for f in verdict["findings"]] == ["backlog_growth"]
    assert "5 -> 20" in verdict["findings"][0]["reason"]
    assert len(fired) == 1 and fired[0].rule == "backlog_growth"
    alerts = rec.events("alert")
    assert len(alerts) == 1 and alerts[0].data["rule"] == "backlog_growth"
    # the same evidence does not re-fire
    assert mon.evaluate()["status"] == health_lib.ALERT
    assert len(fired) == 1 and len(rec.events("alert")) == 1
    # new evidence re-arms the rule
    _backlog_events(rec, [22, 25, 29, 31])
    mon.evaluate()
    assert len(fired) == 2
    # a broken callback is journaled, not raised
    mon.add_callback(lambda f: 1 / 0)
    _backlog_events(rec, [40, 50, 60, 70])
    mon.evaluate()
    assert rec.last("callback_error").data["error"].startswith(
        "ZeroDivisionError")
    # the scrape path journals nothing
    n = rec.total_recorded
    assert mon.evaluate(record=False)["status"] == health_lib.ALERT
    assert rec.total_recorded == n


def test_backlog_growth_requires_monotone_and_nonzero():
    rec = StepRecorder()
    _backlog_events(rec, [0, 5, 3, 6, 4])  # dips: healthy retries
    assert HealthMonitor(rec).evaluate()["status"] == health_lib.OK
    rec2 = StepRecorder()
    _backlog_events(rec2, [1, 2, 3, 0])  # drains at the end
    assert HealthMonitor(rec2).evaluate()["status"] == health_lib.OK


def test_dropped_rows_and_imbalance_rules():
    rec = StepRecorder()
    rec.record("migrate_step", step=0, sent=5, received=4, backlog=0,
               dropped_recv=1, population=10)
    v = HealthMonitor(rec).evaluate()
    assert v["status"] == health_lib.ALERT
    assert any(f["rule"] == "dropped_rows" for f in v["findings"])
    rec2 = StepRecorder()
    acc = FlowAccumulator()
    # max/mean = 90/30 = 3.0x > the 2.0x threshold
    acc.update(np.zeros((4, 4), np.int64),
               population=np.asarray([90, 10, 10, 10]))
    record_flow_snapshot(rec2, acc)
    v2 = HealthMonitor(rec2).evaluate()
    assert v2["status"] == health_lib.WARN
    assert any(f["rule"] == "imbalance_ratio" for f in v2["findings"])


def test_step_time_spike_rule():
    rec = StepRecorder()
    mon = HealthMonitor(rec)
    for _ in range(6):
        mon.note_step_time(0.010)
    assert mon.evaluate()["status"] == health_lib.OK
    mon.note_step_time(0.200)  # 20x the EMA
    v = mon.evaluate()
    assert v["status"] == health_lib.WARN
    assert any(f["rule"] == "step_time_spike" for f in v["findings"])


def test_default_rules_are_the_references():
    assert [(r.name, r.severity) for r in default_rules()] == [
        (r.name, r.severity) for r in jtel.default_rules()]


def _rich_journal(mod):
    """One journal that trips most rules, written through ``mod``'s
    recorder (wall times pinned so ages and traces agree)."""
    rec = mod.StepRecorder(host="h", pid=1)
    for s, b in enumerate([0, 4, 9, 13, 18]):
        rec.record_at("migrate_step", 100.0 + s, step=s, sent=10,
                      received=10, backlog=b, dropped_recv=int(s == 3),
                      population=100)
    for s in range(17):
        rec.record_at("fast_path", 106.0, step=s, taken=int(s % 4 == 0),
                      movers=40, movers_max_rank=9)
    for k in range(5):
        rec.record_at("capacity_grow", 107.0, which="send", old=8 << k,
                      new=16 << k, needed=9 << k, dropped=1, call=k)
    for t in [0.01] * 6 + [0.09]:
        rec.record_at("step_time", 108.0, seconds=t)
    rec.record_at("state_health", 109.0, step=7, nan_pos=1, nan_vel=0,
                  oob=2, residual=-3, live=90)
    rec.record_at("flow_snapshot", 110.0, steps=1, n_ranks=4,
                  moved_rows_total=5, imbalance=2.5, population=[9, 1, 1, 1],
                  top_pairs=[])
    rec.record_at("overflow_window_loss", 111.0, through_call=4,
                  dropped_send=3, dropped_recv=0)
    for s in range(16):
        rec.record_at("step_latency", 112.0, step=s, seconds=0.5,
                      dropped=int(s % 2))
    return rec


def test_health_findings_match_reference():
    t, j = _rich_journal(__import__(
        "mpi_grid_redistribute_tpu_torch.telemetry", fromlist=["x"])), \
        _rich_journal(jtel)
    extra = lambda mod: [mod.health.slo_latency_p99(0.1),
                         mod.health.slo_dropped_rows(),
                         mod.health.burn_rate_latency(0.1, slow_window=20),
                         mod.health.burn_rate_dropped(slow_window=20)]
    from mpi_grid_redistribute_tpu_torch import telemetry as ttel

    tv = HealthMonitor(t, rules=default_rules() + extra(ttel)).evaluate()
    jv = jtel.HealthMonitor(j, rules=jtel.default_rules()
                            + extra(jtel)).evaluate()
    assert tv == jv
    assert len(tv["findings"]) >= 8 and tv["status"] == health_lib.ALERT


# ------------------------------------------------------------- traceview


def _valid_chrome_trace(trace):
    assert isinstance(trace["traceEvents"], list)
    for e in trace["traceEvents"]:
        assert "ph" in e and "pid" in e, e
        if e["ph"] != "M":
            assert isinstance(e["ts"], (int, float)), e
        if e["ph"] == "X":
            assert e["dur"] >= 0
    json.loads(json.dumps(trace))


def test_chrome_trace_schema(tmp_path):
    rec = StepRecorder()
    rec.record("capacity_grow", old=64, new=128)
    _backlog_events(rec, [0, 3, 7, 9])  # a monotone window: an alert
    assert HealthMonitor(rec).evaluate()["status"] == health_lib.ALERT
    acc = FlowAccumulator()
    acc.update(np.asarray([[0, 2], [1, 0]]))
    record_flow_snapshot(rec, acc)
    timings = [PhaseTiming("bin", 0.010, 0.010, 1024, 0.001),
               PhaseTiming("sort", 0.030, 0.020, None, None)]
    trace = to_chrome_trace(rec, phase_timings=timings, step_seconds=2e-3)
    _valid_chrome_trace(trace)
    by_ph = {}
    for e in trace["traceEvents"]:
        by_ph.setdefault(e["ph"], []).append(e)
    kinds = {e["name"] for e in by_ph["i"]}
    assert kinds >= {"capacity_grow", "migrate_step", "alert",
                     "flow_snapshot"}
    spans = by_ph["X"]
    assert [s["name"] for s in spans] == ["bin", "sort"]
    assert spans[0]["ts"] == 0 and spans[0]["dur"] == pytest.approx(1e4)
    assert spans[1]["ts"] == pytest.approx(1e4)
    assert spans[0]["args"]["x_roofline"] == pytest.approx(10.0)
    counters = [e for e in by_ph["C"] if e["name"] == "backlog"]
    assert [c["ts"] for c in counters] == [0.0, 2e3, 4e3, 6e3]
    assert [c["args"]["backlog"] for c in counters] == [0, 3, 7, 9]
    path = tmp_path / "trace.json"
    n = write_trace(str(path), rec, phase_timings=timings)
    reloaded = json.loads(path.read_text())
    assert len(reloaded["traceEvents"]) == n
    _valid_chrome_trace(reloaded)


def test_chrome_trace_matches_reference():
    """The same journal (causal flow arrows included) gives the
    reference's trace."""
    from mpi_grid_redistribute_tpu_torch import telemetry as ttel

    def journal(mod):
        rec = mod.StepRecorder(host="h", pid=1)
        ctx = mod.StepContext(trace="t0", origin="main")
        with mod.context.use(ctx):
            _backlog_events(rec, [0, 3, 7, 9])
            mod.HealthMonitor(rec).evaluate()
        for i, e in enumerate(rec._ring):
            rec._ring[i] = e._replace(time=50.0 + i)
        return rec

    t = to_chrome_trace(journal(ttel), step_seconds=1e-3)
    j = jtel.to_chrome_trace(journal(jtel), step_seconds=1e-3)
    assert t == j
    assert any(e["ph"] == "s" for e in t["traceEvents"])


# ------------------------------------------------------- public API


def test_rd_flow_health_perfetto(tmp_path):
    from mpi_grid_redistribute_tpu_torch import GridRedistribute

    rng = np.random.default_rng(1234)
    pos = rng.random((1024, 3), dtype=np.float32)
    with GridRedistribute(lo=0.0, hi=1.0, grid=(2, 2, 2), device="cpu",
                          capacity_factor=4.0) as rd:
        with pytest.raises(RuntimeError):
            rd.flow()
        res = rd.redistribute(pos)
        fl = rd.flow(k=3)
        np.testing.assert_array_equal(
            fl["matrix"], res.stats.send_counts.numpy().astype(np.int64))
        np.testing.assert_array_equal(fl["matrix"].sum(axis=1),
                                      res.stats.send_counts.sum(1).numpy())
        assert fl["imbalance"] >= 1.0
        assert len(fl["hot_links"]) <= 3
        assert rd.telemetry.counts().get("flow_snapshot") == 1
        assert rd.health()["status"] == "OK"
        path = tmp_path / "api_trace.json"
        assert rd.to_perfetto(str(path)) > 0
        _valid_chrome_trace(json.loads(path.read_text()))
        _valid_chrome_trace(rd.to_perfetto(step_seconds=1e-3))


def test_record_migrate_steps_validates_and_rank_totals():
    good = _stats2([[[0, 3], [1, 0]]], [[5, 5]])
    rec = StepRecorder()
    record_migrate_steps(rec, good, rank_totals=True)
    ev = rec.last("migrate_step")
    assert ev.data["sent_per_rank"] == [3, 1]
    assert ev.data["received_per_rank"] == [1, 3]
    assert ev.data["population_per_rank"] == [5, 5]
    bad = good._replace(backlog=torch.zeros((1, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="shape-congruent"):
        record_migrate_steps(StepRecorder(), bad)


# ------------------------------------------- the API across ranks


@pytest.fixture(scope="module")
def exchange_world(tmp_path_factory):
    return cases.shared_world(tmp_path_factory, "exchange",
                              "torch_rank_cases:run_exchange", 8)


API_KEYS = ["auto", "planar", "neighbor", "grow", "sparse-fallback",
            "sparse-ratchet"]


@pytest.mark.parametrize("key", API_KEYS)
def test_api_telemetry_across_ranks(exchange_world, key):
    """``GridRedistribute(mesh=)`` on a gloo world of 8: every rank's
    journal, report, flow, health and metrics are the same (they read the
    gathered stats), and they are the reference's instance's on its
    8-device mesh, but for the wire's name and roof: NVLink 4 here, the
    TPU's ICI there (held by hand math instead)."""
    from test_torch_exchange_ranks import API_KW

    from mpi_grid_redistribute_tpu import api as japi
    from mpi_grid_redistribute_tpu.domain import ProcessGrid as JGrid
    from mpi_grid_redistribute_tpu.parallel import mesh as jmesh

    views = [exchange_world[r][("api-telemetry", key)] for r in range(8)]
    for v in views[1:]:
        assert v["journal"] == views[0]["journal"]
        assert json.dumps(v["report"], default=int) == json.dumps(
            views[0]["report"], default=int)
        np.testing.assert_array_equal(v["flow"]["matrix"],
                                      views[0]["flow"]["matrix"])
        assert v["health"] == views[0]["health"]
        assert v["metrics"] == views[0]["metrics"]
    got = views[0]
    drift, clustered, kw = API_KW[key]
    pos, vel, ids, _ = cases.rows_inputs(8, 96, drift, 5, clustered)
    import jax

    rd = japi.GridRedistribute(
        grid=(2, 2, 2), lo=(0.0,) * 3, hi=(1.0,) * 3, periodic=(True,) * 3,
        mesh=jmesh.make_mesh(JGrid((2, 2, 2)), jax.devices()[:8]), **kw)
    rd.redistribute(pos, vel, ids)
    want = cases.telemetry_views(rd)
    assert got["journal"] == want["journal"]
    np.testing.assert_array_equal(got["flow"]["matrix"],
                                  want["flow"]["matrix"])
    # row sums are the send totals, column sums the receive totals
    m = got["flow"]["matrix"]
    assert got["flow"]["snapshot"] == want["flow"]["snapshot"]
    assert m.sum() == got["report"]["stats"]["total_rows"]
    assert got["health"] == want["health"]
    assert got["metrics"] == want["metrics"]
    g = json.loads(json.dumps(got["report"], default=int))
    w = json.loads(json.dumps(want["report"], default=int))
    assert (g.pop("exchange_domain"), w.pop("exchange_domain")) == (
        "nvlink", "ici")
    assert g["n_chips"] == 8
    util = g.pop("bw_util")
    w.pop("bw_util")
    # across cards only the moved rows ride the wire, against a card's
    # NVLink 4 roof (450 GB/s each way)
    assert g["exchange_bytes_per_sec"] == pytest.approx(
        g["moved_bytes_per_step"] / 1e-3)
    assert util == pytest.approx(g["exchange_bytes_per_sec"] / 8 / 450e9)
    links_g, links_w = g.pop("links"), w.pop("links")
    assert links_g["link_roof_bytes_per_sec"] == 450e9
    for a, b in zip(links_g["links"], links_w["links"]):
        assert a["bw_util"] == pytest.approx(a["bytes_per_sec"] / 450e9)
        a.pop("bw_util"), b.pop("bw_util")
    assert links_g["links"] == links_w["links"]
    assert g == w
