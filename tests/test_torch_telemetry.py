"""The port's telemetry core (mpi_grid_redistribute_tpu_torch.telemetry):
the recorder, the report's hand math over the H100 roofs, phase
attribution, the profiler session, and the API's journal held against
the JAX package's on the same seeded call sequence.

The cross-check drives one call sequence through the reference's
``GridRedistribute(backend="jax")`` and the port's for every engine, on a
(4, 2, 2) grid (more ranks than the tests' 8 devices, so the reference
runs vranks, as the port does on one device): a tight capacity under
``"grow"`` that grows and then a deferred window that loses rows, an
``"ignore"`` instance that drops rows, and ``halo()`` growing its
capacities. It asserts equal journals (kind and payload, minus the
random trace id), equal ``report()`` dicts but for the roof-derived
fields (held by hand math against the port's roofs instead), equal
``flow()`` matrices, ``health()`` findings and rendered ``metrics()``."""

import json

import numpy as np
import pytest
import torch

import mpi_grid_redistribute_tpu as jgr
from mpi_grid_redistribute_tpu import telemetry as jtel
import mpi_grid_redistribute_tpu_torch as tgr
from mpi_grid_redistribute_tpu_torch.parallel.exchange import (
    RedistributeStats,
)
from mpi_grid_redistribute_tpu_torch.parallel.migrate import MigrateStats
from mpi_grid_redistribute_tpu_torch.telemetry import (
    ProfilerSession,
    StepContext,
    StepRecorder,
    attribute_phases,
    current,
    exchange_report,
    format_phase_table,
    format_report,
    profile_dir_from_env,
    record_chunk_steps,
    record_fast_path_steps,
    record_migrate_steps,
    row_bytes_of,
    scoped,
    span,
    traced_span,
)
from mpi_grid_redistribute_tpu_torch.utils import profiling

torch.set_num_threads(1)

JDOM = jgr.Domain(0.0, 1.0, periodic=True)
TDOM = tgr.Domain(0.0, 1.0, periodic=True)
HBM = 3.35e12  # H100 SXM5 80 GB HBM3, B/s
NVLINK = 450e9  # NVLink 4, B/s each way a GPU


def _journal(rec):
    """``(kind, payload)`` of every retained event, without the random
    trace id of the step context."""
    return [(e.kind, {k: v for k, v in e.data.items() if k != "trace"})
            for e in rec.events()]


# ---------------------------------------------------------------- recorder


def test_recorder_ring_eviction_and_counts():
    rec = StepRecorder(capacity=4)
    for i in range(10):
        rec.record("tick", i=i)
    assert len(rec) == 4
    assert rec.total_recorded == 10
    assert rec.evicted == 6
    assert rec.counts() == {"tick": 10}  # all-time counts survive
    assert [e.data["i"] for e in rec.events("tick")] == [6, 7, 8, 9]
    assert rec.last("tick").data["i"] == 9
    rec.clear()
    assert len(rec) == 0 and rec.counts() == {}
    with pytest.raises(ValueError):
        StepRecorder(capacity=0)


def test_recorder_disabled_still_counts():
    rec = StepRecorder(capacity=8, enabled=False)
    rec.record("tick")
    rec.record("tock")
    assert len(rec) == 0
    assert rec.counts() == {"tick": 1, "tock": 1}


def test_recorder_jsonl_matches_reference(tmp_path):
    """The same events give the same JSON lines as the reference's
    recorder (but the wall time), host/pid tags included."""
    recs = [StepRecorder(host="h", pid=7), jtel.StepRecorder(host="h", pid=7)]
    for rec in recs:
        rec.record("capacity_grow", old=8, new=16)
        rec.record_at("redistribute", 12.5, call=0)
    paths = [tmp_path / "t.jsonl", tmp_path / "j.jsonl"]
    for rec, path in zip(recs, paths):
        assert rec.to_jsonl(str(path)) == 2
    lines = [[json.loads(x) for x in p.read_text().splitlines()]
             for p in paths]
    for a, b in zip(*lines):
        a.pop("time"), b.pop("time")
        assert a == b
    assert lines[0][0]["kind"] == "capacity_grow"
    assert lines[0][0]["host"] == "h" and lines[0][0]["pid"] == 7
    assert lines[0][1]["seq"] > lines[0][0]["seq"]
    assert recs[0].dumps_jsonl().count("\n") == 2


def test_step_context_rides_the_envelope():
    rec = StepRecorder()
    assert current() is None
    with scoped(call=3):
        ctx = current()
        rec.record("redistribute", call=3)
        with scoped(step=9):
            assert current().trace == ctx.trace
            rec.record("alert", ctx_call=99)  # payload keys win
    assert current() is None
    e0, e1 = rec.events()
    assert e0.data["ctx_call"] == 3 and e0.data["trace"] == ctx.trace
    assert e1.data["ctx_step"] == 9 and e1.data["ctx_call"] == 99
    c = StepContext(trace="abc", step=1)
    with pytest.raises(AttributeError):
        c.step = 2
    assert c.child(step=None).step is None and c.child().trace == "abc"


def _migrate_stats(S, R, sent=2, pop=100, device="cpu"):
    full = lambda v: torch.full((S, R), v, dtype=torch.int32, device=device)
    return MigrateStats(sent=full(sent), received=full(sent),
                        population=full(pop), backlog=full(0),
                        dropped_recv=full(0))


def test_record_migrate_steps_bridges_stacked_stats():
    S, R = 3, 4
    stats = _migrate_stats(S, R)
    rec = StepRecorder()
    assert record_migrate_steps(rec, stats) == S
    evs = rec.events("migrate_step")
    assert [e.data["step"] for e in evs] == [0, 1, 2]
    assert all(e.data["sent"] == 2 * R for e in evs)
    rec2 = StepRecorder()
    assert record_migrate_steps(rec2, stats, max_steps=1) == 1
    assert rec2.last("migrate_step").data["step"] == S - 1


def test_step_readers_match_reference():
    """record_migrate_steps / record_fast_path_steps / record_chunk_steps
    on tensors give the reference's events on the same numbers."""
    r = np.random.default_rng(4)
    S, R = 5, 8
    leaves = {k: r.integers(0, 50, (S, R)).astype(np.int32)
              for k in ("sent", "received", "population", "backlog",
                        "dropped_recv")}
    fp = r.integers(0, 2, (S, R)).astype(np.int32)
    from mpi_grid_redistribute_tpu.parallel.migrate import (
        MigrateStats as JStats,
    )

    jst = JStats(**leaves, fast_path=fp)
    tst = MigrateStats(**{k: torch.from_numpy(v) for k, v in leaves.items()},
                       fast_path=torch.from_numpy(fp))
    t, j = StepRecorder(), jtel.StepRecorder()
    for rec, st, mod in ((t, tst, None), (j, jst, jtel)):
        fns = (mod or __import__(
            "mpi_grid_redistribute_tpu_torch.telemetry",
            fromlist=["x"]))
        fns.record_migrate_steps(rec, st, rank_totals=True, max_steps=4)
        fns.record_fast_path_steps(rec, st, mover_cap=64)
        fns.record_chunk_steps(rec, 7, 0.25, [0, 3])
    assert _journal(t) == _journal(j)
    from mpi_grid_redistribute_tpu_torch.telemetry import fast_path_hit_rate

    assert fast_path_hit_rate(t) == jtel.fast_path_hit_rate(j)
    assert record_chunk_steps(StepRecorder(), 0, 1.0, []) == 0
    with pytest.raises(ValueError, match="fast_path is None"):
        record_fast_path_steps(StepRecorder(), tst._replace(fast_path=None))
    with pytest.raises(ValueError, match="shape-congruent"):
        record_migrate_steps(StepRecorder(), tst._replace(
            backlog=torch.zeros((1, 3), dtype=torch.int32)))


# ------------------------------------------------------------- report math


def test_roofs_are_the_h100s():
    assert profiling.HBM_PEAK_BYTES_PER_SEC == HBM
    assert profiling.NVLINK_BYTES_PER_SEC == NVLINK
    assert profiling.exchange_peak_bytes_per_sec("hbm") == HBM
    assert profiling.exchange_peak_bytes_per_sec("nvlink") == NVLINK
    assert profiling.exchange_bw_util(HBM / 2, "hbm") == 0.5
    assert profiling.exchange_bw_util(NVLINK, "nvlink", n_chips=4) == 0.25
    with pytest.raises(ValueError, match="ici"):
        profiling.exchange_peak_bytes_per_sec("ici")


def test_row_bytes_of():
    pos = np.zeros((10, 3), np.float32)
    ids = np.zeros((10,), np.int32)
    vel = torch.zeros((10, 3), dtype=torch.float64)
    assert row_bytes_of(pos) == 12
    assert row_bytes_of(pos, vel, ids) == 40
    assert row_bytes_of(torch.zeros((4, 2), dtype=torch.int16)) == 4


def _stats_2rank():
    # rank 0 keeps 3 and moves 1; rank 1 moves 2 and keeps 4
    send = torch.tensor([[3, 1], [2, 4]], dtype=torch.int32)
    return RedistributeStats(
        send_counts=send, recv_counts=send.T.contiguous(),
        dropped_send=torch.zeros(2, dtype=torch.int32),
        dropped_recv=torch.zeros(2, dtype=torch.int32),
        needed_capacity=torch.full((2,), 4, dtype=torch.int32),
    )


def test_exchange_report_hand_math_hbm():
    row_bytes = 28
    rep = exchange_report(_stats_2rank(), row_bytes, step_seconds=0.01,
                          domain="hbm")
    # 10 rows in all, 3 moved off the diagonal; on one card every row
    # crosses HBM (gather and scatter)
    assert rep["exchange_bytes_per_step"] == 10 * row_bytes
    assert rep["moved_bytes_per_step"] == 3 * row_bytes
    bps = 10 * row_bytes / 0.01
    assert rep["exchange_bytes_per_sec"] == pytest.approx(bps)
    assert rep["exchange_gb_per_sec"] == pytest.approx(bps / 1e9)
    assert rep["bw_util"] == pytest.approx(bps / HBM)
    assert rep["kind"] == "redistribute"
    assert rep["stats"]["dropped_send"] == 0
    assert rep["links"]["link_roof_bytes_per_sec"] == HBM
    json.dumps(rep)
    assert "MB/step" in format_report(rep)


def test_exchange_report_hand_math_nvlink():
    row_bytes = 28
    rep = exchange_report(_stats_2rank(), row_bytes, step_seconds=0.01,
                          domain="nvlink", n_chips=2)
    # across cards only the moved rows ride the wire; the roof is a card's
    bps = 3 * row_bytes / 0.01
    assert rep["exchange_bytes_per_sec"] == pytest.approx(bps)
    assert rep["bw_util"] == pytest.approx(bps / 2 / NVLINK)
    link = rep["links"]["links"][0]
    assert (link["src"], link["dst"]) == (1, 0)
    assert link["bw_util"] == pytest.approx(2 * row_bytes / 0.01 / NVLINK)


def test_exchange_report_matches_reference_but_the_roofs():
    """The same stats give the reference's report, but for the fields a
    roof divides (checked above by hand)."""
    from mpi_grid_redistribute_tpu.parallel.exchange import (
        RedistributeStats as JStats,
    )

    st = _stats_2rank()
    jst = JStats(**{k: v.numpy() for k, v in st._asdict().items()
                    if v is not None})
    got = exchange_report(st, 28, step_seconds=0.01, domain="hbm")
    want = jtel.exchange_report(jst, 28, step_seconds=0.01, domain="hbm")
    for rep in (got, want):
        rep.pop("bw_util")
        rep["links"].pop("link_roof_bytes_per_sec")
        for link in rep["links"]["links"]:
            link.pop("bw_util")
    assert got == want


def test_exchange_report_without_step_seconds():
    rep = exchange_report(_stats_2rank(), 28)
    assert rep["exchange_bytes_per_sec"] is None
    assert rep["bw_util"] is None
    assert rep["exchange_bytes_per_step"] == 280
    assert "pass step_seconds" in format_report(rep)


def test_exchange_report_migrate_stats():
    S, R = 2, 4
    stats = _migrate_stats(S, R, sent=5, pop=50)
    rep = exchange_report(stats, 28, step_seconds=0.001)
    assert rep["kind"] == "migrate"
    # MigrateStats.sent counts movers only: total == moved
    assert rep["exchange_bytes_per_step"] == 5 * R * 28
    assert rep["moved_bytes_per_step"] == rep["exchange_bytes_per_step"]
    assert "links" not in rep  # no flow leaf: the section is omitted


# ------------------------------------------------------- phase attribution


def test_attribute_phases_orders_and_rooflines():
    """Each op goes to the innermost listed span open at its launch: an
    unlisted span inside a listed one is the listed one's, an op outside
    every listed span is the rest's, and the rows, a step each, add up
    to the call."""
    def loop(x):
        for _ in range(2):  # 2 steps
            with span("t:a"):
                x = x * 1.000001 + 1e-9
                with span("t:unlisted"):
                    x = x * 1.000001
            with span("t:b"):
                for _ in range(3):
                    x = x * 1.000001 + 1e-9
            x = x + 1e-9  # the rest
        return x

    x = torch.ones((64, 64))
    pb = {"t:a": 1000, "t:b": 2000}
    rows = attribute_phases(loop, (x,), ["t:a", "t:b"], steps=2,
                            phase_bytes=pb, device="cpu")
    assert [r.phase for r in rows] == ["t:a", "t:b", "rest"]
    assert all(r.delta_s > 0 for r in rows)
    assert rows[1].cumulative_s == pytest.approx(
        rows[0].delta_s + rows[1].delta_s)
    assert rows[0].logical_bytes == 1000
    assert rows[0].roofline_s == pytest.approx(1000 / HBM)
    assert rows[2].logical_bytes is None and rows[2].x_roofline is None
    # only what the whole span launched counts as the rest
    rows = attribute_phases(loop, (x,), ["t:a"], whole="t:b", steps=2,
                            device="cpu")
    assert [r.phase for r in rows] == ["t:a", "rest"]
    assert rows[1].delta_s > 0
    table = format_phase_table(rows)
    assert table.splitlines()[0].startswith("| span | ms | cumulative")
    assert len(table.splitlines()) == 2 + len(rows)


def test_spans_and_profiler_session(tmp_path, monkeypatch):
    """Spans are torch.profiler ranges; a session writes a Chrome trace
    that holds them and journals itself; no directory, no session."""
    monkeypatch.delenv("GRID_PROFILE_DIR", raising=False)
    assert profile_dir_from_env() is None
    off = ProfilerSession(recorder=StepRecorder())
    with off:
        pass
    assert not off.enabled and off.recorder.counts() == {}
    rec = StepRecorder()
    monkeypatch.setenv("GRID_PROFILE_DIR", str(tmp_path))
    with ProfilerSession(recorder=rec, label="run") as sess:
        with span("rd:exchange"):
            with traced_span("rd:bin"):
                torch.ones(8).sum()
    assert sess.armed and sess.error is None
    trace = json.loads(open(sess.trace_path).read())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"rd:exchange", "rd:bin"} <= names
    ev = rec.last("profile_session")
    assert ev.data["armed"] is True and ev.data["label"] == "run"
    assert ev.data["trace_dir"] == str(tmp_path)


# --------------------------------------------------- the API's journal


def test_report_before_any_call_raises():
    rd = tgr.GridRedistribute(TDOM, (2, 2, 2), device="cpu")
    with pytest.raises(RuntimeError, match="report"):
        rd.report()
    with pytest.raises(RuntimeError, match="flow"):
        rd.flow()


def test_recorder_events_from_the_grow_path():
    rng = np.random.default_rng(3)
    pos = rng.random((512, 3), dtype=np.float32)
    with tgr.GridRedistribute(TDOM, (2, 2, 2), capacity=2, device="cpu",
                              on_overflow="grow") as rd:
        res = rd.redistribute(pos)
        assert int(res.count.sum()) == 512
        counts = rd.telemetry.counts()
        # a per-pair capacity of 2 cannot carry ~512/8 rows a pair
        assert counts.get("capacity_grow", 0) >= 1
        assert counts.get("redistribute", 0) >= 1
        grow = rd.telemetry.last("capacity_grow")
        assert grow.data["new"] > grow.data["old"]
        assert grow.data["needed"] > 2
        rep = rd.report()
        assert rep["kind"] == "redistribute"
        assert rep["exchange_bytes_per_step"] > 0
        assert rep["bw_util"] is None
        rep2 = rd.report(step_seconds=1e-3)
        assert rep2["bw_util"] == pytest.approx(
            rep2["exchange_bytes_per_step"] / 1e-3 / HBM)
        assert rep2["events"]["capacity_grow"] == counts["capacity_grow"]
        assert rep2["unresolved_windows"] is False
        assert rep2["exchange_domain"] == "hbm" and rep2["n_chips"] == 1


GRID = (4, 2, 2)
N_LOCAL = 64
ENGINES = [("auto", {}), ("planar", {}), ("rowmajor", {}), ("sparse", {}),
           ("neighbor", {}), ("hierarchical", dict(dcn_shape=(2, 1, 1)))]


def _inputs(seed, skew):
    r = np.random.default_rng(seed)
    n = 16 * N_LOCAL
    pos = (r.random((n, 3)) ** skew).astype(np.float32)
    vel = r.standard_normal((n, 3)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    return pos, vel, ids


def _drive(mod, backend_kw, engine, extra):
    """One seeded sequence; returns the instances and what they gave."""
    out = {}
    g = mod.GridRedistribute(
        mod.Domain(0.0, 1.0, periodic=True), GRID, engine=engine,
        capacity_factor=0.5, check_every=2, on_overflow="grow",
        **backend_kw, **extra)
    errors = []
    res = None
    for call, skew in enumerate((1.0, 1.0, 1.0, 1.0, 1.0, 4.0, 1.0, 1.0)):
        try:
            res = g.redistribute(*_inputs(call, skew))
        except RuntimeError as e:  # the deferred window's loss
            errors.append((call, str(e)[:40]))
    try:
        g.flush_overflow_checks()
    except RuntimeError as e:
        errors.append(("flush", str(e)[:40]))
    out["errors"] = errors
    out["halo"] = g.halo(res.positions, *res.fields, width=0.05,
                         count=res.count, headroom=0.05)
    out["report"] = g.report(step_seconds=1e-3)
    out["flow"] = g.flow(k=3)
    out["health"] = g.health()
    out["metrics"] = g.metrics(render=True)
    ig = mod.GridRedistribute(
        mod.Domain(0.0, 1.0, periodic=True), GRID, engine=engine,
        capacity=2, out_capacity=N_LOCAL, on_overflow="ignore",
        **backend_kw, **extra)
    ig.redistribute(*_inputs(11, 3.0))
    out["ignore_report"] = ig.report(step_seconds=1e-3)
    out["ignore_flow"] = ig.flow()
    out["ignore_health"] = ig.health()
    out["ignore_metrics"] = ig.metrics(render=True)
    return g, ig, out


def _strip_roofs(rep):
    """A report without the fields a roof divides; returns them."""
    rep = json.loads(json.dumps(rep, default=int))
    roofs = {"bw_util": rep.pop("bw_util")}
    links = rep.get("links")
    if links:
        roofs["link_roof"] = links.pop("link_roof_bytes_per_sec")
        roofs["link_utils"] = [x.pop("bw_util") for x in links["links"]]
    return rep, roofs


@pytest.mark.parametrize("engine,extra", ENGINES, ids=[e for e, _ in ENGINES])
def test_api_telemetry_matches_reference(engine, extra):
    tg, tig, got = _drive(tgr, dict(device="cpu"), engine, extra)
    jg, jig, want = _drive(jgr, dict(backend="jax"), engine, extra)
    assert jg._vranks and jig._vranks
    assert got["errors"] == want["errors"]
    counts = tg.telemetry.counts()
    # the sequence reached every lifecycle event it is built to reach
    for kind in ("redistribute", "capacity_grow", "engine_resolved",
                 "overflow_window_scheduled", "overflow_window_clean",
                 "overflow_window_loss", "halo", "halo_grow",
                 "flow_snapshot", "alert"):
        assert counts.get(kind, 0) >= 1, (kind, counts)
    assert got["errors"] and got["health"]["status"] == "ALERT"
    if engine in ("sparse", "neighbor", "hierarchical"):
        assert counts.get("mover_cap_grow", 0) >= 1, counts
    if engine == "hierarchical":
        assert counts.get("cross_cap_grow", 0) >= 1, counts
    assert _journal(tg.telemetry) == _journal(jg.telemetry)
    assert tg.telemetry.counts() == jg.telemetry.counts()
    assert _journal(tig.telemetry) == _journal(jig.telemetry)
    for key in ("report", "ignore_report"):
        g, g_roofs = _strip_roofs(got[key])
        w, _ = _strip_roofs(want[key])
        assert g == w, key
        # the roofs are the card's: HBM3 on one device
        assert g["exchange_domain"] == "hbm"
        bps = g["exchange_bytes_per_sec"]
        assert g_roofs["bw_util"] == pytest.approx(bps / HBM)
        assert g_roofs["link_roof"] == HBM
        for link, util in zip(g["links"]["links"], g_roofs["link_utils"]):
            assert util == pytest.approx(link["bytes_per_sec"] / HBM)
    assert got["ignore_report"]["stats"]["dropped_send"] > 0
    for key in ("flow", "ignore_flow"):
        for f in ("matrix", "cumulative"):
            np.testing.assert_array_equal(got[key][f],
                                          np.asarray(want[key][f]))
        assert got[key]["hot_links"] == want[key]["hot_links"]
        assert got[key]["snapshot"] == want[key]["snapshot"]
        assert got[key]["imbalance"] == want[key]["imbalance"]
    for key in ("health", "ignore_health"):
        assert got[key] == want[key]
    for key in ("metrics", "ignore_metrics"):
        assert got[key] == want[key]
    h, wh = got["halo"], want["halo"]
    np.testing.assert_array_equal(h.ghost_count.numpy(),
                                  np.asarray(wh.ghost_count))
