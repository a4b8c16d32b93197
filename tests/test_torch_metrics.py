"""The port's metrics plane (telemetry/metrics.py), the JAX package's
``tests/test_metrics.py`` on the port:

* registry: Counter/Gauge/Histogram semantics (pow2 bucket edges, exact
  edge placement, label validation, reserved suffixes) by hand math;
* exposition: ``render_openmetrics`` survives a STRICT hand-written
  OpenMetrics parser (every sample in a declared family, counters end
  ``_total``, buckets cumulative and non-decreasing, ``+Inf`` equal to
  ``_count``, one trailing ``# EOF``), and renders the reference's text
  on the same journal;
* exactness: ``grid_journal_events`` equals the recorder's all-time
  counts after ring eviction;
* purity: the scrape path (metrics.py, context.py) loads on its own
  without torch, numpy or jax entering ``sys.modules``."""

import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from mpi_grid_redistribute_tpu import telemetry as jtel
from mpi_grid_redistribute_tpu_torch.telemetry import (
    MetricsRegistry,
    StepRecorder,
    from_journal,
    pow2_edges,
    render_openmetrics,
)
from mpi_grid_redistribute_tpu_torch.telemetry import metrics as metrics_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TELEMETRY = os.path.join(ROOT, "mpi_grid_redistribute_tpu_torch",
                         "telemetry")


# ------------------------------------------------------------ hand math


def test_pow2_edges_hand_math():
    assert pow2_edges(0, 3) == (1.0, 2.0, 4.0, 8.0)
    assert pow2_edges(-2, 1) == (0.25, 0.5, 1.0, 2.0)
    edges = pow2_edges(-14, 4)
    assert len(edges) == 19
    assert edges[0] == 2.0 ** -14 and edges[-1] == 16.0
    with pytest.raises(ValueError):
        pow2_edges(3, 1)


def test_counter_and_gauge_hand_math():
    reg = MetricsRegistry()
    c = reg.counter("hits", "hand-math counter", labelnames=("kind",))
    c.labels(kind="a").inc()
    c.labels(kind="a").inc(2.5)
    c.labels(kind="b").inc(0)
    assert c.labels(kind="a").value == 3.5
    assert c.labels(kind="b").value == 0
    with pytest.raises(ValueError):
        c.labels(kind="a").inc(-1)
    g = reg.gauge("depth", "hand-math gauge")
    g.labels().set(7)
    g.labels().inc(3)
    g.labels().dec(2.5)
    assert g.labels().value == 7.5


def test_histogram_bucket_hand_math():
    reg = MetricsRegistry()
    h = reg.histogram("lat", "hand-math histogram", edges=pow2_edges(0, 3))
    child = h.labels()
    for v in (0.5, 1.0, 2.0, 3.0, 8.0, 100.0):  # le is inclusive
        child.observe(v)
    cum = child.cumulative()
    assert [le for le, _ in cum] == [1.0, 2.0, 4.0, 8.0, math.inf]
    assert [n for _, n in cum] == [2, 3, 4, 5, 6]
    assert child.count == 6
    assert child.sum == pytest.approx(114.5)
    with pytest.raises(ValueError, match="increase"):
        reg.histogram("bad", "x", edges=(2.0, 1.0))
    with pytest.raises(ValueError, match="edges"):
        reg.histogram("lat", "x", edges=(1.0, 4.0))


def test_histogram_quantile_hand_math():
    h = metrics_lib.Histogram((), pow2_edges(0, 3))  # edges 1, 2, 4, 8
    with pytest.raises(ValueError, match="quantile"):
        h.quantile(0.0)
    with pytest.raises(ValueError, match="quantile"):
        h.quantile(1.5)
    assert h.quantile(0.99) == 0.0  # empty
    for v in (0.5, 1.0, 3.0, 8.0):
        h.observe(v)
    assert h.quantile(0.5) == 1.0
    assert h.quantile(0.75) == 4.0
    assert h.quantile(1.0) == 8.0
    h.observe(100.0)  # the overflow bucket
    assert h.quantile(1.0) == math.inf
    assert h.quantile(0.8) == 8.0


def test_dropped_edges_zero_bucket_keeps_p99_of_zeros_zero():
    assert metrics_lib.DROPPED_EDGES[0] == 0.0
    h = metrics_lib.Histogram((), metrics_lib.DROPPED_EDGES)
    for _ in range(100):
        h.observe(0)
    assert h.quantile(0.99) == 0.0
    h.observe(3)
    assert h.quantile(1.0) == 4.0


def test_family_shape_and_label_validation():
    reg = MetricsRegistry()
    c = reg.counter("ops", "ops", labelnames=("kind",))
    assert reg.counter("ops", "ops", labelnames=("kind",)) is c
    with pytest.raises(ValueError):
        reg.counter("ops", "ops", labelnames=("other",))
    with pytest.raises(ValueError):
        reg.gauge("ops", "ops")
    with pytest.raises(ValueError):
        c.labels(wrong="x")
    with pytest.raises(ValueError):
        c.labels()
    for bad in ("x_total", "x_bucket", "x_sum", "x_count", "x_created"):
        with pytest.raises(ValueError):
            reg.counter(bad, "reserved")
    with pytest.raises(ValueError):
        reg.counter("0bad", "bad name")
    with pytest.raises(ValueError):
        metrics_lib.Family("g", "gauge", "x", edges=(1.0,))
    with pytest.raises(ValueError):
        metrics_lib.Family("s", "summary", "x")


def _mixed_recorder(mod):
    rec = mod.StepRecorder(host="h0", pid=7)
    rec.record("migrate_step", step=0, sent=5, received=5, backlog=2,
               dropped_recv=0, population=100)
    rec.record("migrate_step", step=1, sent=3, received=3, backlog=1,
               dropped_recv=1, population=100)
    rec.record("step_time", seconds=0.004)
    rec.record("step_time", seconds=0.006)
    rec.record("fast_path", step=0, taken=1, movers=12, movers_max_rank=4)
    rec.record("fast_path", step=1, taken=0, movers=900, movers_max_rank=300)
    rec.record("alert", rule="backlog_growth", severity="warn", reason="x")
    rec.record("capacity_grow", which="send", old=10, new=20, needed=15,
               dropped=0, call=1)
    rec.record("mover_cap_grow", old=64, new=128, peak_movers=90)
    rec.record("redistribute", call=1, n_local=8, capacity=4,
               out_capacity=8, engine="sparse", wire_bytes=448)
    rec.record("flow_snapshot", steps=2, n_ranks=8, moved_rows_total=42,
               imbalance=1.25, population=[20, 12, 10, 8, 2, 0, 28, 20],
               top_pairs=[[0, 1, 30]])
    rec.record("profile_session", trace_dir="d", label="x", duration_s=1.0,
               armed=True, error=None)
    rec.record("state_health", step=3, nan_pos=1, nan_vel=2, oob=4,
               live=90, residual=-1)
    return rec


def _mixed():
    from mpi_grid_redistribute_tpu_torch import telemetry as ttel

    return _mixed_recorder(ttel)


def test_from_journal_hand_math():
    reg = from_journal(_mixed())

    def val(name, **labels):
        return reg.get(name).labels(**labels).value

    assert val("grid_journal_events", kind="migrate_step") == 2
    assert val("grid_journal_events", kind="alert") == 1
    assert val("grid_journal_evicted_events") == 0
    assert val("grid_migrate_rows", direction="sent") == 8
    assert val("grid_migrate_rows", direction="received") == 8
    assert val("grid_migrate_rows", direction="backlog") == 3
    assert val("grid_migrate_rows", direction="dropped_recv") == 1
    assert val("grid_population_rows") == 100
    assert val("grid_backlog_rows") == 1
    assert val("grid_fast_path_steps", taken="1") == 1
    assert val("grid_fast_path_steps", taken="0") == 1
    assert val("grid_capacity_rows", which="send") == 20
    assert val("grid_capacity_rows", which="mover") == 128
    assert val("grid_exchange_wire_bytes", engine="sparse") == 448
    assert val("grid_alerts", rule="backlog_growth", severity="warn") == 1
    assert val("grid_flow_moved_rows") == 42
    assert val("grid_flow_imbalance") == 1.25
    assert val("grid_rank_population", vrank="0") == 20
    assert val("grid_rank_population", vrank="6") == 28
    assert len(reg.get("grid_rank_population").children()) == 8
    assert val("grid_profile_sessions") == 1
    assert val("grid_state_nan", field="vel") == 2
    assert val("grid_state_oob") == 4
    assert val("grid_state_residual") == -1
    st = reg.get("grid_step_time_seconds").labels()
    assert st.count == 2 and st.sum == pytest.approx(0.010)
    mv = reg.get("grid_movers_per_step").labels()
    assert mv.count == 2 and mv.sum == 912
    cum = dict(st.cumulative())
    assert cum[2.0 ** -8] == 0 and cum[2.0 ** -7] == 2


def test_from_journal_service_slo_families():
    rec = StepRecorder(host="h0", pid=7)
    rec.record("step_latency", step=1, seconds=0.004, dropped=0)
    rec.record("step_latency", step=2, seconds=0.006, dropped=5)
    rec.record("restore", what="state", step=4, path="p",
               snapshots_skipped=2)
    rec.record("restore", what="journal", path="p")
    reg = from_journal(rec)
    lat = reg.get("grid_step_latency_seconds").labels()
    assert lat.count == 2 and lat.sum == pytest.approx(0.010)
    drop = reg.get("grid_dropped_rows").labels()
    assert drop.count == 2
    assert dict(drop.cumulative())[0.0] == 1
    assert drop.quantile(1.0) == 8.0
    assert reg.get("grid_snapshot_corrupt").labels().value == 2
    text = reg.render_openmetrics()
    assert 'grid_dropped_rows_bucket{le="0"} 1' in text
    assert "grid_snapshot_corrupt_total 2" in text
    assert "grid_step_latency_seconds_count 2" in text


def test_journal_counters_exact_after_ring_eviction():
    rec = StepRecorder(capacity=4, host="h0", pid=1)
    for s in range(10):
        rec.record("migrate_step", step=s, sent=1, received=1, backlog=0,
                   dropped_recv=0, population=8)
    assert len(rec.events()) == 4
    reg = from_journal(rec)
    assert reg.get("grid_journal_events").labels(
        kind="migrate_step").value == 10
    assert reg.get("grid_journal_evicted_events").labels().value == 6
    assert rec.counts() == {"migrate_step": 10}
    # the decoded JSON Lines replay the same way (counted from the stream)
    import json

    rows = [json.loads(x) for x in rec.dumps_jsonl().splitlines()]
    reg2 = MetricsRegistry.from_journal(rows)
    assert reg2.get("grid_journal_events").labels(
        kind="migrate_step").value == 4


# ------------------------------------------- strict OpenMetrics parser

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_][a-zA-Z0-9_]*)"
    r"(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\",?)*)\})?"
    r" (\S+)$"
)
_LABEL_RE = re.compile(r"([a-zA-Z_][a-zA-Z0-9_]*)=\"((?:[^\"\\]|\\.)*)\"")


def _parse_openmetrics(text):
    """Strict hand parser: ``{family: type}`` and ``{family: {sample:
    {labels: value}}}``; any violation is an AssertionError."""
    lines = text.splitlines()
    assert lines and lines[-1] == "# EOF", "must terminate with # EOF"
    assert sum(1 for x in lines if x == "# EOF") == 1
    families, helped, samples = {}, set(), {}
    for line in lines[:-1]:
        assert line and not line.isspace(), "no blank lines"
        if line.startswith("# TYPE "):
            _, _, name, mtype = line.split(" ", 3)
            assert name not in families, f"duplicate TYPE for {name}"
            assert mtype in ("counter", "gauge", "histogram"), mtype
            families[name] = mtype
            samples[name] = {}
            continue
        if line.startswith("# HELP "):
            name = line.split(" ", 3)[2]
            assert name in families, f"HELP before TYPE for {name}"
            helped.add(name)
            continue
        assert not line.startswith("#"), f"unknown comment: {line}"
        m = _SAMPLE_RE.match(line)
        assert m, f"unparseable sample line: {line!r}"
        sname, labelstr, value = m.group(1), m.group(2) or "", m.group(3)
        fval = float(value)
        fam = None
        for base, mtype in families.items():
            expect = {
                "counter": (base + "_total",),
                "gauge": (base,),
                "histogram": (base + "_bucket", base + "_sum",
                              base + "_count"),
            }[mtype]
            if sname in expect:
                fam = base
        assert fam is not None, f"sample {sname} belongs to no family"
        labels = dict(_LABEL_RE.findall(labelstr))
        key = tuple(sorted(labels.items()))
        assert key not in samples[fam].get(sname, {}), (
            f"duplicate sample {sname}{labels}")
        samples[fam].setdefault(sname, {})[key] = fval
    assert helped == set(families), "every family needs a HELP line"
    for base, mtype in families.items():
        if mtype != "histogram":
            continue
        series = {}
        for key, v in samples[base].get(base + "_bucket", {}).items():
            rest = tuple((k, x) for k, x in key if k != "le")
            series.setdefault(rest, []).append((dict(key)["le"], v))
        for rest, pts in series.items():
            les = [le for le, _ in pts]
            assert les[-1] == "+Inf", "last bucket must be +Inf"
            nums = [float(le) for le in les[:-1]]
            assert nums == sorted(nums), "le values must ascend"
            vals = [v for _, v in pts]
            assert vals == sorted(vals), "bucket counts must be cumulative"
            assert vals[-1] == samples[base][base + "_count"][rest]
    return families, samples


def test_render_openmetrics_passes_strict_parser():
    text = render_openmetrics(from_journal(_mixed()))
    families, samples = _parse_openmetrics(text)
    assert families["grid_journal_events"] == "counter"
    assert families["grid_step_time_seconds"] == "histogram"
    assert families["grid_population_rows"] == "gauge"
    key = (("kind", "migrate_step"),)
    assert samples["grid_journal_events"]["grid_journal_events_total"][
        key] == 2
    assert samples["grid_flow_moved_rows"]
    text2 = from_journal(StepRecorder(host="h", pid=1)).render_openmetrics()
    _, samp2 = _parse_openmetrics(text2)
    assert samp2["grid_flow_moved_rows"] == {}
    assert samp2["grid_population_rows"] == {}
    assert samp2["grid_rank_population"] == {}


def test_rendered_text_is_the_references():
    """The same journal renders the reference's OpenMetrics text, byte
    for byte."""
    got = from_journal(_mixed()).render_openmetrics()
    want = jtel.from_journal(_mixed_recorder(jtel)).render_openmetrics()
    assert got == want


def test_rank_population_latest_snapshot_wins():
    rec = StepRecorder(host="h", pid=1)
    rec.record("flow_snapshot", steps=1, n_ranks=4, moved_rows_total=0,
               imbalance=2.0, population=[8, 0, 0, 0], top_pairs=[])
    rec.record("flow_snapshot", steps=2, n_ranks=2, moved_rows_total=3,
               imbalance=1.0, population=[4, 4], top_pairs=[])
    fam = from_journal(rec).get("grid_rank_population")
    assert len(fam.children()) == 2
    assert fam.labels(vrank="0").value == 4
    assert fam.labels(vrank="1").value == 4
    rec.record("flow_snapshot", steps=3, n_ranks=2, moved_rows_total=3,
               imbalance=1.0, population=None, top_pairs=[])
    assert len(from_journal(rec).get("grid_rank_population").children()) == 2


def test_label_value_escaping_round_trips():
    reg = MetricsRegistry()
    c = reg.counter("odd", "escape check", labelnames=("reason",))
    c.labels(reason='a"b\\c\nd').inc()
    text = reg.render_openmetrics()
    assert '\\"' in text and "\\\\" in text and "\\n" in text
    _, samples = _parse_openmetrics(text)
    (key,) = samples["odd"]["odd_total"]
    assert dict(key)["reason"] == 'a\\"b\\\\c\\nd'


def test_api_metrics_after_eviction_are_exact():
    """``rd.metrics()``: its counters come from the all-time counts, exact
    after the instance's ring wrapped, and it renders the parser's text."""
    import mpi_grid_redistribute_tpu_torch as tgr

    rd = tgr.GridRedistribute(lo=0.0, hi=1.0, grid=(2, 2, 1), device="cpu",
                              on_overflow="ignore")
    rd.telemetry = StepRecorder(capacity=3)
    pos = np.random.default_rng(2).random((400, 3), dtype=np.float32)
    for _ in range(7):
        rd.redistribute(pos)
    reg = rd.metrics()
    assert reg.get("grid_journal_events").labels(
        kind="redistribute").value == 7
    assert reg.get("grid_journal_evicted_events").labels().value == 5
    _parse_openmetrics(rd.metrics(render=True))


# ------------------------------------------------------------ purity


@pytest.mark.parametrize("module", ["metrics", "context"])
def test_scrape_path_loads_without_torch_numpy_or_jax(module):
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('m', "
        f"{os.path.join(TELEMETRY, module + '.py')!r})\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(m)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'jaxlib')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
