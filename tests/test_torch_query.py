"""The port's pod merge (``telemetry/aggregate.py``) and query plane
(``telemetry/query.py``) against the JAX package's on the CPU, and the
``metrics_serve`` tool.

Journal shards made from a seed with numpy (several hosts and pids, wall
clocks that step backwards, per-rank vectors, flow snapshots, alerts
under a step context) go through both packages' ``merge_journals`` and
``run_query``: the merged rows, counts, pod stats, flow snapshot and
replayed recorders are equal, and so is every query reply (filters,
group-bys, every windowed op, the row cap, the cursor pages), over the
shards, a live recorder and a store. Merge-equals-sum holds for counts.
The ``metrics_serve`` twin answers ``/query``, ``/events``, ``/metrics``,
``/healthz`` and ``/incidents`` over a store on a local port."""

import http.server
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu.telemetry import aggregate as jaggregate
from mpi_grid_redistribute_tpu.telemetry import query as jquery
from mpi_grid_redistribute_tpu.telemetry import store as jstore
from mpi_grid_redistribute_tpu_torch.telemetry import StepRecorder
from mpi_grid_redistribute_tpu_torch.telemetry import aggregate, query
from mpi_grid_redistribute_tpu_torch.telemetry import incident
from mpi_grid_redistribute_tpu_torch.telemetry import store
from mpi_grid_redistribute_tpu_torch.tools import metrics_serve


def _shards(seed, n_shards=3, n_events=60):
    """Decoded journal shards: each a host/pid, its own seq space and a
    wall clock that wobbles (and steps back now and then)."""
    rng = np.random.default_rng(seed)
    shards = []
    for s in range(n_shards):
        host, pid = f"host{s % 2}", 100 + s
        t = 1000.0 + float(rng.uniform(0, 2))
        rows = []
        for seq in range(1, n_events + 1):
            t += float(rng.choice([0.01, 0.05, -0.02]))
            step = seq // 3
            kind = str(rng.choice(["migrate_step", "step_latency", "alert",
                                   "flow_snapshot", "fault_injected"],
                                  p=[0.4, 0.4, 0.08, 0.08, 0.04]))
            row = {"seq": seq, "time": round(t, 6), "kind": kind,
                   "host": host, "pid": pid, "ctx_step": step,
                   "trace": f"tr{s}"}
            if kind == "migrate_step":
                sent = rng.integers(0, 9, 2).tolist()
                row.update(step=step, sent=sum(sent), received=sum(sent),
                           backlog=int(rng.integers(0, 5)), dropped_recv=0,
                           population=64, sent_per_rank=sent,
                           received_per_rank=sent[::-1],
                           population_per_rank=[32, 32])
            elif kind == "step_latency":
                row.update(step=step, seconds=float(rng.uniform(1e-4, 0.1)),
                           dropped=int(rng.integers(0, 2)))
            elif kind == "alert":
                row.update(rule="backlog_growth", severity="ALERT",
                           reason="grew")
            elif kind == "flow_snapshot":
                row.update(n_ranks=2, moved_rows_total=int(
                    rng.integers(0, 100)), imbalance=float(
                    rng.uniform(1, 3)), top_pairs=[[0, 1, 5], [1, 0, 2]])
            else:
                row.update(fault="crash", step=step)
            rows.append(row)
        shards.append(rows)
    return shards


def _write(tmp_path, shards):
    paths = []
    for i, rows in enumerate(shards):
        p = tmp_path / f"shard{i}.jsonl"
        p.write_text("".join(json.dumps(r, sort_keys=True) + "\n"
                             for r in rows))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("align", ["wall", "start"])
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_equals_reference(tmp_path, seed, align):
    paths = _write(tmp_path, _shards(seed))
    want = jaggregate.merge_journals(paths, align=align)
    got = aggregate.merge_journals(paths, align=align)
    assert got.events() == want.events()
    assert got.events("alert") == want.events("alert")
    assert got.counts() == want.counts()
    assert got.per_shard_counts() == want.per_shard_counts()
    # merge-equals-sum: pod totals are the shard totals added
    total = {}
    for rows in _shards(seed):
        for r in rows:
            total[r["kind"]] = total.get(r["kind"], 0) + 1
    assert got.counts() == total
    assert len(got) == sum(total.values())
    ps, pw = got.pod_stats(), want.pod_stats()
    assert ps.steps == pw.steps
    for name in ("sent", "received", "backlog", "dropped_recv",
                 "population"):
        np.testing.assert_array_equal(getattr(ps, name), getattr(pw, name))
    assert got.flow_snapshot(k=3) == want.flow_snapshot(k=3)
    for pod_steps in (False, True):
        a = got.to_recorder(pod_steps=pod_steps)
        b = want.to_recorder(pod_steps=pod_steps)
        assert [(e.seq, e.time, e.kind, e.data) for e in a.events()] == [
            (e.seq, e.time, e.kind, e.data) for e in b.events()]
        assert a.counts() == b.counts()
    # the order within a shard is its seq, whatever its clock did
    for sh in range(3):
        seqs = [e["seq"] for e in got.events() if e["pid"] == 100 + sh]
        assert seqs == sorted(seqs)
    with pytest.raises(ValueError, match="align"):
        aggregate.merge_journals(paths, align="nope")


def test_merge_of_live_recorders():
    """``StepRecorder`` sources merge like their JSONL exports."""
    recs = []
    for h in range(2):
        rec = StepRecorder(host=f"h{h}", pid=h)
        for i in range(5):
            rec.record_at("step_time", 10.0 + i + 0.5 * h, step=i,
                          seconds=0.001)
        recs.append(rec)
    merged = aggregate.merge_journals(recs)
    assert merged.counts() == {"step_time": 10}
    assert [e["host"] for e in merged.events()][:3] == ["h0", "h1", "h0"]


QUERIES = [
    {},
    {"kind": "alert"},
    {"kind": "step_latency,alert", "limit": "7"},
    {"step_min": "4", "step_max": "9"},
    {"trace": "tr1"},
    {"host": "host0", "pid": "100"},
    {"since": "1001.0", "until": "1002.0"},
    {"ctx.step": "5"},
    {"by": "kind"},
    {"by": "host"},
    {"by": "vrank", "kind": "migrate_step"},
    {"agg": "count", "window_s": "0.5"},
    {"agg": "rate", "window_s": "0.25"},
    {"agg": "mean", "field": "seconds", "kind": "step_latency"},
    {"agg": "sum", "field": "sent", "kind": "migrate_step",
     "window_s": "1"},
    {"agg": "min", "field": "seconds", "kind": "step_latency"},
    {"agg": "max", "field": "backlog", "kind": "migrate_step"},
    {"agg": "p50", "kind": "step_latency", "window_s": "1e9"},
    {"agg": "p90", "kind": "step_latency", "window_s": "0.5"},
    {"agg": "p99", "kind": "step_latency", "window_s": "1e9"},
    {"agg": "ema", "field": "seconds", "kind": "step_latency",
     "ema_alpha": "0.3"},
]


@pytest.mark.parametrize("seed", [0, 3])
def test_run_query_equals_reference(tmp_path, seed):
    paths = _write(tmp_path, _shards(seed))
    jsrc = jaggregate.merge_journals(paths)
    tsrc = aggregate.merge_journals(paths)
    for params in QUERIES:
        assert query.run_query(tsrc, dict(params)) == jquery.run_query(
            jsrc, dict(params)), params
    rows_t, rows_j = query.rows_of(tsrc), jquery.rows_of(jsrc)
    assert rows_t == rows_j
    cursor_t = cursor_j = None
    while True:
        pt = query.events_page(rows_t, cursor=cursor_t, limit=17)
        pj = jquery.events_page(rows_j, cursor=cursor_j, limit=17)
        assert pt == pj
        cursor_t, cursor_j = pt["cursor"], pj["cursor"]
        if not pt["events"]:
            break
    for bad in ({"bogus": "1"}, {"step_min": "x"}, {"since": "x"},
                {"limit": "0"}, {"agg": "p12"},
                {"agg": "count", "window_s": "0"}):
        with pytest.raises(query.QueryError) as et:
            query.run_query(tsrc, dict(bad))
        with pytest.raises(jquery.QueryError) as ej:
            jquery.run_query(jsrc, dict(bad))
        assert str(et.value) == str(ej.value)
    with pytest.raises(query.QueryError, match="bad cursor"):
        query.events_page(rows_t, cursor="nocolons")


def _store(root, n=200):
    """A compacted store over a live recorder: raw and summary rows."""
    rec = StepRecorder(capacity=96, host="h0", pid=7)
    st = store.JournalStore(str(root), segment_events=60, compact_after=1,
                            compact_window=16)
    rng = np.random.default_rng(5)
    for i in range(n):
        rec.record("step_latency", step=i, seconds=float(
            rng.uniform(1e-3, 0.05)), dropped=0)
        if i % 25 == 0:
            rec.record("alert", rule="imbalance_ratio", severity="WARN",
                       step=i)
        if i % 10 == 9:
            st.drain(rec)
    st.close(rec)
    return rec, st


def test_query_over_a_store_equals_reference(tmp_path):
    """The same store read by both packages' readers: the same rows and
    replies, the p99 over raw rows and sketches equal to the merged
    histogram's, the window count every step."""
    rec, st = _store(tmp_path / "s")
    treader = store.StoreReader(str(tmp_path / "s"))
    jreader = jstore.StoreReader(str(tmp_path / "s"))
    assert any(r["kind"] == "store_window" for r in treader.events())
    assert query.rows_of(treader) == jquery.rows_of(jreader)
    for params in QUERIES + [{"agg": "p99", "window_s": "1e9",
                              "kind": "step_latency,store_window"}]:
        assert query.run_query(treader, dict(params)) == jquery.run_query(
            jreader, dict(params)), params
    reply = query.run_query(treader, {"agg": "p99", "window_s": "1e9",
                                      "kind": "step_latency,store_window"})
    (window,) = reply["series"]
    assert window["value"] == treader.latency_histogram().quantile(0.99)
    assert window["n"] == 200
    # grouped counts: the compacted steps are inside the windows' counts
    assert query.run_query(treader, {"by": "kind"})["groups"]["alert"] \
        == rec.counts()["alert"]


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read().decode("utf-8")


def test_metrics_serve_answers_over_a_store(tmp_path):
    """``/query``, ``/events`` (a cursor walk to exhaustion, every row
    once), ``/metrics``, ``/healthz`` and ``/incidents`` over a store,
    served on a local port; a bad parameter is a 400."""
    rec, st = _store(tmp_path / "s")
    fr = incident.FlightRecorder(rec, str(tmp_path / "inc"),
                                 clock=lambda: 1.0)
    fr.capture(rule="r", reason="x")
    snapshot, query_snapshot, shutdown = metrics_serve.store_snapshotter(
        str(tmp_path / "s"))
    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), metrics_serve.make_handler(
            snapshot, incident_dir=str(tmp_path / "inc"),
            query_source=query_snapshot))
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        by = json.loads(_get(base + "/query?by=kind")[1])
        assert by["groups"]["alert"] == rec.counts()["alert"]
        assert "store_window" in by["groups"]
        p99 = json.loads(_get(base + "/query?agg=p99&window_s=1e9"
                              "&kind=step_latency,store_window")[1])
        assert p99["series"][0]["value"] == st.reader().latency_histogram(
        ).quantile(0.99)
        seen, cursor = [], ""
        while True:
            page = json.loads(_get(base + f"/events?limit=50&cursor="
                                   f"{cursor}")[1])
            seen.extend(page["events"])
            cursor = page["cursor"]
            if page["remaining"] == 0 and not page["events"]:
                break
        keys = [(r["host"], r["pid"], r["seq"]) for r in seen]
        assert len(keys) == len(set(keys)) == len(st.reader().events())
        status, text = _get(base + "/metrics")
        line = [ln for ln in text.splitlines()
                if ln.startswith("grid_journal_events_total")
                and 'kind="step_latency"' in ln]
        assert float(line[0].rsplit(" ", 1)[1]) == 200.0
        assert text.rstrip().endswith("# EOF")
        status, body = _get(base + "/healthz")
        assert status == 200 and json.loads(body)["status"] in ("OK", "WARN")
        inc = json.loads(_get(base + "/incidents")[1])
        assert [e["id"] for e in inc["incidents"]] == ["incident-0001-r"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/query?bogus=1", timeout=30)
        assert ei.value.code == 400 and b"bogus" in ei.value.read()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/nope", timeout=30)
        assert ei.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        shutdown()


def test_metrics_serve_once_over_journals_and_store(tmp_path, capsys):
    paths = _write(tmp_path, _shards(2))
    argv = []
    for p in paths:
        argv += ["--journal", p]
    assert metrics_serve.main(argv + ["--once"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[-1].startswith("healthz: ")
    assert 'grid_journal_events_total{kind="alert"}' in out
    _store(tmp_path / "s")
    assert metrics_serve.main(["--store", str(tmp_path / "s"),
                               "--once"]) == 0
    assert "# EOF" in capsys.readouterr().out
    assert metrics_serve.main(["--demo", "--device", "cpu", "--once"]) == 0
    assert "healthz: " in capsys.readouterr().out
    if not torch.cuda.is_available():
        # the demo runs on the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            metrics_serve.main(["--demo", "--once"])
    with pytest.raises(SystemExit):
        metrics_serve.main(["--once"])


# ------------------------------------------------------- scrape path

# module -> top-level packages it must load without (aggregate and the
# recorder may use numpy, as the reference's do; nothing here uses torch)
LIGHT = {"store": ("torch", "numpy", "jax"),
         "incident": ("torch", "numpy", "jax"),
         "query": ("torch", "numpy", "jax"),
         "regress": ("torch", "numpy", "jax"),
         "aggregate": ("torch", "jax"),
         "recorder": ("torch", "jax")}


@pytest.mark.parametrize("module", list(LIGHT))
def test_scrape_path_loads_without_torch_or_numpy(module):
    """The module loads on its own (the package ``__init__`` files, which
    import torch, replaced by bare namespaces) and pulls in none of the
    banned packages; a store drain, a capture or a query can never touch
    the device. ``regress.env_fingerprint`` probes torch only when
    called."""
    import os
    import subprocess
    import sys

    import mpi_grid_redistribute_tpu_torch as pkg

    root = os.path.dirname(pkg.__file__)
    code = (
        "import importlib, sys, types\n"
        f"root = {root!r}\n"
        "for name, path in (('mpi_grid_redistribute_tpu_torch', root),\n"
        "        ('mpi_grid_redistribute_tpu_torch.telemetry',\n"
        "         root + '/telemetry')):\n"
        "    m = types.ModuleType(name)\n"
        "    m.__path__ = [path]\n"
        "    sys.modules[name] = m\n"
        "importlib.import_module("
        f"'mpi_grid_redistribute_tpu_torch.telemetry.{module}')\n"
        f"bad = [k for k in sys.modules if k.split('.')[0] in "
        f"{LIGHT[module]!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
