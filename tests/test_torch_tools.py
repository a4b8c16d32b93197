"""The port's tools against the JAX package's scripts: ``trace_export``
and ``grid_top --once`` print the reference's bytes on the same inputs
(both CLIs run as subprocesses); ``grid_top --url`` reads the port's
``metrics_serve``; ``history`` refuses a TPU capture; ``storecheck``
passes on a store the reference wrote and the reference's on one the
port wrote; ``incident_demo --check --device cpu`` and ``attribution
--check`` are clean at HEAD, and ``attribution --check`` fails A001,
A002 or A003 on a perturbed snapshot, a stale ``PERF.md`` table or a
missing program; every entry point raises without a GPU unless asked for
the CPU."""

import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from mpi_grid_redistribute_tpu_torch.telemetry import recorder as trecorder
from mpi_grid_redistribute_tpu_torch.telemetry import store as tstore
from mpi_grid_redistribute_tpu_torch.tools import (
    attribution, history, incident_demo, storecheck,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["TZ"] = "UTC"
    return env


def _ref(script, *args):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", script), *args],
        capture_output=True, text=True, env=_env(), timeout=600)


def _port(tool, *args, pkg="tools"):
    return subprocess.run(
        [sys.executable, "-m", f"mpi_grid_redistribute_tpu_torch.{pkg}.{tool}",
         *args], capture_output=True, text=True, env=_env(), timeout=600)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A store through rotation, compaction and retention, with probe,
    alert, flow and step rows (the port's storecheck demo, kept)."""
    out = tmp_path_factory.mktemp("store")
    findings, _ = storecheck.run_demo(str(out), verbose=False)
    assert findings == []
    return str(out / "store")


# ---------------------------------------------------------- trace_export


def _journal(path):
    rec = trecorder.StepRecorder(host="h0", pid=7)
    for s in range(12):
        rec.record_at("migrate_step", 1000.0 + 0.5 * s, step=s, sent=3 * s,
                      received=3 * s, population=900 + s, backlog=s % 3,
                      dropped_recv=0)
        rec.record_at("step_time", 1000.25 + 0.5 * s, step=s,
                      seconds=0.001 * (s + 1))
    rec.record_at("alert", 1006.0, rule="backlog_growth", severity="ALERT",
                  reason="backlog grew", step=11, cause_step=8)
    rec.record_at("flow_snapshot", 1006.5, imbalance=1.25, steps=12)
    rec.to_jsonl(path)


def _phases(path):
    rows = [{"phase": p, "cumulative_s": 0.001 * i, "delta_s": 0.0005 * i,
             "logical_bytes": 4096 * i if i % 2 else None,
             "roofline_s": 1e-6 * i if i % 2 else None}
            for i, p in enumerate([1, 2, 3, 4], start=1)]
    with open(path, "w") as f:
        json.dump(rows, f)


@pytest.mark.parametrize("sources", [("journal",), ("phases",),
                                     ("journal", "phases")])
def test_trace_export_byte_equal_reference(tmp_path, sources):
    args = []
    if "journal" in sources:
        _journal(str(tmp_path / "j.jsonl"))
        args += ["--journal", str(tmp_path / "j.jsonl")]
    if "phases" in sources:
        _phases(str(tmp_path / "p.json"))
        args += ["--phases", str(tmp_path / "p.json"),
                 "--step-seconds", "0.002"]
    ref = _ref("trace_export.py", *args, "--out", str(tmp_path / "ref.json"))
    port = _port("trace_export", *args, "--out", str(tmp_path / "port.json"))
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert port.returncode == 0, port.stderr[-2000:]
    ref_bytes = (tmp_path / "ref.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == ref_bytes
    assert json.loads(ref_bytes)["traceEvents"]


def test_trace_export_demo_on_the_cpu(tmp_path):
    from mpi_grid_redistribute_tpu_torch.tools import trace_export

    out = tmp_path / "demo.json"
    assert trace_export.main(["--demo", "--device", "cpu", "--steps", "3",
                              "--out", str(out)]) == 0
    events = json.loads(out.read_text())["traceEvents"]
    assert any(e.get("ph") == "C" for e in events)


def test_trace_export_roofline_annotation_reads_the_ports_snapshot(tmp_path):
    from mpi_grid_redistribute_tpu_torch.analysis.baseline import (
        load_attribution_baseline,
    )
    from mpi_grid_redistribute_tpu_torch.tools import trace_export

    doc = load_attribution_baseline()
    _phases(str(tmp_path / "p.json"))
    out = tmp_path / "t.json"
    assert trace_export.main(["--phases", str(tmp_path / "p.json"),
                              "--roofline", "migrate_sparse_vranks",
                              "--out", str(out)]) == 0
    text = out.read_text()
    row = doc["roofline"]["migrate_sparse_vranks"]
    assert str(row["bound_by"]) in text
    with pytest.raises(SystemExit, match="not in the port's attribution"):
        trace_export.main(["--phases", str(tmp_path / "p.json"),
                           "--roofline", "no_such_program", "--out",
                           str(out)])


# -------------------------------------------------------------- grid_top


def test_grid_top_once_byte_equal_reference(store):
    ref = _ref("grid_top.py", "--store", store, "--once")
    port = _port("grid_top", "--store", store, "--once")
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert port.returncode == 0, port.stderr[-2000:]
    assert port.stdout == ref.stdout
    assert "grid-top" in port.stdout and "** CORRUPT **" in port.stdout


def test_grid_top_once_unreadable_source_exits_1(tmp_path):
    port = _port("grid_top", "--store", str(tmp_path / "nothing"), "--once")
    assert port.returncode == 1
    assert "cannot read source" in port.stderr


def test_grid_top_reads_the_ports_metrics_serve(store):
    from mpi_grid_redistribute_tpu_torch.tools import grid_top

    proc = subprocess.Popen(
        [sys.executable, "-m",
         "mpi_grid_redistribute_tpu_torch.tools.metrics_serve", "--store",
         store, "--port", "0"], stdout=subprocess.PIPE, text=True,
        env=_env())
    try:
        line = proc.stdout.readline()
        url = line.split()[1].rsplit("/metrics", 1)[0]
        d = grid_top.collect_url(url)
        screen = grid_top.render(d)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    counts = tstore.StoreReader(store).counts()
    assert d["counts"] == counts
    # the demo store ALERTs: /healthz answers 503, which the reference's
    # collector (and so this one) reads as no health panel
    assert d["health"] is None and d["latency_samples"] > 0
    assert f"events {sum(counts.values())}" in screen
    assert screen.startswith(f"grid-top · {url}")


# --------------------------------------------------------------- history


def _capture(path, value, torch_env=True):
    env = ({"torch": "2.11.0", "cuda": "12.8", "device": "NVIDIA H100",
            "device_count": 1} if torch_env else
           {"jax": "0.4.1", "platform": "tpu", "device": "TPU v5 lite"})
    doc = {"metric": "particles_per_sec", "value": value,
           "ms_per_step": 8e9 / value * 1e3, "env": env,
           "timing_spread": 0.05}
    with open(path, "w") as f:
        json.dump(doc, f)


def test_history_refuses_the_repos_tpu_captures():
    r = _port("history", "--bench", os.path.join(ROOT, "BENCH_r*.json"))
    assert r.returncode == 2
    assert "not the port's" in r.stderr


def test_history_has_no_default_capture_glob():
    r = _port("history", "--json")
    assert r.returncode == 0
    assert json.loads(r.stdout)["benches"] == []


def test_history_indexes_and_checks_the_ports_captures(tmp_path, store):
    for i, v in enumerate((2.5e9, 2.9e9, 2.7e9), start=1):
        _capture(tmp_path / f"cap_r{i:02d}.json", v)
    glob_ = str(tmp_path / "cap_r*.json")
    assert history.main(["--bench", glob_, "--json"]) == 0
    index, benches = history.build_index([glob_], os.path.dirname(store))
    assert [b["rev"] for b in benches] == [1, 2, 3]
    assert all(b["stack"] == "torch" for b in benches)
    assert index["stores"][0]["root"] == store
    text = history.render_trajectory(benches, index["stores"])
    assert "r02" in text and store in text
    _capture(tmp_path / "now.json", 2.8e9)
    assert history.main(["--bench", glob_, "--check",
                         str(tmp_path / "now.json")]) == 0
    _capture(tmp_path / "bad.json", 1.0e9)
    assert history.main(["--bench", glob_, "--check",
                         str(tmp_path / "bad.json")]) == 1
    _capture(tmp_path / "tpu.json", 2.8e9, torch_env=False)
    assert history.main(["--bench", glob_, "--check",
                         str(tmp_path / "tpu.json")]) == 2
    _capture(tmp_path / "cap_r04.json", 2.8e9, torch_env=False)
    assert history.main(["--bench", glob_]) == 2


# ------------------------------------------------------------ storecheck


def test_storecheck_check_is_clean():
    assert storecheck.main(["--check"]) == 0


def test_storecheck_sarif_of_a_clean_run(capsys):
    assert storecheck.main(["--check", "--format=sarif"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["runs"][0]["results"] == []
    assert doc["runs"][0]["tool"]["driver"]["name"] == "storecheck"


def test_storecheck_passes_on_the_references_store(tmp_path):
    keep = tmp_path / "ref"
    r = _ref("storecheck.py", "--keep", str(keep))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    findings, reader = storecheck.check_store(str(keep / "store"))
    assert findings == [] and reader is not None
    assert storecheck.main([str(keep / "store")]) == 0


def test_references_storecheck_passes_on_the_ports_store(store):
    r = _ref("storecheck.py", store)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "storecheck: clean" in r.stdout


def test_storecheck_finds_a_torn_segment(tmp_path, store):
    import shutil

    root = tmp_path / "torn"
    shutil.copytree(store, root)
    seg = tstore.StoreReader(str(root)).manifest["segments"][0]["name"]
    with open(root / seg, "a") as f:
        f.write('{"kind": "forged"}\n')
    findings, _ = storecheck.check_store(str(root))
    assert [f.rule for f in findings][:1] == ["ST01"]
    assert storecheck.main([str(root)]) == 1


# --------------------------------------------------------- incident_demo


def test_incident_demo_check_on_the_cpu_is_clean(capsys):
    assert incident_demo.main(["--check", "--device", "cpu"]) == 0
    assert "incident-demo: clean" in capsys.readouterr().out


def test_incident_demo_finds_and_reports_sarif(tmp_path, capsys):
    findings, entries = incident_demo.run_demo(str(tmp_path), verbose=False,
                                               device="cpu")
    assert findings == []
    assert {e["trigger"] for e in entries} >= {"alert", "fault"}
    assert incident_demo.main(["--check", "--device", "cpu",
                               "--format=sarif"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["runs"][0]["tool"]["driver"]["name"] == "incident-demo"


# ----------------------------------------------------------- attribution


def test_attribution_check_is_clean_at_head(capsys):
    assert attribution.main(["--check"]) == 0
    assert "attribution: clean" in capsys.readouterr().out


def test_attribution_snapshot_names_its_card():
    from mpi_grid_redistribute_tpu_torch.analysis.baseline import (
        load_attribution_baseline,
    )

    dev = load_attribution_baseline()["device"]
    assert dev["name"].startswith("NVIDIA") and dev["power_limit"]


def _doc():
    from mpi_grid_redistribute_tpu_torch.analysis.baseline import (
        load_attribution_baseline,
    )

    return copy.deepcopy(load_attribution_baseline())


def test_attribution_a001_on_perturbed_phases():
    doc = _doc()
    doc["phase_tables"]["migrate"]["phases"] = [1, 2, 3]
    rules = {f.rule for f in attribution.check_findings(doc)}
    assert rules == {"A001"}
    doc = _doc()
    doc["phase_tables"]["pipeline"]["shapes"]["4096"]["rows"].pop()
    assert {f.rule for f in attribution.check_findings(doc)} == {"A001"}
    doc = _doc()
    doc["device"] = {"name": "cpu"}
    assert {f.rule for f in attribution.check_findings(doc)} == {"A001"}


def test_attribution_a002_on_a_stale_perf_table(tmp_path):
    doc = _doc()
    text = open(attribution.PERF_MD, encoding="utf-8").read()
    stale = tmp_path / "PERF.md"
    stale.write_text(text.replace("(first)", "(stale)", 1))
    found = attribution.check_findings(doc, perf_md=str(stale))
    assert [f.rule for f in found] == ["A002"]
    stale.write_text(text.replace("<!-- attribution:roofline:begin -->", ""))
    assert [f.rule for f in attribution.check_findings(
        doc, perf_md=str(stale))] == ["A002"]
    # --render's output is what the gate wants
    fixed = attribution.render_markdown(doc, text.replace(
        "(first)", "(stale)", 1))
    stale.write_text(fixed)
    assert attribution.check_findings(doc, perf_md=str(stale)) == []


def test_attribution_check_without_perf_md(tmp_path):
    # a checkout of the program files alone: A002 has no table to hold,
    # A001 and A003 still fire
    missing = str(tmp_path / "PERF.md")
    assert attribution.check_findings(_doc(), perf_md=missing) == []
    doc = _doc()
    doc["device"] = {"name": "cpu"}
    assert {f.rule for f in attribution.check_findings(
        doc, perf_md=missing)} == {"A001"}


def test_attribution_a003_on_a_missing_program():
    doc = _doc()
    del doc["roofline"]["pipelined_macro_step"]
    found = attribution.check_findings(doc)
    assert [f.rule for f in found] == ["A003"]
    doc = _doc()
    doc["roofline"]["not_a_program"] = dict(doc["roofline"][
        "canonical_planar_vranks"])
    assert [f.rule for f in attribution.check_findings(doc)] == ["A003"]
    doc = _doc()
    del doc["roofline_wide"]["resident_macro_step"]
    assert [f.rule for f in attribution.check_findings(doc)] == ["A003"]
    # a measured share above the roof: the count is too high
    doc = _doc()
    doc["roofline_wide"]["pipelined_macro_step"]["achieved_fraction"] = 1.2
    found = attribution.check_findings(doc)
    assert [f.rule for f in found] == ["A003"]
    assert "1.2000 > 1.05" in found[0].message


def test_attribution_update_baseline_refuses_a_row_over_the_roof(
        monkeypatch, capsys):
    doc = _doc()
    wide = copy.deepcopy(doc["roofline_wide"])
    wide["canonical_planar_vranks"]["achieved_fraction"] = 1.06
    written = []
    monkeypatch.setattr(attribution, "_device_label",
                        lambda device: doc["device"])
    monkeypatch.setattr(attribution, "_measure_phase_tables",
                        lambda device: doc["phase_tables"])
    monkeypatch.setattr(
        attribution, "_measure_roofline",
        lambda device, n_local=None, recorder=None:
        doc["roofline"] if n_local is None else wide)
    monkeypatch.setattr(attribution, "write_attribution_baseline",
                        lambda *a, **k: written.append(k))
    assert attribution.main(["--update-baseline"]) == 1
    assert written == []
    assert "canonical_planar_vranks" in capsys.readouterr().err
    wide["canonical_planar_vranks"]["achieved_fraction"] = 1.05
    assert attribution.main(["--update-baseline"]) == 0
    assert len(written) == 1


def test_attribution_table_flags_a_delta_beyond_the_spread():
    """A negative delta larger than the two readings' spreads is marked
    non-monotone, one within them is printed as it is, and the spread of
    each reading has its column."""
    def row(phase, cum, delta, spread):
        return dict(phase=phase, cumulative_s=cum * 1e-3,
                    delta_s=delta * 1e-3, logical_bytes=None,
                    roofline_s=None, spread_s=spread * 1e-3)

    table = {"grid": "2,2,2", "phases": [1, 2, 3], "shapes": {"4096": {
        "rows": [row(1, 2.0, 2.0, 0.1), row(2, 1.9, -0.1, 0.1),
                 row(3, 1.0, -0.9, 0.2)]}}}
    lines = attribution.render_table("migrate", table).splitlines()
    assert lines[0] == "| phase (cumulative) | 8×4k ms | ± | delta |"
    assert lines[2].endswith("| 2.00 | 0.10 | (first) |")
    assert lines[3].endswith("| 1.90 | 0.10 | −0.10 |")
    assert lines[4].endswith("| **1.00** | 0.20 | −0.90 non-monotone |")
    assert [attribution.non_monotone(table["shapes"]["4096"]["rows"], i)
            for i in range(3)] == [False, False, True]


@pytest.mark.parametrize("fmt", ["json", "sarif", "github"])
def test_attribution_formats(fmt, capsys):
    assert attribution.main(["--check", f"--format={fmt}"]) == 0
    out = capsys.readouterr().out
    if fmt == "json":
        assert json.loads(out) == []
    elif fmt == "sarif":
        assert json.loads(out)["runs"][0]["results"] == []
    else:
        assert out == ""


def test_attribution_report_view(capsys):
    assert attribution.main([]) == 0
    out = capsys.readouterr().out
    assert "## migrate" in out and "## roofline" in out


def test_attribution_live_phases_are_the_knockouts():
    from mpi_grid_redistribute_tpu_torch.bench import (
        knockout_pipeline, knockout_stages,
    )

    assert attribution._live_phases("migrate") == list(
        knockout_stages.PHASES) == list(attribution.STAGE_LABELS)
    assert attribution._live_phases("pipeline") == list(
        knockout_pipeline.PHASES)


# ------------------------------------------------- no GPU, no CPU asked


@pytest.mark.parametrize("argv", [
    ("tools", "trace_export", "--demo", "--out", "x.json"),
    ("tools", "incident_demo", "--check"),
    ("tools", "attribution", "--update-baseline"),
    ("examples", "drift_demo", "--steps", "1"),
    ("bench", "knockout_stages", "1024"),
    ("bench", "knockout_pipeline", "1024"),
    ("analysis", "progcheck", "--update-baseline"),
])
def test_entry_points_raise_without_a_gpu(argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    pkg, tool, *args = argv
    r = subprocess.run(
        [sys.executable, "-m", f"mpi_grid_redistribute_tpu_torch.{pkg}.{tool}",
         *args], capture_output=True, text=True, env=_env(), timeout=300,
        cwd=str(tmp_path))
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


# ------------------------------------- utils.profiling.scan_time_per_step*


class _FakeLoop:
    """A loop of S steps on an injected clock: each call advances the
    clock by ``overhead + S * step`` (plus the next jitter of the
    ``noise`` list), never by the wall clock."""

    def __init__(self, overhead, step, noise=()):
        self.now = 0.0
        self.overhead, self.step = overhead, step
        self.noise = list(noise)
        self.built = []

    def clock(self):
        return self.now

    def make_loop(self, S):
        self.built.append(S)

        def run(x):
            jitter = self.noise.pop(0) if self.noise else 0.0
            self.now += self.overhead + S * self.step + jitter
            return (x + S, {"stats": x})

        return run


def test_scan_time_per_step_returns_the_references_shape():
    from mpi_grid_redistribute_tpu_torch.utils import profiling

    loop = _FakeLoop(overhead=0.5, step=0.01)
    per_step, overhead, out = profiling.scan_time_per_step(
        loop.make_loop, (torch.zeros(4),), clock=loop.clock)
    assert loop.built == [8, 72]  # s1=8, s2=72 by default, built once
    assert per_step == pytest.approx(0.01)
    assert overhead == pytest.approx(0.5)
    assert torch.equal(out[0], torch.full((4,), 72.0))


def test_scan_time_per_step_samples_detail():
    from mpi_grid_redistribute_tpu_torch.utils import profiling

    # warm-ups, then reps=4 long calls: jitter only on the long ones
    loop = _FakeLoop(overhead=0.2, step=0.001,
                     noise=[0, 0, 0, 0, 0, 0.0, 0.064, 0.0, 0.128])
    detail, out = profiling.scan_time_per_step_samples(
        loop.make_loop, (torch.zeros(2),), s1=8, s2=72, clock=loop.clock)
    assert sorted(detail) == ["k", "max", "mean", "min", "spread", "values"]
    assert detail["k"] == 4 and len(detail["values"]) == 4
    assert detail["min"] == pytest.approx(0.001)
    assert detail["max"] == pytest.approx(0.001 + 0.128 / 64)
    assert detail["spread"] == pytest.approx(
        (detail["max"] - detail["min"]) / detail["min"])
    assert detail["mean"] == pytest.approx(sum(detail["values"]) / 4)


@pytest.mark.parametrize("s1,s2", [(8, 8), (72, 8)])
def test_scan_time_per_step_raises_on_s2_not_above_s1(s1, s2):
    from mpi_grid_redistribute_tpu_torch.utils import profiling

    loop = _FakeLoop(0.1, 0.01)
    with pytest.raises(ValueError, match="s2 > s1"):
        profiling.scan_time_per_step(loop.make_loop, (torch.zeros(1),),
                                     s1=s1, s2=s2, clock=loop.clock)
    with pytest.raises(ValueError, match="s2 > s1"):
        profiling.scan_time_per_step_samples(
            loop.make_loop, (torch.zeros(1),), s1=s1, s2=s2,
            clock=loop.clock)


def test_scan_time_per_step_never_reports_a_non_positive_step():
    """C14's repair carried over: a long loop no slower than the short
    one is timed again, and a step time <= 0 is refused."""
    from mpi_grid_redistribute_tpu_torch.utils import profiling

    flat = _FakeLoop(overhead=0.25, step=0.0)  # exact: every call 0.25 s
    with pytest.raises(RuntimeError, match="noise, not a step"):
        profiling.scan_time_per_step(flat.make_loop, (torch.zeros(1),),
                                     clock=flat.clock)
    # one slow short call at first: re-timed until the difference shows
    loop = _FakeLoop(overhead=0.3, step=0.001,
                     noise=[0, 1.0, 1.0, 0, 0, 0])
    per_step, _, _ = profiling.scan_time_per_step(
        loop.make_loop, (torch.zeros(1),), clock=loop.clock)
    assert per_step == pytest.approx(0.001)
