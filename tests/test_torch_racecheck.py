"""The port's racecheck (``analysis/racecheck.py``, ``analysis/
rules_thread.py``, ``tools/racecheck.py``) against the JAX package's on
the CPU.

Every fixture test of the reference's ``tests/test_racecheck.py`` (the
T001-T005 fire/quiet pairs, the suppressions, the rule subsets, the
model's topology facts and the CLI's exit codes and formats) runs here
with both checkers: each scan the reference test makes also runs the
port's checker on the same files and root, and the two agree finding for
finding on (rule, path, line, symbol, message); each model it builds is
also built by the port, with the same thread roots and facts; and its
CLI calls go to the port's ``tools.racecheck.main``, so the reference's
assertions hold the port's CLI. Both checkers also agree over the two
packages' trees. The port's own tree is clean against its committed
baseline (``tools.racecheck --check`` exits 0), every entry of which is
justified, and the scrape-path call sites its justifications rest on are
pinned.
"""

import inspect
import json
import os
import subprocess
import sys

import pytest

import test_racecheck as ref_tests
from mpi_grid_redistribute_tpu.analysis import racecheck as jrace
from mpi_grid_redistribute_tpu_torch.analysis import racecheck as trace
from mpi_grid_redistribute_tpu_torch.analysis.baseline import (
    racecheck_baseline_path,
)
from mpi_grid_redistribute_tpu_torch.tools import racecheck as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_USES = ("check(", "run_racecheck(", "build_model(", "race_main(")


def _key(f):
    return (f.rule, f.path, f.line, f.symbol, f.message)


def _topology(model):
    return {label: (r.daemon, r.joined, r.multi, r.marked_writer,
                    len(model.reach.get(label, ())))
            for label, r in model.root_by_label.items()}


def _fixture_tests():
    """The reference's fixture tests: every test function up to the
    repo-wide gate that scans, models or calls the CLI."""
    out = []
    for name, fn in inspect.getmembers(ref_tests, inspect.isfunction):
        if not name.startswith("test_") or fn.__module__ != ref_tests.__name__:
            continue
        src = inspect.getsource(fn)
        if "tsan" in name or "supervisor" in name or "repo_is" in name:
            continue
        if any(u in src for u in _USES):
            out.append(name)
    return sorted(out)


FIXTURE_TESTS = _fixture_tests()


def test_the_reference_fixture_tests_are_all_here():
    assert len(FIXTURE_TESTS) == 31


@pytest.mark.parametrize("name", FIXTURE_TESTS)
def test_reference_fixture_through_both_checkers(name, tmp_path, capsys,
                                                 monkeypatch):
    compared = []

    def run_both(paths, root=None, rules=None, model=None):
        want = jrace.run_racecheck(paths, root=root, rules=rules)
        got = trace.run_racecheck(paths, root=root, rules=rules)
        assert [_key(f) for f in got] == [_key(f) for f in want]
        compared.append(len(want))
        return want

    def model_both(paths, root=None):
        want = jrace.build_model(paths, root=root)
        assert _topology(trace.build_model(paths, root=root)) == \
            _topology(want)
        compared.append(-1)
        return want

    monkeypatch.setattr(ref_tests, "run_racecheck", run_both)
    monkeypatch.setattr(ref_tests, "build_model", model_both)
    monkeypatch.setattr(ref_tests, "race_main", tcli.main)
    fn = getattr(ref_tests, name)
    fixtures = {"tmp_path": tmp_path, "capsys": capsys,
                "monkeypatch": monkeypatch}
    fn(**{p: fixtures[p] for p in inspect.signature(fn).parameters})
    if "race_main(" not in inspect.getsource(fn):
        assert compared, f"{name} scanned nothing"


@pytest.mark.parametrize("tree", [
    ["mpi_grid_redistribute_tpu", "scripts"],
    ["mpi_grid_redistribute_tpu_torch"],
])
def test_both_checkers_agree_over_the_trees(tree):
    paths = [os.path.join(REPO, t) for t in tree]
    jmodel = jrace.build_model(paths, root=REPO)
    tmodel = trace.build_model(paths, root=REPO)
    assert _topology(tmodel) == _topology(jmodel)
    want = jrace.run_racecheck(paths, root=REPO, model=jmodel)
    got = trace.run_racecheck(paths, root=REPO, model=tmodel)
    assert [_key(f) for f in got] == [_key(f) for f in want]
    assert want  # the trees have the justified findings


def test_port_tree_is_clean_against_its_baseline():
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_grid_redistribute_tpu_torch.tools."
         "racecheck", "--check"], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout and "baselined" in proc.stdout


def test_port_threads_are_the_ones_the_baseline_speaks_of(capsys):
    assert tcli.main(["--list-threads"]) == 0
    out = capsys.readouterr().out
    for root in ("thread:ServiceDriver.snapshot.write@"
                 "mpi_grid_redistribute_tpu_torch/service/driver.py",
                 "thread:demo_snapshotter.drive@"
                 "mpi_grid_redistribute_tpu_torch/tools/metrics_serve.py",
                 "handler:Handler.do_GET@"
                 "mpi_grid_redistribute_tpu_torch/tools/metrics_serve.py"):
        assert root in out, out
    assert "recorder-writer" in out


def test_committed_baseline_entries_are_justified():
    with open(racecheck_baseline_path(), encoding="utf-8") as fh:
        data = json.load(fh)
    assert data["findings"]
    keys = set()
    for e in data["findings"]:
        assert e["path"].startswith("mpi_grid_redistribute_tpu_torch/")
        assert len(e["justification"]) > 80, e
        assert not e["justification"].startswith("UNJUSTIFIED"), e
        keys.add((e["rule"], e["path"], e["symbol"], e["message"]))
    assert len(keys) == len(data["findings"])


def test_scrape_paths_evaluate_health_read_only():
    """The T005 and HealthMonitor entries rest on this: every evaluate()
    on the scrape path passes record=False (the drive thread's is the
    one marked writer)."""
    src = open(os.path.join(REPO, "mpi_grid_redistribute_tpu_torch", "tools",
                            "metrics_serve.py"), encoding="utf-8").read()
    calls = [ln.strip() for ln in src.splitlines() if ".evaluate(" in ln]
    assert sorted(calls) == sorted([
        "rd.monitor.evaluate()",
        "verdict = monitor.evaluate(record=False)",
        "verdict = health_lib.HealthMonitor(rec).evaluate(record=False)",
    ])


def test_write_baseline_keeps_justifications(tmp_path, capsys):
    (tmp_path / "mod.py").write_text(
        "import threading\n\nclass A:\n    def __init__(self):\n"
        "        self.lock = threading.Lock()\n        self.lock2 = "
        "threading.Lock()\n\n    def f(self):\n        with self.lock:\n"
        "            with self.lock2:\n                pass\n\n"
        "    def g(self):\n        with self.lock2:\n"
        "            with self.lock:\n                pass\n")
    bl = tmp_path / "bl.json"
    argv = [str(tmp_path), "--root", str(tmp_path), "--baseline", str(bl)]
    assert tcli.main(argv + ["--write-baseline"]) == 0
    doc = json.loads(bl.read_text())
    assert [e["justification"] for e in doc["findings"]] == [
        tcli.UNJUSTIFIED]
    doc["findings"][0]["justification"] = "the two paths never overlap"
    bl.write_text(json.dumps(doc))
    assert tcli.main(argv + ["--write-baseline"]) == 0
    assert json.loads(bl.read_text())["findings"][0]["justification"] == \
        "the two paths never overlap"
    capsys.readouterr()
    assert tcli.main(argv + ["--check"]) == 0
    assert tcli.main(argv + ["--no-baseline"]) == 1
