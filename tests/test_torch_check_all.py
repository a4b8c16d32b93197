"""The port's umbrella gate ``tools.check_all`` against the JAX
package's ``scripts/check_all.py``: the same registry shape over the
port's eight tools, ``--analyzers``, ``--lint``, ``--sarif-out`` and the
exit codes. On the CPU the tool that needs the card (kernelcheck) is
named as such and never counted as clean."""

import json
import os
import subprocess
import sys

import pytest

from mpi_grid_redistribute_tpu_torch.tools import check_all

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, timeout=900):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "mpi_grid_redistribute_tpu_torch.tools."
         "check_all", *args], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=timeout)


def test_registry_is_the_ports_eight_tools():
    assert [a.name for a in check_all.ANALYZERS] == [
        "gridlint", "progcheck", "shardcheck", "attribution", "racecheck",
        "kernelcheck", "incident-demo", "storecheck"]
    for a in check_all.ANALYZERS:
        assert os.path.exists(os.path.join(ROOT, a.baseline)), a
        assert "--check" in a.args
    assert [a.name for a in check_all.ANALYZERS if a.card] == ["kernelcheck"]


def test_every_row_takes_the_sarif_flag():
    """Each row's CLI accepts ``--check --format=sarif`` (the three that
    lacked SARIF output have it now)."""
    import importlib

    for a in check_all.ANALYZERS:
        src = open(importlib.util.find_spec(a.module).origin).read()
        if "import main" in src:  # a thin entry point: read its CLI
            src = open(importlib.util.find_spec(
                src.split("from ")[-1].split(" import")[0]).origin).read()
        assert '"sarif"' in src, a.name


def test_command_passes_the_device_through():
    rows = {a.name: a for a in check_all.ANALYZERS}
    cmd = check_all.command(rows["progcheck"], False, "cpu")
    assert cmd[-3:] == ["--device", "cpu", "--format=sarif"]
    assert "--device" not in check_all.command(rows["gridlint"], True,
                                               "cpu")


def test_unknown_analyzer_is_a_usage_error():
    proc = _run("--analyzers", "nope", "--device", "cpu")
    assert proc.returncode == 2
    assert "unknown analyzer" in proc.stderr


def test_lint_on_cpu_names_kernelcheck_and_counts_it_not_clean():
    """The acceptance criterion: every row runs but kernelcheck, which is
    named "needs the card"; no row that did not run reads clean, and the
    exit code is 3 (clean where run, not complete)."""
    proc = _run("--lint", "--device", "cpu")
    out = proc.stdout
    assert proc.returncode == check_all.EXIT_NEEDS_CARD, out + proc.stderr
    assert "check: kernelcheck needs the card: not run (not clean)" in out
    assert "kernelcheck clean" not in out
    for a in check_all.ANALYZERS:
        if a.name != "kernelcheck":
            assert f"check: {a.name} clean (exit 0" in out, (a.name, out)


def test_sarif_mode_writes_one_merged_file(tmp_path):
    path = tmp_path / "merged.sarif"
    proc = _run("--analyzers", "gridlint,racecheck,kernelcheck",
                "--device", "cpu", "--sarif-out", str(path))
    assert proc.returncode == check_all.EXIT_NEEDS_CARD, proc.stdout
    doc = json.loads(path.read_text())
    assert [r["tool"]["driver"]["name"] for r in doc["runs"]] == [
        "gridlint", "racecheck"]
    assert all(r["results"] == [] for r in doc["runs"])
    assert "merged 2 run(s)" in proc.stdout


def test_a_failing_tool_fails_the_gate(tmp_path, monkeypatch):
    bad = tmp_path / "bad.py"
    bad.write_text("# gridlint: fastpath-engine\ndef f(x):\n    return x\n")
    row = check_all.Analyzer("gridlint", check_all.ANALYZERS[0].module,
                             [str(bad), "--no-baseline"], "", False, False)
    monkeypatch.setattr(check_all, "ANALYZERS", (row,))
    assert check_all.main(["--lint", "--device", "cpu"]) == 1
