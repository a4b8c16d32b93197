"""The port's runnable example (``examples/drift_demo.py``, the twin of
the JAX package's) on the CPU: the reference's verdict lines, its
alert, halo and corruption legs, and its plot fallback; it raises
without a GPU unless asked for the CPU. The reference runs the same
command in ``tests/test_demo.py``."""

import os
import subprocess
import sys

import pytest
import torch

from mpi_grid_redistribute_tpu_torch.examples import drift_demo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERDICTS = ("every particle is inside its owner's subdomain",
            "no particles lost")


def test_drift_demo_prints_both_verdicts():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m",
         "mpi_grid_redistribute_tpu_torch.examples.drift_demo",
         "--device", "cpu", "--n", "4096", "--steps", "3"],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    for line in VERDICTS:
        assert line in out.stdout


def test_drift_demo_bias_alerts(capsys):
    drift_demo.main(["--device", "cpu", "--n", "4096", "--steps", "20",
                     "--bias", "--expect-alert"])
    out = capsys.readouterr().out
    assert "health=ALERT" in out and "backlog_growth" in out


def test_drift_demo_unexpected_alert_exits_1():
    with pytest.raises(SystemExit) as e:
        drift_demo.main(["--device", "cpu", "--n", "4096", "--steps", "20",
                         "--bias"])
    assert e.value.code == 1


def test_drift_demo_halo_corrupt_trace_and_plot_fallback(tmp_path, capsys,
                                                         monkeypatch):
    # the card's machine has no matplotlib: the reference's skip path
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    trace = tmp_path / "t.json"
    drift_demo.main(["--device", "cpu", "--n", "4096", "--steps", "3",
                     "--halo", "--corrupt", "--plot", "--trace", str(trace)])
    out = capsys.readouterr().out
    for line in VERDICTS:
        assert line in out
    assert "zero overflow" in out and trace.exists()
    assert "corruption drill" in out and "FAIL" not in out
    # the density mesh holds every particle
    assert "matplotlib unavailable; skipped plot (density mesh sum 4096.0)" \
        in out


def test_drift_demo_needs_a_device_or_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drift_demo.main(["--steps", "1"])
