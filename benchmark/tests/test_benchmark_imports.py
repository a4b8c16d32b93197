"""What the benchmark loads: never JAX or the JAX package (compared by whole
top-level name), and the reference nothing of the program. A run without
the card it needs fails and prints nothing."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TOP = ("jax", "jaxlib", "flax", "mpi_grid_redistribute_tpu")


def _python(code: str, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _tops_after(config: str, traffic: str):
    code = (
        "import json, sys\n"
        "from benchmark.tests.test_benchmark_cell import measure, tiny_cell\n"
        f"line = measure(tiny_cell({config!r}, {traffic!r}), 9)\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([line['correct'], tops]))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_jax_after_a_tiny_cell():
    correct, tops = _tops_after("uniform_2x2x2_cic128", "m2_s1")
    assert correct
    assert "mpi_grid_redistribute_tpu_torch" in tops
    assert not set(tops) & set(TOP), set(tops) & set(TOP)


def test_no_jax_after_a_tiny_oneshot_cell():
    """The public call loads more of the port (the API, its telemetry)."""
    correct, tops = _tops_after("oneshot_4x4x4", "file_order")
    assert correct
    assert "mpi_grid_redistribute_tpu_torch" in tops
    assert not set(tops) & set(TOP), set(tops) & set(TOP)


def test_reference_imports_nothing_of_the_program():
    code = (
        "import json, sys\n"
        "import benchmark.reference, benchmark.state, benchmark.spec\n"
        "import benchmark.costs, benchmark.trace\n"
        "benchmark.trace.load_metrics()\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & (set(TOP) | {"mpi_grid_redistribute_tpu_torch"})


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "uniform_2x2x2.m2_s4", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_fail(tmp_path):
    """A checkout of only the manifest and the benchmark's folder has no
    program to run: the run fails and prints nothing."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-c",
         "import types, torch; from benchmark import run, spec; "
         "a = types.SimpleNamespace(seed=1, seconds=1, trace=0, "
         "control=False); "
         "c = spec.load_cell('uniform_2x2x2.m2_s4'); "
         "print(run.run_local(a, c, torch.device('cpu')))"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "mpi_grid_redistribute_tpu_torch" in out.stderr
