"""Package boundary of the PyTorch port: it never loads JAX or the JAX
package, neither does the chip smoke script, and its entry points refuse
to fall back to the CPU when no device was asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "mpi_grid_redistribute_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "mpi_grid_redistribute_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_import_does_not_load_jax():
    code = (
        "import sys\n"
        "import mpi_grid_redistribute_tpu_torch\n"
        "from mpi_grid_redistribute_tpu_torch.models import nbody\n"
        "from mpi_grid_redistribute_tpu_torch import convert\n"
        "from mpi_grid_redistribute_tpu_torch.utils import profiling\n"
        "from mpi_grid_redistribute_tpu_torch.bench import common\n"
        "from mpi_grid_redistribute_tpu_torch.bench import config5_deposit\n"
        "from mpi_grid_redistribute_tpu_torch.ops import deposit, dfscan, segdep\n"
        "from mpi_grid_redistribute_tpu_torch.ops import scatter\n"
        "from mpi_grid_redistribute_tpu_torch.parallel import exchange\n"
        "from mpi_grid_redistribute_tpu_torch import api, oracle\n"
        "from mpi_grid_redistribute_tpu_torch.ops import pack\n"
        "from mpi_grid_redistribute_tpu_torch.bench import config1_oracle\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mpi_grid_redistribute_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
    + ["chip_smoke.py", "tests/torch_rank_cases.py"],
)
def test_no_jax_import_in_source(path):
    bad = [m for m in _imports(ROOT / path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def _cfg():
    from mpi_grid_redistribute_tpu_torch import Domain, ProcessGrid
    from mpi_grid_redistribute_tpu_torch.models import nbody

    return nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True), grid=ProcessGrid((1, 1, 1)),
        dt=1.0, capacity=64, n_local=64, engine="planar",
    )


def test_entry_points_without_device_raise_on_cpu_only_machine():
    from mpi_grid_redistribute_tpu_torch import ProcessGrid, convert
    from mpi_grid_redistribute_tpu_torch.models import nbody

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        nbody.make_migrate_loop(_cfg(), 1, vgrid=ProcessGrid((2, 2, 2)))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.to_tensor(np.zeros(3, np.float32))
    from mpi_grid_redistribute_tpu_torch import GridRedistribute

    with pytest.raises(RuntimeError, match="CUDA"):
        GridRedistribute(lo=0.0, hi=1.0, grid=(2, 2, 2))
    GridRedistribute(lo=0.0, hi=1.0, grid=(2, 2, 2), backend="numpy")
    # an explicit CPU device works
    nbody.make_migrate_loop(
        _cfg(), 1, vgrid=ProcessGrid((2, 2, 2)), device="cpu"
    )
