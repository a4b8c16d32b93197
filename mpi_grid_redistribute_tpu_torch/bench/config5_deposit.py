"""Config 5 (BASELINE.json) on one GPU: the drift/migrate loop with the
CIC particle-mesh deposit fused into every step (the twin of the JAX
package's ``bench/config5_deposit.py``, without its telemetry report).

The 2x2x2 grid (``BENCH_GRID``) runs as 8 vranks on one device, 2^20
rows per vrank (``BENCH_SCALE`` scales it) at 90% fill, ~2% migration per
step, dt = 1.0, with the default engine ``"auto"`` (the mover-sparse
engine on this single-device vrank layout, as in the reference), onto a
128^3 density mesh with the method from ``BENCH_DEPOSIT`` (default
``"mxu"``, the segmented-sum engine; ``"scan"`` the double-float one).

    python -m mpi_grid_redistribute_tpu_torch.bench.config5_deposit
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch.bench import common
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.models import nbody

FILL = 0.9


def build(n_local: int = None, mesh_cells: int = 128,
          migration: float = 0.02, method: str = None, seed: int = 0):
    """The config-5 loop's configuration and start state:
    ``(cfg, vgrid, (pos [N, 3], vel [N, 3], alive [N]))``, numpy rows made
    from ``seed`` with the reference's sizing."""
    scale = float(os.environ.get("BENCH_SCALE", 1.0))
    n_local = n_local or max(1 << 12, int(scale * (1 << 20)))
    grid_shape = tuple(
        int(x) for x in os.environ.get("BENCH_GRID", "2,2,2").split(",")
    )
    # density mesh cells per axis, rounded to divide over the full grid
    m = max(grid_shape) * max(1, mesh_cells // max(grid_shape))
    v_scale, cap, budget = common.drift_sizing(
        grid_shape, n_local, FILL, migration
    )
    state = common.uniform_state(
        grid_shape, n_local, FILL, np.random.default_rng(seed),
        vel_scale=v_scale,
    )
    cfg = nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True),
        grid=ProcessGrid((1,) * len(grid_shape)), dt=1.0, capacity=cap,
        n_local=n_local, local_budget=budget, deposit_shape=(m, m, m),
        deposit_method=method or os.environ.get("BENCH_DEPOSIT", "mxu"),
    )
    return cfg, ProcessGrid(grid_shape), state


def run(n_local: int = None, mesh_cells: int = 128,
        migration: float = 0.02) -> dict:
    """Time the fused loop on the GPU (CUDA events, runs of 4 and 16
    steps differenced, min of k) and check its mass and drops."""
    from mpi_grid_redistribute_tpu_torch.utils import profiling

    cfg, vgrid, (pos, vel, alive) = build(n_local, mesh_cells, migration)
    args = (
        torch.from_numpy(nbody.rows_to_planar(pos, 1)).cuda(),
        torch.from_numpy(nbody.rows_to_planar(vel, 1)).cuda(),
        torch.from_numpy(alive).cuda(),
    )

    def make_run(S):
        loop = nbody.make_migrate_loop(cfg, S, vgrid=vgrid,
                                       deposit_each_step=True)
        return lambda: loop(*args)

    detail, long_out = profiling.cuda_time_per_step_samples(
        make_run, s1=4, s2=16
    )
    per_step = detail["min"]
    total = int(FILL * cfg.n_local) * vgrid.nranks
    dropped = int(long_out[3].dropped_recv.sum())
    mass = float(long_out[-1].double().sum())
    return {
        "metric": "config5_fused_deposit_pps_per_chip",
        "value": round(total / per_step, 2),
        "unit": "particles/s",
        "n_total": total,
        "chips": 1,
        "device": torch.cuda.get_device_name(0),
        "deposit_mesh": list(cfg.deposit_shape),
        "deposit_method": cfg.deposit_method,
        "ms_per_step": round(per_step * 1e3, 2),
        "mass_conserved": math.isclose(mass, total - dropped, rel_tol=1e-4),
        "dropped_recv": dropped,
    }


if __name__ == "__main__":
    print(json.dumps(run()))
