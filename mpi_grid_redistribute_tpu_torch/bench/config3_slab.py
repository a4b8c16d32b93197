"""Config 3 (BASELINE.json) on one GPU: the 8x8 slab decomposition, an
(8, 8, 1) grid with z undecomposed, run as 64 vranks on one device (the
twin of the JAX package's ``bench/config3_slab.py``, without its
telemetry report). The drift loop at ~2% migration a step, dt = 1.0,
``n_local = max(2^12, BENCH_SCALE * 2^17)`` slots a vrank at 90% fill.

The BASELINE's 1B particles would need 64 x 15.6M slots; one card holds
a power-of-two cut of it (``PERF.md``, section 4).

    BENCH_SCALE=1 python -m mpi_grid_redistribute_tpu_torch.bench.config3_slab
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch import _device
from mpi_grid_redistribute_tpu_torch.bench import common
from mpi_grid_redistribute_tpu_torch.domain import Domain
from mpi_grid_redistribute_tpu_torch.models import nbody
from mpi_grid_redistribute_tpu_torch.utils import profiling

GRID = (8, 8, 1)
FILL = 0.9


def build(n_local: int = None, migration: float = 0.02):
    """The configuration and start state: ``(cfg, vgrid, (pos [N, 3],
    vel [N, 3], alive [N]))``, numpy rows from ``default_rng(3)`` with the
    reference's draws and sizing (``drift_sizing(..., headroom=1.5)``)."""
    scale = float(os.environ.get("BENCH_SCALE", 1.0))
    n_local = n_local or max(1 << 12, int(scale * (1 << 17)))
    dev_grid, vgrid, _ = common.pick_layout(GRID)
    rng = np.random.default_rng(3)
    v_scale, cap, budget = common.drift_sizing(
        GRID, n_local, FILL, migration, headroom=1.5
    )
    pos, _, alive = common.uniform_state(GRID, n_local, FILL, rng)
    vel = (
        v_scale * (rng.random(pos.shape, dtype=np.float32) * 2.0 - 1.0)
    ).astype(np.float32)
    cfg = nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True), grid=dev_grid, dt=1.0,
        capacity=cap, n_local=n_local, local_budget=budget,
    )
    return cfg, vgrid, (pos, vel, alive)


def run(n_local: int = None, migration: float = 0.02, device=None) -> dict:
    """Time the loop (runs of 4 and 24 steps differenced, min of k) on
    ``device`` (the GPU by default; the CPU times with the host's clock).
    Returns the reference's keys but its telemetry report."""
    dev = _device.resolve(device)
    cfg, vgrid, (pos, vel, alive) = build(n_local, migration)
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in (nbody.rows_to_planar(pos, 1),
                           nbody.rows_to_planar(vel, 1), alive))
    del pos, vel

    def make_run(S):
        loop = nbody.make_migrate_loop(cfg, S, vgrid=vgrid, device=dev)
        return lambda: loop(*args)

    detail, out = profiling.time_per_step_samples(make_run, s1=4, s2=24,
                                                  device=dev)
    per_step = detail["min"]
    total = int(FILL * cfg.n_local) * vgrid.nranks
    return {
        "metric": "config3_slab_pps_per_chip",
        "value": round(total / per_step, 2),
        "unit": "particles/s",
        "grid": "8x8 slab",
        "n_total": total,
        "chips": 1,
        "ms_per_step": round(per_step * 1e3, 2),
        "dropped_recv": int(out[3].dropped_recv.sum()),
    }


if __name__ == "__main__":
    print(json.dumps(run()))
