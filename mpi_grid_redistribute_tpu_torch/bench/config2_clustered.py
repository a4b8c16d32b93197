"""Config 2 (BASELINE.json) on one GPU: log-normal clustered particles on
a 4x4x4 grid, the load-imbalance configuration (the twin of the JAX
package's ``bench/config2_clustered.py``, without its telemetry report).
Two phases, in the reference's order:

* **steady state** (first): ``total = max(2^16, BENCH_SCALE * 2^21)``
  rows (67,108,864 at ``BENCH_SCALE=32``, the BASELINE size), clustered
  (``lognormal(-1.0, 1.5) % 1``) and, as the yardstick, uniform. Each
  workload's 64 cells are spread over 8 storage vranks by
  ``balanced_assignment`` (LPT) of its measured cell histogram, the slabs
  share one size (1.3x the heavier hot bin, rounded up to 4096), and the
  drift loop runs at ``dt = 1.0``, ~2% migration a step, with the
  ``cells``/``assignment`` decomposition;
* **placement** (second): 64 vranks, ``n_base = max(2^12, min(scale, 8) *
  2^17)`` rows each at fill 0.5, clustered rows NOT on their owners,
  ``dt = 0`` loops of 8 steps with a small per-pair capacity until a
  loop's last step sends nothing or ``max_rounds`` steps have run: the
  backlog drains the placement, nothing is dropped.

    BENCH_SCALE=32 python -m mpi_grid_redistribute_tpu_torch.bench.config2_clustered
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch import _device
from mpi_grid_redistribute_tpu_torch.bench import common
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.models import nbody
from mpi_grid_redistribute_tpu_torch.ops import binning
from mpi_grid_redistribute_tpu_torch.parallel import migrate
from mpi_grid_redistribute_tpu_torch.utils import profiling
from mpi_grid_redistribute_tpu_torch.utils import stats as stats_lib

GRID = (4, 4, 4)
SS_VGRID = (2, 2, 2)  # the steady state's 8 storage vranks
DOMAIN = Domain(0.0, 1.0, periodic=True)
WORKLOADS = ("imbalanced", "uniform")
PLACEMENT_LOOP = 8  # steps a placement loop runs before its check


def steady_total(n_local: int = None) -> int:
    """The steady state's row count: ``n_local * 64 / 4`` when given, else
    ``max(2^16, BENCH_SCALE * 2^21)``."""
    if n_local:
        return n_local * ProcessGrid(GRID).nranks // 4
    scale = float(os.environ.get("BENCH_SCALE", 1.0))
    return max(1 << 16, int(scale * (1 << 21)))


def _layout(rows: np.ndarray, dev, n_ranks: int):
    """Cell ids of ``rows`` on ``dev`` (the port's ``rank_of_position``
    over the 4x4x4 cells), the LPT assignment of their histogram and each
    row's owner: ``(counts, assignment, owner [N] int32 tensor, bins)``."""
    cells = ProcessGrid(GRID)
    cell = binning.rank_of_position(torch.from_numpy(rows).to(dev), DOMAIN,
                                    cells)
    counts = torch.bincount(cell, minlength=cells.nranks).cpu().numpy()
    assign = migrate.balanced_assignment(counts, n_ranks)
    owner = torch.tensor(assign, dtype=torch.int32, device=dev)[cell]
    bins = torch.bincount(owner, minlength=n_ranks).cpu().numpy()
    return counts, assign, owner, bins


def steady_rows(total: int, migration: float = 0.02) -> dict:
    """The steady state's host data, the reference's draws from
    ``default_rng(107)`` in its order: the clustered rows, the uniform
    rows, then each workload's velocities (clustered first). Returns
    ``{workload: (pos [total, 3], vel [total, 3])}`` float32 arrays.
    NumPy only (it may run in a thread while the card works)."""
    rng = np.random.default_rng(107)
    pos_c = (rng.lognormal(-1.0, 1.5, size=(total, 3)) % 1.0).astype(
        np.float32
    )
    pos_u = rng.random((total, 3), dtype=np.float32)
    v_scale = migration / 3.0 * 2.0 / np.asarray(GRID, np.float32)
    out = {}
    for name, pos in (("imbalanced", pos_c), ("uniform", pos_u)):
        vel = (v_scale * (rng.random(pos.shape, dtype=np.float32) * 2 - 1)
               ).astype(np.float32)
        out[name] = (pos, vel)
    return out


def steady_setup(total: int, device=None, migration: float = 0.02,
                 rows: dict = None) -> dict:
    """The steady state's layouts and sizing on ``device``: each
    workload's cell histogram, LPT assignment onto the 8 storage vranks
    and owners, the shared slab size (1.3x the heavier hot bin, rounded up
    to 4096) and the capacities (from the hot slab's migrant flux).
    ``rows`` is :func:`steady_rows`'s output (drawn here when omitted)."""
    dev = _device.resolve(device)
    rows = steady_rows(total, migration) if rows is None else rows
    vss = ProcessGrid(SS_VGRID).nranks
    lay = {name: _layout(rows[name][0], dev, vss) for name in WORKLOADS}
    bins_c, bins_u = lay["imbalanced"][3], lay["uniform"][3]
    counts_c = lay["imbalanced"][0]
    hot = max(bins_c.max(), bins_u.max())
    n_slab = -(-math.ceil(hot * 1.3) // 4096) * 4096
    return {
        "total": total,
        "rows": rows,
        "layout": lay,
        "imbalance": float(counts_c.max() / counts_c.mean()),
        "balanced_bin_imbalance": float(bins_c.max() / bins_c.mean()),
        "n_slab": n_slab,
        "waste": vss * n_slab / total,
        "capacity": max(64, math.ceil(hot * migration * 2.0)),
        "budget": max(256, math.ceil(hot * migration * 2.0)),
    }


def slab_state(rows, vel, owner: torch.Tensor, n_ranks: int, n_slab: int):
    """Planar flat slab state on ``owner``'s device: vrank ``v``'s rows
    (``[N, 3]`` numpy arrays or tensors) in their original order at the
    head of its ``n_slab`` slots (the reference's ``pos[v * n_slab : v *
    n_slab + k] = rows[owner == v]``, as one stable sort by owner).
    Returns ``(pos [3 * V * n_slab], vel, alive [V * n_slab])``."""
    dev = owner.device
    order = torch.sort(owner, stable=True).indices
    k = torch.bincount(owner, minlength=n_ranks)
    if int(k.max()) > n_slab:
        raise ValueError(f"a slab holds {int(k.max())} rows > {n_slab}")
    start = torch.cumsum(k, 0) - k
    o = owner[order].long()
    dest = o * n_slab + torch.arange(o.numel(), device=dev) - start[o]
    m = n_ranks * n_slab
    out = []
    for a in (rows, vel):
        planar = torch.zeros((3, m), dtype=torch.float32, device=dev)
        planar[:, dest] = torch.as_tensor(a).to(dev)[order].T
        out.append(planar.reshape(-1))
    alive = torch.zeros((m,), dtype=torch.bool, device=dev)
    alive[dest] = True
    return out[0], out[1], alive


def steady_workload(setup: dict, name: str, **cfg_kw):
    """``(cfg, vgrid, (pos, vel, alive))`` of one workload on the
    set-up's device; ``cfg_kw`` overrides ``DriftConfig`` fields
    (``engine``, ...)."""
    rows, vel = setup["rows"][name]
    _, assign, owner, _ = setup["layout"][name]
    vgrid = ProcessGrid(SS_VGRID)
    state = slab_state(rows, vel, owner, vgrid.nranks, setup["n_slab"])
    cfg = nbody.DriftConfig(
        domain=DOMAIN, grid=ProcessGrid((1, 1, 1)), dt=1.0,
        capacity=setup["capacity"], n_local=setup["n_slab"],
        local_budget=setup["budget"], cells=ProcessGrid(GRID),
        assignment=assign, **cfg_kw,
    )
    return cfg, vgrid, state


def placement_setup(n_base: int, sigma: float = 1.0, device=None):
    """The placement's configuration and start state: ``(cfg, vgrid,
    (pos, vel, alive))``, planar tensors on ``device`` (clustered rows from
    ``default_rng(7)``, NOT on their owners; fill 0.5, ``dt = 0``,
    ``capacity = ceil(n_base / 16)``, a budget of four capacities, which
    bounds the plans' ``[64, budget]`` tables; the placement is
    backlog-bound anyway)."""
    dev = _device.resolve(device)
    pos, alive = common.lognormal_state(
        GRID, n_base, 0.5, np.random.default_rng(7), sigma=sigma
    )
    vel = np.zeros_like(pos)
    cap = max(64, math.ceil(n_base / 16))
    dev_grid, vgrid, _ = common.pick_layout(GRID)
    cfg = nbody.DriftConfig(
        domain=DOMAIN, grid=dev_grid, dt=0.0, capacity=cap, n_local=n_base,
        local_budget=4 * cap,
    )
    start = tuple(torch.from_numpy(a).to(dev)
                  for a in (nbody.rows_to_planar(pos, 1),
                            nbody.rows_to_planar(vel, 1), alive))
    return cfg, vgrid, start


def placement(n_base: int, sigma: float = 1.0, max_rounds: int = 64,
              device=None):
    """The cold-start placement: loops of ``PLACEMENT_LOOP`` steps until a
    loop's last step sends nothing or ``max_rounds`` steps have run.
    Returns ``(the last loop's stats, rows placed, seconds, rounds, final
    (pos, vel, alive))``. A warm-up loop runs first on the
    start state (its output is dropped), as the reference's compile
    barrier does."""
    dev = _device.resolve(device)
    cfg, vgrid, start = placement_setup(n_base, sigma, dev)
    loop = nbody.make_migrate_loop(cfg, PLACEMENT_LOOP, vgrid=vgrid,
                                   device=dev)
    loop(*start)
    _sync(dev)
    placed, rounds, last, state = 0, 0, None, start
    t0 = time.perf_counter()
    for _ in range(max_rounds // PLACEMENT_LOOP):
        p, v, a, last = loop(*state)
        state = (p, v, a)
        rounds += PLACEMENT_LOOP
        placed += int(last.sent.sum())
        if int(last.sent[-1].sum()) == 0:
            break
    seconds = time.perf_counter() - t0
    return last, placed, seconds, rounds, state


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(n_local: int = None, sigma: float = 1.0, max_rounds: int = 64,
        migration: float = 0.02, device=None) -> dict:
    """Both phases on ``device`` (the GPU by default; the CPU times with
    the host's clock). Returns the reference's keys but its telemetry
    report."""
    dev = _device.resolve(device)
    scale = float(os.environ.get("BENCH_SCALE", 1.0))
    # the placement's 64 resident vranks cap at scale 8, as in the
    # reference; the steady state scales on its own
    n_base = n_local or max(1 << 12, int(min(scale, 8.0) * (1 << 17)))
    setup = steady_setup(steady_total(n_local), dev, migration)
    total = setup["total"]

    per, dropped = {}, 0
    for name in WORKLOADS:
        cfg, vgrid, args = steady_workload(setup, name)

        def make_run(S, cfg=cfg, vgrid=vgrid, args=args):
            loop = nbody.make_migrate_loop(cfg, S, vgrid=vgrid, device=dev)
            return lambda: loop(*args)

        detail, out = profiling.time_per_step_samples(
            make_run, s1=4, s2=20, device=dev
        )
        per[name] = detail["min"]
        dropped += int(out[3].dropped_recv.sum())
        # free this workload before the next one is built
        del cfg, args, out, make_run
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    del setup["rows"]

    last, placed, seconds, rounds, _ = placement(n_base, sigma, max_rounds,
                                                 dev)
    summary = stats_lib.summarize_migrate(last)
    pps_imb = total / per["imbalanced"]
    pps_uni = total / per["uniform"]
    return {
        "metric": "config2_clustered_steady_pps_per_chip",
        "value": round(pps_imb, 2),
        "unit": "particles/s",
        "pps_imbalanced": round(pps_imb, 2),
        "pps_uniform_ref": round(pps_uni, 2),
        "imbalanced_over_uniform": round(pps_imb / pps_uni, 3),
        "ownership_imbalance": round(setup["imbalance"], 3),
        # total slab slots / live rows
        "slot_waste_factor": round(setup["waste"], 3),
        "balanced_bin_imbalance": round(setup["balanced_bin_imbalance"], 4),
        "dropped_recv": dropped,
        "placement_dropped_recv": summary["dropped_recv"],
        "placement_pps": round(placed / seconds, 2) if placed else 0.0,
        "placement_rounds": rounds,
        "n_total": total,
        "chips": 1,
    }


if __name__ == "__main__":
    print(json.dumps(run()))
