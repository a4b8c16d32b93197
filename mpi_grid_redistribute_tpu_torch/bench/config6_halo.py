"""Config 6 on one GPU: the halo exchange timed on the card (the twin of
the JAX package's ``bench/config6_halo.py``, without its telemetry
report).

The 2x2x2 grid runs as 8 vranks on the periodic unit box, every slot
filled with uniform particles placed on their owners (``common.
uniform_state``, seed 0), halo width a tenth of the subdomain width
(0.05), capacities from ``parallel.halo.default_capacities``. Both vrank
engines are timed per exchange: the planar one (the headline, what
``GridRedistribute.halo`` runs on 32-bit arrays) and the row-major one.
Each timed loop carries a ghost statistic into the next exchange's
positions, as the reference's loop does. Times are CUDA-event samples of
runs of 4 and 16 exchanges, differenced (``utils.profiling.
cuda_time_per_step_samples``, ``REPS`` samples); the reported value is
their minimum. The measured ghost fraction stands beside the uniform
expectation ``(1 + 2 w / cell_w)^3 - 1``.

    python -m mpi_grid_redistribute_tpu_torch.bench.config6_halo
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch.bench import common
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.parallel import halo as halo_lib

GRID = (2, 2, 2)
DOMAIN = Domain(0.0, 1.0, periodic=True)
FILL = 1.0
SEED = 0
N_LOCAL = 1 << 18
WIDTH_FRAC = 0.1  # halo width as a fraction of the subdomain width
REPS = 4  # timed samples of each engine (the reference takes 2)


def setup(n_local: int = N_LOCAL):
    """``(pos [V, n, 3] float32, count [V] int32, w, pc, gc)``: the
    config-6 state as numpy, its halo width and derived capacities."""
    grid = ProcessGrid(GRID)
    V = grid.nranks
    w = WIDTH_FRAC * min(grid.cell_widths(DOMAIN))
    pos, _, _ = common.uniform_state(GRID, n_local, FILL,
                                     np.random.default_rng(SEED))
    count = np.full((V,), n_local, np.int32)
    pc, gc = halo_lib.default_capacities(DOMAIN, grid, w, n_local)
    return pos.reshape(V, n_local, 3), count, w, pc, gc


def engines(w: float, pc: int, gc: int):
    """``{"planar": fn(fused [V, 3, n], count), "rowmajor": fn(pos [V, n,
    3], count)}``, the two vrank engines at config 6's sizing."""
    grid = ProcessGrid(GRID)
    return {
        "planar": halo_lib.vrank_halo_planar_fn(DOMAIN, grid, w, pc, gc),
        "rowmajor": halo_lib.vrank_halo_fn(DOMAIN, grid, w, pc, gc),
    }


def device_states(pos_v, count, device):
    """``({"rowmajor": [V, n, 3], "planar": [V, 3, n]}, count)``: the
    numpy state as each engine's input tensor on ``device``."""
    return {
        "rowmajor": torch.from_numpy(pos_v).to(device),
        "planar": torch.from_numpy(
            np.ascontiguousarray(pos_v.transpose(0, 2, 1))).to(device),
    }, torch.from_numpy(count).to(device)


def make_loop(engine: str, fn, state: torch.Tensor, count: torch.Tensor):
    """``make_run(S)`` for the timing protocol: S exchanges, each one's
    ghost statistic folded (times 0.0) into the next one's positions, so
    every exchange consumes the one before it. The run returns ``(state,
    gcounts [S, V], overflows [S, V])``."""
    def make_run(S: int):
        def run():
            p = state
            gcounts, overflows = [], []
            for _ in range(S):
                ghost, gcount, overflow = fn(p, count)
                if engine == "planar":
                    p = p + 0.0 * ghost[:, :, :1].sum(dim=2, keepdim=True)
                else:
                    p = p + 0.0 * ghost[:, :1, :].sum(dim=1, keepdim=True)
                gcounts.append(gcount)
                overflows.append(overflow)
            return p, torch.stack(gcounts), torch.stack(overflows)

        return run

    return make_run


class Case(NamedTuple):
    """Config 6 at one size on one device: both engines and their
    inputs, built once for timing and for any check that follows."""
    n_local: int
    w: float
    pass_capacity: int
    ghost_capacity: int
    fns: dict
    states: dict
    count: torch.Tensor


def prepare(n_local: int, device) -> Case:
    pos_v, count, w, pc, gc = setup(n_local)
    states, count_t = device_states(pos_v, count, device)
    return Case(n_local, w, pc, gc, engines(w, pc, gc), states, count_t)


def time_case(case: Case):
    """Time both engines of a case on the card. Returns the reference's
    JSON keys (unrounded) plus each engine's median, spread and number
    of samples."""
    from mpi_grid_redistribute_tpu_torch.utils import profiling

    V = ProcessGrid(GRID).nranks
    detail, ghosts, overflow = {}, {}, 0
    for engine in ("rowmajor", "planar"):
        make_run = make_loop(engine, case.fns[engine], case.states[engine],
                             case.count)
        detail[engine], out = profiling.cuda_time_per_step_samples(
            make_run, s1=4, s2=16, reps=REPS)
        ghosts[engine] = int(out[1][-1].sum())
        overflow += int(out[2].sum())
    if ghosts["planar"] != ghosts["rowmajor"]:
        raise RuntimeError(f"config6: the engines disagree on the ghost "
                           f"count: {ghosts}")
    total = V * case.n_local
    w = case.w
    f = w / min(ProcessGrid(GRID).cell_widths(DOMAIN))
    n_ghosts = ghosts["planar"]
    per, per_rm = detail["planar"]["min"], detail["rowmajor"]["min"]
    return {
        "metric": "config6_halo_ms_per_exchange",
        "value": per * 1e3,
        "unit": "ms",
        "engine": "planar",
        "device": torch.cuda.get_device_name(0),
        "n_total": total,
        "halo_width": w,
        "ghosts_per_exchange": n_ghosts,
        "ghost_frac_measured": n_ghosts / total,
        "ghost_frac_expected_uniform": (1.0 + 2.0 * f) ** 3 - 1.0,
        "ns_per_ghost": per / max(n_ghosts, 1) * 1e9,
        "median_ms_per_exchange": detail["planar"]["median"] * 1e3,
        "spread": detail["planar"]["spread"],
        "samples": detail["planar"]["k"],
        "rowmajor_ms_per_exchange": per_rm * 1e3,
        "rowmajor_ns_per_ghost": per_rm / max(n_ghosts, 1) * 1e9,
        "rowmajor_median_ms_per_exchange":
            detail["rowmajor"]["median"] * 1e3,
        "rowmajor_spread": detail["rowmajor"]["spread"],
        "pass_capacity": case.pass_capacity,
        "ghost_capacity": case.ghost_capacity,
        "overflow": overflow,
    }


def run(n_local: int = None):
    """Config 6 timed on the GPU at ``n_local`` rows a vrank (default
    the reference's 2^18): :func:`time_case` of a fresh case."""
    if not torch.cuda.is_available():
        raise RuntimeError("config6_halo.run times the card: no CUDA device")
    return time_case(prepare(n_local or N_LOCAL, "cuda"))


if __name__ == "__main__":
    print(json.dumps(run()))
