"""Config 1 (BASELINE.json) on one GPU: 1M uniform particles on a 2x2x2
grid, the correctness-oracle configuration (the twin of the JAX package's
``bench/config1_oracle.py``, without its telemetry report).

The public ``GridRedistribute.redistribute()`` runs on the card and is
held byte for byte against the port's NumPy oracle (positions, fields,
count and stats). The reference shrinks to a (1, 1, 1) grid when it has
fewer than 8 devices; the port runs the (2, 2, 2) grid as 8 virtual ranks
on one device. Then the canonical planar step in a drift loop (every row
re-binned, re-sorted and re-packed every step, ~2% crossing a face) is
timed per step with CUDA events, as the reference's ``make_loop_planar``.

    python -m mpi_grid_redistribute_tpu_torch.bench.config1_oracle
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch.api import GridRedistribute
from mpi_grid_redistribute_tpu_torch.bench import common
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops import binning
from mpi_grid_redistribute_tpu_torch.parallel import exchange

GRID = (2, 2, 2)
SEED = 42
CAPACITY_FACTOR = 4.0
MIGRATION = 0.02
DOMAIN = Domain(0.0, 1.0, periodic=True)
STATS = ("send_counts", "recv_counts", "dropped_send", "dropped_recv",
         "needed_capacity")


def inputs(n_total: int, seed: int = SEED):
    """``(pos [N, 3] f32 uniform, vel [N, 3] f32 normal, ids [N] int32)``
    from ``seed``, as the reference draws them."""
    rng = np.random.default_rng(seed)
    pos = rng.random((n_total, 3), dtype=np.float32)
    vel = rng.standard_normal((n_total, 3)).astype(np.float32)
    ids = np.arange(n_total, dtype=np.int32)
    return pos, vel, ids


def mismatches(res, res_np):
    """Names of the result parts (positions, fields, count, stats leaves)
    whose bytes differ between a torch-backend and a numpy-backend
    result."""
    def b(x):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return np.ascontiguousarray(x).tobytes()

    bad = [name for name, x, y in (
        ("positions", res.positions, res_np.positions),
        ("count", res.count, res_np.count),
    ) if b(x) != b(y)]
    bad += [f"field {i}" for i, (x, y) in enumerate(zip(res.fields,
                                                       res_np.fields))
            if b(x) != b(y)]
    bad += [f for f in STATS
            if b(getattr(res.stats, f)) != b(getattr(res_np.stats, f))]
    return bad


def oracle_check(n_total: int = 1 << 20, device=None):
    """Config 1 through ``GridRedistribute.redistribute`` on ``device``
    against the numpy backend on the same inputs. Raises on any byte
    difference; returns ``(result, numpy_result, instance)``."""
    pos, vel, ids = inputs(n_total)
    kw = dict(lo=0.0, hi=1.0, periodic=True, grid=GRID,
              capacity_factor=CAPACITY_FACTOR)
    rd = GridRedistribute(device=device, **kw)
    res = rd.redistribute(pos, vel, ids)
    res_np = GridRedistribute(backend="numpy", **kw).redistribute(
        pos, vel, ids)
    rd.flush_overflow_checks()
    bad = mismatches(res, res_np)
    if bad:
        raise AssertionError(f"config1: {bad} differ from the oracle")
    return res, res_np, rd


def loop_sizing(n_loc: int, migration: float = MIGRATION):
    """``(slots, cap)``: receive headroom of 1.25 * n_loc rows a vrank and
    the per-pair capacity of a drift step, as the reference sizes its
    canonical drift loop."""
    return int(n_loc * 1.25), max(64, math.ceil(n_loc * migration / 3 * 2.5))


def drift_state(n_loc: int, migration: float = MIGRATION, seed: int = 1):
    """The canonical drift loop's start: every row on its owner vrank,
    velocities moving ~``migration`` of them across a face per step.
    Returns ``(fused [V, 6, slots] float32, count [V] int32)`` numpy."""
    V = math.prod(GRID)
    slots, _ = loop_sizing(n_loc, migration)
    p0, v0, _ = common.uniform_state(
        GRID, n_loc, 1.0, np.random.default_rng(seed),
        vel_scale=migration / 3.0 * 2.0 / np.asarray(GRID, np.float32),
    )
    fused = np.zeros((V, 6, slots), np.float32)
    fused[:, :3, :n_loc] = p0.reshape(V, n_loc, 3).transpose(0, 2, 1)
    fused[:, 3:, :n_loc] = v0.reshape(V, n_loc, 3).transpose(0, 2, 1)
    return fused, np.full((V,), n_loc, np.int32)


def make_loop_planar(n_loc: int, migration: float = MIGRATION):
    """``loop(fused, count, steps) -> (fused, count, drops)``: drift by
    ``v * 1.0``, wrap, and one planar canonical exchange a step; ``drops``
    (a device scalar) sums every step's dropped rows."""
    slots, cap = loop_sizing(n_loc, migration)
    xfn = exchange.vrank_redistribute_planar_fn(DOMAIN, ProcessGrid(GRID),
                                                cap, slots)

    def loop(f, c, steps):
        drops = torch.zeros((), dtype=torch.int32, device=f.device)
        one = binning._f32(1.0, f)
        for _ in range(steps):
            p = binning.wrap_periodic_planar(f[:, :3] + f[:, 3:6] * one,
                                             DOMAIN)
            f, c, st = xfn(torch.cat([p, f[:, 3:6]], dim=1), c)
            drops = drops + st.dropped_send.sum() + st.dropped_recv.sum()
        return f, c, drops

    return loop


def main() -> int:
    from mpi_grid_redistribute_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        raise SystemExit("config1_oracle: needs a CUDA device")
    res, _, _ = oracle_check()
    n_loc = 1 << 20
    fused, count = drift_state(n_loc)
    f0, c0 = torch.from_numpy(fused).cuda(), torch.from_numpy(count).cuda()
    loop = make_loop_planar(n_loc)
    detail, out = profiling.cuda_time_per_step_samples(
        lambda S: (lambda: loop(f0, c0, S)), s1=4, s2=20, reps=5)
    if int(out[2]) or int(out[1].sum()) != 8 * n_loc:
        raise AssertionError("config1: the canonical drift loop lost rows")
    print(json.dumps({
        "metric": "config1_canonical_ms_per_step",
        "value": detail["min"] * 1e3,
        "median": detail["median"] * 1e3,
        "bit_equal_vs_oracle": True,
        "n_total": int(res.count.sum()),
        "canonical_rows": 8 * n_loc,
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
