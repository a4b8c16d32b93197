"""The chunked service step on one GPU: the sequential chunk
(:func:`..service.resident.make_chunk_fn`), the software-pipelined one
(:func:`..service.pipeline.make_pipelined_chunk_fn`) and the eager
per-step loop (:func:`..models.nbody.service_drift` then
``GridRedistribute.redistribute``) on the bench shape: the 2x2x2 grid as
8 vranks, ``n_local`` rows a vrank (2^20) at 90% fill, velocities from
:func:`.common.drift_sizing` for ~2% migration a step at dt = 1.0, the
payload ``pos``/``vel``/``ids``, ``out_capacity = n_local``, chunks of
16 steps.

    python -m mpi_grid_redistribute_tpu_torch.bench.service_chunk

prints one JSON line: ms a step of each path (min of ``reps``
length-differenced CUDA-event samples: runs of 1 and 3 chunks, of
``chunk`` and ``3 * chunk`` eager steps), the device's busy milliseconds
a step (a device-only ``torch.profiler`` trace of one and two chunks,
differenced) and its idle share, particles a second, and the checks: the
two chunks' particle sets, counts and send tables equal, nothing
dropped, every pipelined step armed. ``BENCH_N_LOCAL`` sets the rows a
vrank; ``BENCH_PROFILE_DIR=dir`` writes each path's kernel table. It runs on the GPU and raises
without one; ``device="cpu"`` runs the plain versions.
"""

from __future__ import annotations

import json
import math
import os
import re
import sys

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch import _device, api
from mpi_grid_redistribute_tpu_torch.bench import common
from mpi_grid_redistribute_tpu_torch.models import nbody
from mpi_grid_redistribute_tpu_torch.service import (
    make_chunk_fn, make_pipelined_chunk_fn, particle_set,
)
from mpi_grid_redistribute_tpu_torch.utils import profiling

GRID = (2, 2, 2)
FILL = 0.9
MIGRATION = 0.02
DT = 1.0
CHUNK = 16


def prepare(n_local: int, device=None):
    """``(rd, state)``: a ``GridRedistribute`` on ``device`` with
    ``out_capacity = n_local`` and the start ``(pos [R*n, 3], vel [R*n,
    3], ids [R*n], count [R])`` on it (``common.uniform_state`` from
    ``default_rng(0)``, the live prefix of each slab counted)."""
    dev = _device.resolve(device)
    R = math.prod(GRID)
    v, _, _ = common.drift_sizing(GRID, n_local, FILL, MIGRATION)
    pos, vel, _ = common.uniform_state(GRID, n_local, FILL,
                                       np.random.default_rng(0), vel_scale=v)
    ids = np.arange(R * n_local, dtype=np.int32)
    count = np.full((R,), int(FILL * n_local), np.int32)
    rd = api.GridRedistribute(grid=GRID, lo=(0.0,) * 3, hi=(1.0,) * 3,
                              periodic=(True,) * 3, out_capacity=n_local,
                              device=dev)
    state = tuple(torch.from_numpy(a).to(dev) for a in (pos, vel, ids, count))
    return rd, state


def build(rd, state, chunk: int = CHUNK, dt: float = DT):
    """``(sequential macro, pipelined macro)`` for ``state``'s shapes."""
    seq = make_chunk_fn(rd, dt, chunk, *state[:3])[0]
    pipe = make_pipelined_chunk_fn(rd, dt, chunk, *state[:3])[0]
    return seq, pipe


def eager(rd, state, steps: int, dt: float = DT):
    """``steps`` eager service steps: drift, then ``rd.redistribute``."""
    pos, vel, ids, count = state
    for _ in range(steps):
        pos = nbody.service_drift(pos, vel, dt)
        res = rd.redistribute(pos, vel, ids, count=count)
        pos, (vel, ids), count = res.positions, res.fields, res.count
    return pos, vel, ids, count


def check_pair(seq_out, pipe_out) -> dict:
    """The pipelined chunk against the sequential one: the same particle
    set, counts, per-step counts and send tables, nothing dropped, every
    step armed; raises otherwise. Returns the checked numbers."""
    (sp, sv, si, sc), s_ys = seq_out
    (pp, pv, pi, pc), p_ys = pipe_out
    same = {
        "particle_set": particle_set(pp, pv, pi, pc) == particle_set(
            sp, sv, si, sc),
        "count": torch.equal(pc, sc),
        "ys_count": torch.equal(p_ys["count"], s_ys["count"]),
        "send_counts": torch.equal(p_ys["stats"].send_counts,
                                   s_ys["stats"].send_counts),
    }
    bad = [k for k, ok in same.items() if not ok]
    if bad:
        raise RuntimeError(f"pipelined chunk differs from sequential: {bad}")
    dropped = {k: int(getattr(ys["stats"], f).sum())
               for k, ys in (("sequential", s_ys), ("pipelined", p_ys))
               for f in ("dropped_send", "dropped_recv")}
    if any(dropped.values()):
        raise RuntimeError(f"rows dropped: {dropped}")
    armed = p_ys["stats"].pipeline
    if not bool(armed.all()):
        raise RuntimeError(f"pipelined steps not armed: {armed[:, 0]}")
    sent = s_ys["stats"].send_counts
    total = int(sc.sum())
    moved = (sent.sum() - sent.diagonal(dim1=-2, dim2=-1).sum()) / (
        sent.shape[0] * total)
    return {"rows": total, "steps": int(s_ys["count"].shape[0]),
            "migration_fraction": float(moved)}


# the profiler ranges the port labels its phases with ("svc:drift",
# "pipe:issue", "mig:pack", ...), mirrored onto the device's timeline
_SPAN = re.compile(r"[a-z]+:(?!:)")


def device_busy_ms(make_run, per_unit: int, table=None) -> float:
    """Device-busy milliseconds a step: a device-only ``torch.profiler``
    trace of ``make_run(1)`` and ``make_run(2)``, differenced (set-up
    cancels), over ``per_unit`` steps a unit; the device's kernels,
    copies and memsets, not the phase ranges. ``table`` is a path for
    the longer trace's kernel table."""
    from torch.profiler import ProfilerActivity, profile

    busy = {}
    for k in (1, 2):
        run = make_run(k)
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        busy[k] = sum(
            e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not _SPAN.match(e.name)) / 1e3
        if table and k == 2:
            with open(table, "w") as f:
                f.write(prof.key_averages().table(
                    sort_by="self_cuda_time_total", row_limit=60))
    return (busy[2] - busy[1]) / per_unit


def time_paths(rd, state, chunk: int = CHUNK, reps: int = 3,
               busy: bool = True, profile_dir=None) -> dict:
    """ms a step (min of ``reps`` differenced samples) of the sequential
    and pipelined chunks and of the eager loop, each from ``state``; on
    the card with ``busy`` also the device's busy ms a step and idle
    share (with ``profile_dir``, each path's kernel table written
    there)."""
    dev = state[0].device
    seq, pipe = build(rd, state, chunk)

    def chunks(macro):
        def make_run(k):
            def go():
                st = state
                for _ in range(k):
                    st = macro(*st)[0]
                return st
            return go
        return make_run

    def steps(k):
        return lambda: eager(rd, state, k * chunk)

    out = {}
    for name, make_run in (("sequential", chunks(seq)),
                           ("pipelined", chunks(pipe)), ("eager", steps)):
        detail, _ = profiling.time_per_step_samples(make_run, 1, 3, reps,
                                                    device=dev)
        ms = detail["min"] * 1e3 / chunk
        row = {"ms_per_step": ms, "median_ms_per_step":
               detail["median"] * 1e3 / chunk, "spread": detail["spread"]}
        if busy and dev.type == "cuda":
            table = None
            if profile_dir:
                os.makedirs(profile_dir, exist_ok=True)
                table = os.path.join(profile_dir,
                                     f"service_{name}_2chunks.txt")
            b = device_busy_ms(make_run, chunk, table)
            row.update(device_busy_ms_per_step=b, idle=1 - b / ms)
        out[name] = row
    rd.flush_overflow_checks()
    return out


def main() -> int:
    n_local = int(os.environ.get("BENCH_N_LOCAL", 1 << 20))
    rd, state = prepare(n_local)
    seq, pipe = build(rd, state)
    checked = check_pair(seq(*state), pipe(*state))
    times = time_paths(rd, state,
                       profile_dir=os.environ.get("BENCH_PROFILE_DIR"))
    for row in times.values():
        row["pps"] = checked["rows"] / (row["ms_per_step"] / 1e3)
    line = {"grid": GRID, "n_local": n_local, "chunk": CHUNK, "dt": DT,
            **checked, "paths": times}
    common.log(f"service chunk: {json.dumps(times)}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
