"""The service driver on one GPU: its three legs, its snapshot and its
restore at the bench width.

:class:`~..service.driver.ServiceDriver` on the 2x2x2 grid as 8 vranks,
``BENCH_N_LOCAL`` rows a vrank (2^20) at fill 0.8, the driver's seeded
state (~2% migration a step at dt = 1.0):

* each leg, eager (``chunk=1``), chunked and pipelined (``chunk=16``):
  ms a step through ``run()`` (host clock, min of ``REPS`` (3)
  segments of ``SEG`` (32) steps after a warm segment), the host syncs
  a step (sync debug mode "warn", its warnings counted), and the
  device's busy ms a step and idle share from a device-only
  ``torch.profiler`` trace of one segment; for the chunked legs, the
  chunk overlap read off a trace of host and device activity over two
  segments (:func:`_read_overlap`);
* the chunked and pipelined legs again with a journal store on
  (``store_dir``, drained at every chunk boundary): the same figures,
  and each drain's ms on the loop's thread;
* one synchronous snapshot (pos, vel, ids and count: 28 B a row), the
  loop's share of an asynchronous one (the host copy; the write runs on
  the writer thread), and ``restore_latest`` into a fresh driver, each
  in seconds, with the bytes on disk.

    python -m mpi_grid_redistribute_tpu_torch.bench.service_driver

prints one JSON line. It runs on the GPU and raises without one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time
import warnings

import torch

from mpi_grid_redistribute_tpu_torch.bench import common

GRID = (2, 2, 2)
CHUNK = 16
SEG = 32  # steps a timed segment
REPS = 3  # timed segments a leg


def _busy_ms(drv, steps: int) -> float:
    """Device-busy ms of ``steps`` steps of ``drv.run`` (kernels, copies
    and memsets of a device-only trace)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        drv.run(max_steps=steps)
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3


def _read_overlap(drv, steps: int) -> dict:
    """The chunk overlap on one trace of host and device activity over
    ``steps`` steps of a chunked ``drv.run``: each wait on a chunk's
    staged ys (the host's ``cudaEventSynchronize``) against the device
    timeline. ``busy_at_read`` counts the waits that returned while a
    device op was running (chunk k+1, issued before chunk k's read);
    ``device_ms_after_read`` is, for each wait, the device time that ran
    after it returned and before the next wait (or the trace's end)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        drv.run(max_steps=steps)
        torch.cuda.synchronize()
    dev = [(e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    waits = sorted(e.time_range.end for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name == "cudaEventSynchronize")
    after = []
    for i, w in enumerate(waits):
        nxt = waits[i + 1] if i + 1 < len(waits) else float("inf")
        after.append(sum(min(e, nxt) - max(s, w) for s, e in dev
                         if e > w and s < nxt) / 1e3)
    return {"reads": len(waits),
            "busy_at_read": sum(any(s <= w < e for s, e in dev)
                                for w in waits),
            "device_ms_after_read": after}


def _syncs(drv, steps: int) -> int:
    """Host syncs of ``steps`` steps of ``drv.run``: the warnings of sync
    debug mode "warn"."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            drv.run(max_steps=steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def time_drains(drv) -> list:
    """Time ``drv``'s journal-store drains on the loop's thread: the
    returned list gets each drain's seconds on the host clock (it stays
    empty when the driver has no store)."""
    drains = []
    store = drv._store
    if store is None:
        return drains
    real = store.drain

    def timed(recorder):
        t = time.perf_counter()
        try:
            return real(recorder)
        finally:
            drains.append(time.perf_counter() - t)

    store.drain = timed
    return drains


def time_leg(cfg, seg: int, reps: int) -> dict:
    from mpi_grid_redistribute_tpu_torch.service import ServiceDriver

    chunked = cfg.chunk > 1
    steps = seg * (reps + (5 if chunked else 3))
    drv = ServiceDriver(dataclasses.replace(cfg, steps=steps))
    drains = time_drains(drv)
    drv.init_state()
    drv.run(max_steps=seg)  # first builds and the calibration
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drv.run(max_steps=seg)
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3 / seg)
    ms = min(samples)
    syncs = _syncs(drv, seg)
    busy = _busy_ms(drv, seg) / seg
    overlap = _read_overlap(drv, 2 * seg) if chunked else None
    dropped = sum(e.data["dropped"]
                  for e in drv.recorder.events("step_latency"))
    drv.close()
    out = {"ms_per_step": ms, "median_ms_per_step": sorted(samples)[
        len(samples) // 2], "host_syncs_per_step": syncs / seg,
        "device_busy_ms_per_step": busy, "idle": 1 - busy / ms,
        "dropped": dropped, "overlap": overlap}
    if drains:
        out["drains"] = {"n": len(drains), "mean_ms": 1e3 * sum(drains)
                         / len(drains), "max_ms": 1e3 * max(drains)}
    return out


def time_snapshot(cfg, workdir: str) -> dict:
    from mpi_grid_redistribute_tpu_torch.service import ServiceDriver

    snap = dataclasses.replace(cfg, snapshot_dir=workdir,
                               snapshot_async=False)
    drv = ServiceDriver(snap)
    drv.init_state()
    drv.run(max_steps=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = drv.snapshot()
    sync_s = time.perf_counter() - t0
    disk = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    state_bytes = sum(t.numel() * t.element_size() for t in drv.state)
    drv.run(max_steps=1)  # step 9: the async snapshot below is its own
    drv.cfg = dataclasses.replace(snap, snapshot_async=True)
    t0 = time.perf_counter()
    drv.snapshot()
    async_s = time.perf_counter() - t0
    drv.join_snapshot_writer()
    async_total_s = time.perf_counter() - t0
    want = drv.host_state()
    drv.close()
    fresh = ServiceDriver(snap)
    t0 = time.perf_counter()
    ok = fresh.restore_latest()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = ok and fresh.step == 9 and all(
        a.tobytes() == b.tobytes() for a, b in zip(fresh.host_state(), want))
    if not same:
        raise RuntimeError("restored state differs from the snapshot's")
    return {"state_mb": state_bytes / 1e6, "disk_mb": disk / 1e6,
            "sync_snapshot_s": sync_s, "async_snapshot_loop_s": async_s,
            "async_snapshot_total_s": async_total_s,
            "restore_s": restore_s}


def main() -> int:
    from mpi_grid_redistribute_tpu_torch import _device
    from mpi_grid_redistribute_tpu_torch.service import DriverConfig

    _device.resolve(None)
    n_local = int(os.environ.get("BENCH_N_LOCAL", 1 << 20))
    cfg = DriverConfig(grid_shape=GRID, n_local=n_local, fill=0.8, seed=0)
    legs = {}
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as work:
        for name, kw in (
                ("eager", dict(chunk=1)),
                ("chunked", dict(chunk=CHUNK)),
                ("pipelined", dict(chunk=CHUNK, pipeline=True)),
                ("chunked_store", dict(chunk=CHUNK, store_dir=os.path.join(
                    work, "store_c"))),
                ("pipelined_store", dict(chunk=CHUNK, pipeline=True,
                                         store_dir=os.path.join(
                                             work, "store_p")))):
            legs[name] = time_leg(dataclasses.replace(cfg, **kw), SEG, REPS)
            common.log(f"service driver {name}: {json.dumps(legs[name])}")
        snap = time_snapshot(cfg, work)
    common.log(f"service driver snapshot: {json.dumps(snap)}")
    live = int(cfg.fill * n_local) * 8
    print(json.dumps({"grid": GRID, "n_local": n_local, "fill": cfg.fill,
                      "rows_live": live, "chunk": CHUNK, "seg": SEG,
                      "legs": legs, "snapshot": snap}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
