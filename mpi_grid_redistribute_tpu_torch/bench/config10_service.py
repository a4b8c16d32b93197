"""Config 10: the chunked service step, eager against chunked (the twin
of the JAX package's ``bench/config10_service.py``).

What the per-step host round trip costs: the eager
:class:`~..service.driver.ServiceDriver` loop issues one step at a time
and reads its two dropped counters back every step (the port keeps the
state on the device, so this is one small host read a step, not the
reference's full round trip of the state); the chunked loop
(:mod:`~..service.resident`) issues ``chunk`` steps at a time and reads
the host only at chunk boundaries. Both legs run through the SAME public
driver, only ``cfg.chunk`` differs.

Shape (the reference's): a ``(1, 1, 8)`` slab grid as 8 vranks on one
device, ``BENCH_SERVICE_ROWS`` host rows (default 4096, 512 a vrank),
fill 0.8, the neighbor engine: the service shape where host overhead is
a real fraction of the step. ``BENCH_SERVICE_ROWS=8388608`` (2^20 rows a
vrank, 6,710,886 live) is the bench width. The reference measures in a
subprocess only to strip XLA's CPU-device forcing; the port has no such
flag and measures in-process.

Legs:

* ``service_pps``: the largest chunk of ``BENCH_SERVICE_CHUNKS``
  (default ``16,64``), min of ``BENCH_SERVICE_K`` segments of
  ``BENCH_SERVICE_SEG`` steps (a multiple of every chunk);
  ``speedup_vs_eager`` against ``chunk=1``;
* ``pipeline_pps``: the same chunk with ``pipeline`` on;
  ``pipeline_speedup`` over the sequential chunk;
* ``probe_overhead``: the paired-delta median cost of
  ``probes="counters"`` against ``"off"`` at the head chunk
  (alternating order, GC off, min of 3 segments a side, best of two
  batches);
* ``bit_identical``: the final particle set of eager, a chunk of 7 that
  does not divide the 24-step horizon, and that chunk pipelined.

``--gate`` fails (exit 1) when ``speedup_vs_eager`` <
``SERVICE_SPEEDUP_MIN`` (1.5), ``pipeline_speedup`` <
``SERVICE_PIPELINE_MIN`` (1.1), ``probe_overhead`` > ``SERVICE_PROBE_MAX``
(0.02), or the legs' particle sets differ.

    python -m mpi_grid_redistribute_tpu_torch.bench.config10_service [--gate]

It runs on the GPU and raises without one (``--device cpu`` runs the
plain versions on the CPU).
"""

from __future__ import annotations

import gc
import json
import math
import os
import sys
import time

import numpy as np

from mpi_grid_redistribute_tpu_torch.bench import common
from mpi_grid_redistribute_tpu_torch.telemetry import regress


def _knobs() -> dict:
    grid = tuple(
        int(x)
        for x in os.environ.get("BENCH_SERVICE_GRID", "1,1,8").split(",")
    )
    rows = int(os.environ.get("BENCH_SERVICE_ROWS", 4096))
    return {
        "grid": grid,
        "rows": rows,
        "n_local": rows // math.prod(grid),
        "engine": os.environ.get("BENCH_SERVICE_ENGINE", "neighbor"),
        "k": int(os.environ.get("BENCH_SERVICE_K", 5)),
        "seg": int(os.environ.get("BENCH_SERVICE_SEG", 128)),
        "chunks": tuple(
            int(x)
            for x in os.environ.get("BENCH_SERVICE_CHUNKS", "16,64").split(",")
        ),
    }


def _make_driver(kn, chunk: int, steps: int, device, pipeline: bool = False,
                 probes: str = "off"):
    from mpi_grid_redistribute_tpu_torch.service import (
        DriverConfig,
        ServiceDriver,
    )

    cfg = DriverConfig(
        grid_shape=kn["grid"],
        n_local=kn["n_local"],
        steps=steps,
        seed=13,
        backend="torch",
        device=device,
        engine=kn["engine"],
        chunk=chunk,
        pipeline=pipeline,
        probes=probes,
        snapshot_every=0,
        health_every=0,
        watchdog_s=0.0,
    )
    return ServiceDriver(cfg)


def _measure_pps(kn, chunk: int, device, pipeline: bool = False) -> dict:
    """Min-of-k segment timing of the full driver loop at one chunk."""
    seg, k = kn["seg"], kn["k"]
    if seg % chunk:
        raise ValueError(
            f"BENCH_SERVICE_SEG={seg} must be a multiple of chunk {chunk} "
            "(a partial trailing chunk would bill a second macro-step "
            "shape to the steady-state sample)"
        )
    warm = max(8, 2 * chunk)
    drv = _make_driver(kn, chunk, warm + k * seg, device, pipeline=pipeline)
    drv.init_state()
    drv.run(max_steps=warm)  # first builds, caches and the calibration

    def _segment() -> float:
        t0 = time.perf_counter()
        drv.run(max_steps=seg)
        return (time.perf_counter() - t0) / seg

    sample = regress.min_of_k(_segment, k=k)
    live = int(drv.cfg.fill * kn["n_local"]) * math.prod(kn["grid"])
    drv.close()
    return {
        "pps": live / sample["min"],
        "ms_per_step": sample["min"] * 1e3,
        "spread": sample["spread"],
        "k": sample["k"],
        "rows_live": live,
    }


def _probe_overhead(kn, device) -> dict:
    """The counters-tier probe's cost at the head chunk: alternating-order
    base/probed pairs with GC held off, median relative delta, best of two
    batches; each side of a pair the min of 3 segments."""
    seg = kn["seg"]
    chunk = max(kn["chunks"])
    warm = max(8, 2 * chunk)
    reps = 3
    steps = warm + (2 * 9 * reps + 2) * seg
    base = _make_driver(kn, chunk, steps, device, probes="off")
    obs = _make_driver(kn, chunk, steps, device, probes="counters")
    for drv in (base, obs):
        drv.init_state()
        drv.run(max_steps=warm)

    def sample(observe: bool) -> float:
        drv = obs if observe else base
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            drv.run(max_steps=seg)
            best = min(best, time.perf_counter() - t0)
        return best

    def batch_median():
        deltas = []
        gc.collect()
        gc.disable()
        try:
            for i in range(9):
                if i % 2:
                    o = sample(True)
                    b = sample(False)
                else:
                    b = sample(False)
                    o = sample(True)
                deltas.append((o - b) / b)
        finally:
            gc.enable()
        return float(np.median(deltas)), deltas

    overhead, deltas = batch_median()
    if overhead > 0.02:
        # confirm before reporting: a real regression reproduces
        overhead2, deltas2 = batch_median()
        if overhead2 < overhead:
            overhead, deltas = overhead2, deltas2
    probed_events = len(obs.recorder.events("state_health"))
    base.close()
    obs.close()
    return {
        "overhead": overhead,
        "pairs": len(deltas),
        "events": probed_events,
    }


def _bit_identity(kn, device) -> bool:
    """Final particle SET of eager, a chunk of 7 (splits at the 24-step
    horizon) and the same chunk pipelined."""
    from mpi_grid_redistribute_tpu_torch.service import elastic

    steps = 24
    states = []
    for chunk, pipeline in ((1, False), (7, False), (7, True)):
        drv = _make_driver(kn, chunk, steps, device, pipeline=pipeline)
        drv.init_state()
        drv.run()
        states.append(elastic.particle_set(*drv.state))
        drv.close()
    return all(s == states[0] for s in states[1:])


def run(device=None) -> dict:
    """One service capture: the reference's keys (``n_devices`` is the
    driver's one device)."""
    from mpi_grid_redistribute_tpu_torch import _device

    dev = _device.resolve(device)
    kn = _knobs()
    eager = _measure_pps(kn, 1, dev)
    by_chunk = {c: _measure_pps(kn, c, dev) for c in kn["chunks"]}
    head_chunk = max(kn["chunks"])
    head = by_chunk[head_chunk]
    pipe = _measure_pps(kn, head_chunk, dev, pipeline=True)
    probe = _probe_overhead(kn, dev)
    out = {
        "metric": "service_pps",
        "value": round(head["pps"], 2),
        "unit": "particles/s",
        "grid": list(kn["grid"]),
        "rows": kn["rows"],
        "n_local_per_vrank": kn["n_local"],
        "rows_live": head["rows_live"],
        "engine": kn["engine"],
        "n_devices": 1,
        "chunk": head_chunk,
        "ms_per_step": round(head["ms_per_step"], 3),
        "timing_spread": round(head["spread"], 4),
        "timing_k": head["k"],
        "eager_pps": round(eager["pps"], 2),
        "eager_ms_per_step": round(eager["ms_per_step"], 3),
        "speedup_vs_eager": round(head["pps"] / eager["pps"], 3),
        "chunk_pps": {
            str(c): round(r["pps"], 2) for c, r in by_chunk.items()
        },
        "chunk_speedups": {
            str(c): round(r["pps"] / eager["pps"], 3)
            for c, r in by_chunk.items()
        },
        "pipeline_pps": round(pipe["pps"], 2),
        "pipeline_ms_per_step": round(pipe["ms_per_step"], 3),
        "pipeline_timing_spread": round(pipe["spread"], 4),
        "pipeline_speedup": round(pipe["pps"] / head["pps"], 3),
        "probe_overhead": round(probe["overhead"], 4),
        # 1 + overhead: the probed/unprobed cost ratio, stable around 1
        "probe_cost_factor": round(1.0 + probe["overhead"], 4),
        "probe_pairs": probe["pairs"],
        "probe_events": probe["events"],
        "bit_identical": _bit_identity(kn, dev),
    }
    common.log(
        f"config10: service {out['value']:.3e} pps at chunk="
        f"{out['chunk']} ({out['ms_per_step']:.3f} ms/step) vs eager "
        f"{out['eager_pps']:.3e} pps ({out['eager_ms_per_step']:.3f} "
        f"ms/step) -> {out['speedup_vs_eager']:.2f}x on {out['rows']} rows, "
        f"grid {out['grid']}, bit_identical={out['bit_identical']}; "
        f"pipelined {out['pipeline_pps']:.3e} pps -> "
        f"{out['pipeline_speedup']:.2f}x over the sequential chunk; probe "
        f"overhead {out['probe_overhead'] * 100:+.2f}% "
        f"({out['probe_events']} state_health events)"
    )
    return out


def service_gate(
    out: dict, min_speedup: float = 1.5, min_pipeline: float = 1.1,
    probe_max: float = 0.02,
) -> list:
    """The gate's verdict: hard failures as reasons (the reference's
    ``_service_gate``)."""
    failures = []
    if out["probe_overhead"] > probe_max:
        failures.append(
            f"counters-tier probe overhead {out['probe_overhead'] * 100:.2f}% "
            f"exceeds the {probe_max * 100:.0f}% budget "
            f"(median of {out['probe_pairs']} paired deltas)"
        )
    if out["probe_events"] < 1:
        failures.append(
            "probed leg journaled no state_health events — the probe "
            "pass never armed, so the overhead number is meaningless"
        )
    if out["speedup_vs_eager"] < min_speedup:
        failures.append(
            f"chunk={out['chunk']} speedup {out['speedup_vs_eager']:.2f}x "
            f"below the {min_speedup:.2f}x floor"
        )
    if out.get("pipeline_speedup", 0.0) < min_pipeline:
        failures.append(
            f"pipelined chunk={out['chunk']} speedup "
            f"{out.get('pipeline_speedup', 0.0):.2f}x over the sequential "
            f"chunk body is below the {min_pipeline:.2f}x floor"
        )
    if not out["bit_identical"]:
        failures.append(
            "chunked final particle set is NOT identical to the eager run"
        )
    return failures


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="config10_service")
    p.add_argument(
        "--gate", action="store_true",
        help="gate mode: assert the speedup floors and the identity",
    )
    p.add_argument(
        "--min-speedup", type=float,
        default=float(os.environ.get("SERVICE_SPEEDUP_MIN", 1.5)),
    )
    p.add_argument(
        "--min-pipeline", type=float,
        default=float(os.environ.get("SERVICE_PIPELINE_MIN", 1.1)),
    )
    p.add_argument(
        "--probe-max", type=float,
        default=float(os.environ.get("SERVICE_PROBE_MAX", 0.02)),
    )
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    out = run(device=args.device)
    print(json.dumps(out), flush=True)
    if not args.gate:
        return 0
    failures = service_gate(
        out, args.min_speedup, args.min_pipeline, args.probe_max
    )
    if failures:
        for f in failures:
            common.log(f"service-bench FAIL: {f}")
        return 1
    common.log(
        f"service-bench OK: {out['speedup_vs_eager']:.2f}x >= "
        f"{args.min_speedup:.2f}x, pipelined "
        f"{out['pipeline_speedup']:.2f}x >= {args.min_pipeline:.2f}x, "
        f"probe overhead {out['probe_overhead'] * 100:.2f}% <= "
        f"{args.probe_max * 100:.0f}%, bit-identical"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
