"""Run one cell of the benchmark once and print its line.

    python -m benchmark.run --workload <config>.<mix> --seed <n> \\
        --seconds <s> --trace <0|1> [--control drift_bf16|deposit_f32|bin_bf16]

On one card the run is this process; a cell on several cards starts one
process a card (``--rank`` and the other child options below), joined
over NCCL, and rank 0's numbers make the line. ``--trace 0`` prints the
end-to-end metrics, ``--trace 1`` the per-layer ones from a profiled
window of at most :data:`.worker.TRACE_SECONDS`. ``--control`` puts the
reference in the program's place with one stage in a lower precision (the
drift in bfloat16, or the density summed in float32; in a cell of the
one-shot call, the owners binned from positions in bfloat16): the
comparison's controls, whose lines have to read ``"correct": false``.

The last line of standard output is one JSON object; the numbers the
comparison judged, each beside its limit, are the last lines of standard
error and the line's last key, ``checks``. Without the cards the cell
asks for, the run fails and prints no line.
"""

import time

T0 = time.time()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from benchmark import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mpi_grid_redistribute_tpu")
CHILD_TIMEOUT_S = 330.0
GIB = float(1 << 30)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def _parser():
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control",
                    choices=("drift_bf16", "deposit_f32", "bin_bf16"))
    # a child of a run on several cards
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    return ap


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_child(args, cell) -> int:
    """One card's process of a run on several cards."""
    import torch
    import torch.distributed as dist

    from benchmark import program, worker

    torch.cuda.set_device(args.rank)
    device = torch.device("cuda", args.rank)
    program.initialize_distributed(args.port, args.world, args.rank)
    try:
        mesh = program.make_mesh(cell)
        comm = worker.Group(args.rank, args.world)
        res = worker.run_rank(cell, args.seed, args.seconds, bool(args.trace),
                              args.rank, comm, device, control=args.control,
                              mesh=mesh)
        res["forbidden"] = forbidden_modules()
        Path(args.out).write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()
    return 0


def spawn(args, cell) -> list:
    """Start one process a card, wait for all, return their results in
    rank order; raise if any fails or the time runs out."""
    tmp = tempfile.mkdtemp(prefix="bench-")
    port = _free_port()
    root = Path(__file__).resolve().parents[1]
    base = [sys.executable, "-m", "benchmark.run", "--workload",
            args.workload, "--seed", str(args.seed), "--seconds",
            str(args.seconds), "--trace", str(args.trace), "--world",
            str(cell.chips), "--port", str(port)]
    if args.control:
        base += ["--control", args.control]
    procs = []
    try:
        for r in range(cell.chips):
            procs.append(subprocess.Popen(
                base + ["--rank", str(r), "--out", f"{tmp}/{r}.json"],
                cwd=root, stdout=sys.stderr.fileno()))
        deadline = time.time() + CHILD_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            bad = [p.returncode for p in procs if p.poll() not in (None, 0)]
            if bad or time.time() > deadline:
                raise RuntimeError(f"a card's process failed (exit codes "
                                   f"{[p.poll() for p in procs]})")
            time.sleep(0.2)
        codes = [p.returncode for p in procs]
        if any(codes):
            raise RuntimeError(f"a card's process failed (exit codes {codes})")
        return [json.loads(Path(f"{tmp}/{r}.json").read_text())
                for r in range(cell.chips)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def run_local(args, cell, device) -> list:
    from benchmark import worker

    return [worker.run_rank(cell, args.seed, args.seconds, bool(args.trace),
                            0, worker.Solo(), device, control=args.control)]


def assemble(cell, traced: bool, results: list, t0: float) -> dict:
    """The line: rank 0's numbers, memory and busy time over the cards.
    The throughput and the tail carry the cell's ``metric_suffix``."""
    r0 = results[0]
    checks = r0["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    mem = [max(r.get("mem_setup", 0), r.get("mem_window", 0))
           for r in results]
    device = {"platform": "gpu" if "kind" in r0 else "cpu",
              "kind": r0.get("kind", "cpu"), "count": cell.chips,
              "memory_peak_bytes": max(mem)}
    line = {"correct": correct, "attempted": r0["calls"],
            "failed": 0 if correct else r0["calls"]}
    if traced:
        busy = float(np.mean([r["busy_s"] for r in results]))
        window = float(np.mean([r["trace_window_s"] for r in results]))
        device.update(busy_s=busy, window_s=window)
        line.update(metrics=r0["metrics"], device=device,
                    breakdown=r0["breakdown"])
    else:
        steps, sfx = r0["steps"], cell.metric_suffix
        metrics = {
            "particles_per_s" + sfx: {
                "value": cell.live_total * steps / r0["window_s"]
                / cell.chips, "unit": "particles/s"},
            "call_ms_p95" + sfx: {
                "value": float(np.percentile(r0["call_ms"], 95)),
                "unit": "ms"},
            "peak_mem_gib": {
                "value": max(r.get("mem_window", 0) for r in results) / GIB,
                "unit": "GiB"},
            "setup_s": {"value": r0["setup_end"] - t0, "unit": "s"},
        }
        line.update(metrics=metrics, device=device)
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    cell = spec.load_cell(args.workload)
    import torch

    torch.set_num_threads(1)  # the loop's host work is one thread's
    if args.rank is not None:
        return run_child(args, cell)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell.chips} CUDA card(s), {n} visible: "
            f"no result")
        return 2
    if cell.chips == 1:
        torch.cuda.set_device(0)
        results = run_local(args, cell, torch.device("cuda", 0))
    else:
        results = spawn(args, cell)
    bad = sorted(set(forbidden_modules()).union(
        *(r.get("forbidden", []) for r in results)))
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {bad}; "
            f"no result")
        return 3
    line = assemble(cell, bool(args.trace), results, T0)
    r0 = results[0]
    ms = np.asarray(r0["call_ms"])
    log(f"{args.workload} seed {args.seed}: {r0['calls']} calls of "
        f"{cell.steps_per_call} steps in {r0['window_s']:.3f} s; call ms "
        f"median {np.median(ms):.3f}, max {ms.max():.3f} (call "
        f"{int(ms.argmax())}), first "
        f"{np.round(ms[:4], 3).tolist()}; warm call "
        f"{r0['warm_call_s'] * 1e3:.2f} ms; kernel launches a step "
        f"{r0.get('launches_per_step')}")
    for name, c in line["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
