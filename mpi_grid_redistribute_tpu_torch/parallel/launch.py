"""Start a world of ranks, one process each, and collect their results:
the counterpart of ``mpirun -n W`` (the reference runs its ranks as
devices of one program; this port runs them as processes).

:func:`run_world` starts ``W`` fresh interpreters (``python -m`` this
module, not ``fork``, and importing only the target's module), joins them
with a file rendezvous over ``backend``, calls ``target(ctx, *args)`` on
every rank with a :class:`RankContext`, and returns the ranks' results in
rank order. A rank that raises, exits or outlasts ``timeout`` fails the
whole call: the others are killed and the parent raises with the failing
rank's traceback. The process group itself gets a finite timeout too, so
a rank waiting on a collective that a peer never reaches gives up.

Run as a module, this file is that child entry point.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, List, Sequence


@dataclasses.dataclass(frozen=True)
class RankContext:
    """What a rank's target is told: its ``rank`` and the ``world_size``,
    the group's ``backend``, and its ``device`` (``cuda:{rank %
    device_count}`` for ``device="cuda"``)."""

    rank: int
    world_size: int
    backend: str
    device: Any


class RankFailed(RuntimeError):
    """A rank of a :func:`run_world` world failed (raised, died or timed
    out); the message carries its traceback or log."""


def _resolve(target: str):
    module, _, name = target.partition(":")
    if not name:
        raise ValueError(f"target must be 'module:function', got {target!r}")
    obj = importlib.import_module(module)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _tail(path: str, limit: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return ""
    return data[-limit:].decode("utf-8", "replace")


def run_world(target: str, world_size: int, *, args: Sequence = (),
              backend: str = "gloo", device: str = "cuda",
              timeout: float = 120.0,
              pg_timeout: float = None, nice: int = 0) -> List[Any]:
    """Run ``target`` (``"module:function"``, importable in a fresh
    interpreter) on ``world_size`` ranks; return their results in rank
    order. ``args`` (picklable) go to every rank after the
    :class:`RankContext`. The ranks run on the GPU (``cuda:{rank %
    device_count}``) unless ``device`` says otherwise (``"cpu"``); without
    a visible GPU ``device="cuda"`` raises before any rank starts.
    ``timeout`` bounds the whole world in seconds; ``pg_timeout``
    (default: ``timeout``) bounds each collective; ``nice`` raises the
    ranks' niceness (they start on the cores the caller leaves idle).
    Raises
    :class:`RankFailed` if any rank fails or the world outlasts
    ``timeout``; no process outlives the call."""
    world_size = int(world_size)
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    if str(device) == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "run_world: device='cuda' but no CUDA device is visible; "
                "pass device='cpu' to run the ranks on the CPU")
    workdir = tempfile.mkdtemp(prefix="rank_world_")
    spec = {
        "target": target,
        "args": tuple(args),
        "world_size": world_size,
        "backend": backend,
        "device": device,
        "init_file": os.path.join(workdir, "rendezvous"),
        "pg_timeout": float(timeout if pg_timeout is None else pg_timeout),
        "sys_path": list(sys.path),
        "workdir": workdir,
        "nice": int(nice),
    }
    spec_path = os.path.join(workdir, "spec.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    child_env = dict(os.environ)
    child_env.setdefault("OMP_NUM_THREADS", "1")
    # the package's parent directory, so ``-m`` finds this module from
    # any working directory
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    child_env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = []
    logs = []
    try:
        for r in range(world_size):
            log = open(os.path.join(workdir, f"rank{r}.log"), "wb")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, spec_path, str(r)],
                stdout=log, stderr=subprocess.STDOUT, env=child_env,
            ))
        deadline = time.monotonic() + float(timeout)
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                # a peer of the failing rank fails in turn (its collective
                # loses the connection): give the others a moment, then
                # report every failed rank, the root cause among them
                time.sleep(1.0)
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes)
                          if c not in (None, 0)]
                raise RankFailed("\n".join(
                    f"rank {r} of {world_size} exited with code "
                    f"{codes[r]}:\n{_error_of(workdir, r)}" for r in failed
                ))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                running = [r for r, c in enumerate(codes) if c is None]
                raise RankFailed(
                    f"world of {world_size} did not finish in {timeout} s; "
                    f"ranks still running: {running}\n"
                    + "\n".join(f"--- rank {r} log:\n{_tail(logs[r].name)}"
                                for r in running[:2])
                )
            time.sleep(0.02)
        results = []
        for r in range(world_size):
            with open(os.path.join(workdir, f"rank{r}.out"), "rb") as f:
                results.append(pickle.load(f)[1])
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(workdir, ignore_errors=True)


def _error_of(workdir: str, r: int) -> str:
    try:
        with open(os.path.join(workdir, f"rank{r}.out"), "rb") as f:
            status, payload = pickle.load(f)
        if status == "error":
            return payload
    except (OSError, EOFError, pickle.UnpicklingError):
        pass
    return _tail(os.path.join(workdir, f"rank{r}.log"))


def _child(spec_path: str, rank: int) -> int:
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    if spec.get("nice"):
        os.nice(spec["nice"])
    for p in reversed(spec["sys_path"]):
        if p not in sys.path:
            sys.path.insert(0, p)
    out_path = os.path.join(spec["workdir"], f"rank{rank}.out")
    import torch
    import torch.distributed as dist

    from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    status, payload = "ok", None
    try:
        mesh_lib.initialize_distributed(
            spec["backend"], init_method="file://" + spec["init_file"],
            world_size=spec["world_size"], rank=rank,
            timeout=spec["pg_timeout"],
        )
        ctx = RankContext(rank, spec["world_size"], spec["backend"],
                          mesh_lib.rank_device(spec["device"], rank))
        payload = _resolve(spec["target"])(ctx, *spec["args"])
    except BaseException:  # reported to the parent, which re-raises
        status, payload = "error", traceback.format_exc()
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump((status, payload), f)
    os.replace(out_path + ".tmp", out_path)
    if status == "error":
        sys.stderr.write(payload)
        sys.stderr.flush()
        os._exit(1)  # skip teardown: a peer may be stuck in a collective
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1], int(sys.argv[2])))
