"""Shared pieces of the service-driver tests: the two packages' drivers
built from one config, supervised runs over a shared recorder, and the
journal in the form two runs are compared in (every event kind in order,
every field but wall times and paths, numbers inside reason strings
masked where they are wall times)."""

import dataclasses
import re

import numpy as np
import torch

from mpi_grid_redistribute_tpu import service as jservice
from mpi_grid_redistribute_tpu.telemetry import StepRecorder as JRecorder
from mpi_grid_redistribute_tpu.telemetry import health as jhealth
from mpi_grid_redistribute_tpu_torch import service as tservice
from mpi_grid_redistribute_tpu_torch.telemetry import StepRecorder
from mpi_grid_redistribute_tpu_torch.telemetry import health as thealth

torch.set_num_threads(1)

# 16 ranks: more than the reference's 8 forced CPU devices, so its jax
# backend runs them as vranks on one device, as the port does
GRID = (2, 2, 4)

# fields that hold a wall time (or a figure derived from one) or a path
WALL_KEYS = frozenset({
    "seconds", "cadence_s", "path", "cost_s", "projected_saving_s",
    "realized_saving_s", "wall_s", "duration_s",
})
_FLOAT = re.compile(r"\d+\.\d+")
# health rules that read wall times: under a loaded test run they fire
# at different boundaries in two runs of the same trajectory
WALL_RULES = frozenset({"step_time_spike", "snapshot_staleness"})


def steady_monitor(mod, rec):
    """A monitor of ``mod``'s package over ``rec`` with the stock rules
    but the wall-time ones."""
    h = jhealth if mod is jservice else thealth
    return h.HealthMonitor(rec, rules=[
        r for r in h.default_rules() if r.name not in WALL_RULES])


def cfg_pair(backend, **kw):
    """``(reference config, port config)`` for one run. ``backend`` is
    ``"numpy"`` (both oracle loops) or ``"torch"`` (the reference's jax
    backend against the port's torch backend on the CPU)."""
    base = dict(grid_shape=GRID, n_local=256, steps=24, seed=3)
    base.update(kw)
    if backend == "numpy":
        return (jservice.DriverConfig(backend="numpy", **base),
                tservice.DriverConfig(backend="numpy", **base))
    return (jservice.DriverConfig(backend="jax", **base),
            tservice.DriverConfig(backend="torch", device="cpu", **base))


def host(state):
    """Host arrays of a driver state (tensors or NumPy arrays)."""
    return tuple(a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                 for a in state)


def run_driver(mod, cfg, faults=None, restore=False):
    drv = mod.ServiceDriver(cfg, faults=faults)
    if not (restore and drv.restore_latest()):
        drv.init_state()
    drv.run()
    drv.close()
    return drv, host(drv.state)


def assert_same_bytes(a, b, what=""):
    for name, x, y in zip(("pos", "vel", "ids", "count"), a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        assert x.tobytes() == y.tobytes(), f"{what}: {name} diverged"


def _norm(v):
    if isinstance(v, str):
        return _FLOAT.sub("#", v)
    if isinstance(v, float):
        return v
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items() if k not in WALL_KEYS}
    return v


def journal(rec, kinds=None):
    """The comparable journal: ``[(kind, fields)]`` in order, wall-time
    and path fields dropped, decimals in strings masked, ``step_time``
    (a wall time only) left out."""
    out = []
    for e in rec.events():
        if e.kind == "step_time" or (kinds and e.kind not in kinds):
            continue
        out.append((e.kind, _norm(dict(e.data))))
    return out


def assert_same_journal(jrec, trec, kinds=None):
    a, b = journal(jrec, kinds), journal(trec, kinds)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x == y, f"event {i}: reference {x}\nport {y}"
    assert len(a) == len(b), (len(a), len(b))


def supervised(mod, cfg, faults, max_restarts=5, **policy_kw):
    """A supervisor over fresh drivers of ``mod`` (either package) that
    share one recorder and one fault plan, each with a
    :func:`steady_monitor`; no backoff sleeps."""
    rec = (JRecorder if mod is jservice else StepRecorder)()

    def factory(grid_shape=None):
        c = cfg
        if grid_shape is not None:
            c = dataclasses.replace(c, grid_shape=tuple(grid_shape))
        return mod.ServiceDriver(c, recorder=rec, faults=faults,
                                 monitor=steady_monitor(mod, rec))

    sup = mod.Supervisor(
        factory,
        policy=mod.RestartPolicy(
            max_restarts=max_restarts, backoff_base_s=0.01,
            backoff_cap_s=0.02, **policy_kw,
        ),
        recorder=rec,
        sleep_fn=lambda s: None,
    )
    return sup, rec


def reference_state(mod, cfg):
    """The uninterrupted trajectory: snapshots, journal and watchdog
    off (none may change the state)."""
    c = dataclasses.replace(cfg, snapshot_every=0, snapshot_dir=None,
                            journal_dir=None, watchdog_s=0.0)
    return run_driver(mod, c)[1]
