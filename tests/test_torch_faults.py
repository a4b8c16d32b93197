"""The port's fault injectors (``service/faults.py``) under its supervisor
against the JAX package's, on the CPU: each of the eight kinds is
injected into the same supervised run of both packages, and the
verdict, the journal (every event kind in order, every field that is not
a wall time or a path) and the recovered state are the reference's. On
the ``"numpy"`` backend both run the oracle loop; on ``"torch"`` the
port's torch backend (chunks of 4) runs against the reference's jax
backend on a grid of more than its 8 forced CPU devices, where it runs
vranks on one device too. Also ``FaultPlan.seeded`` against the
reference's schedules and the injectors' own contracts."""

import dataclasses

import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu import service as jservice
from mpi_grid_redistribute_tpu_torch import service as tservice
from mpi_grid_redistribute_tpu_torch.service import faults
from torch_service_cases import (
    assert_same_bytes, assert_same_journal, cfg_pair, host, journal,
    reference_state, supervised,
)

KINDS = ("crash", "stall", "torn_snapshot", "journal_loss",
         "fallback_flood", "latency_spike", "state_corruption",
         "device_loss")

# a grid of 32 ranks: its shrink (2, 2, 4) still has more ranks than the
# reference's 8 CPU devices, so the reference stays on vranks
WIDE = (2, 4, 4)


def _plan(mod, kind, backend):
    """``(fault plan, expected restarts, config extras, policy extras)``
    for one kind, mirroring the reference's fault matrix."""
    F = mod
    extra, policy = {}, {}
    if kind == "crash":
        faults_, restarts = [F.CrashFault(9)], 1
    elif kind == "stall":
        # on the jax backend a first compile must not look like a stall
        secs, budget = (0.5, 0.2) if backend == "numpy" else (6.0, 5.0)
        faults_, restarts = [F.StallFault(7, seconds=secs)], 1
        extra["watchdog_s"] = budget
    elif kind == "torn_snapshot":
        faults_, restarts = [F.TornSnapshotFault(snapshot_index=1)], 1
    elif kind == "journal_loss":
        faults_, restarts = [F.JournalShardLossFault(6)], 0
    elif kind == "fallback_flood":
        faults_, restarts = [F.FallbackFloodFault(start_step=1, steps=24)], 0
    elif kind == "latency_spike":
        # spikes far above any real step, so the SLO sees only them
        faults_ = [F.LatencySpikeFault(2, seconds=50.0, spikes=6)]
        restarts = 2
        extra.update(grid_shape=WIDE, steps=32, slo_latency_p99_s=10.0,
                     slo_window=4)
        policy["shrink_after"] = 2
    elif kind == "state_corruption":
        faults_, restarts = [F.StateCorruptionFault(6, rows=5)], 1
        extra["probes"] = "counters"
    else:
        faults_ = [F.CrashFault(9), F.DeviceLossFault(16)]
        restarts = 1
        extra["grid_shape"] = WIDE
    return F.FaultPlan(faults_), restarts, extra, policy


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("kind", KINDS)
def test_fault_matrix_matches_reference(tmp_path, kind, backend):
    runs = {}
    for name, mod in (("reference", jservice), ("port", tservice)):
        plan, restarts, extra, policy = _plan(mod, kind, backend)
        kw = dict(snapshot_every=4,
                  snapshot_dir=str(tmp_path / name / "snaps"), **extra)
        if kind == "journal_loss":
            kw["journal_dir"] = str(tmp_path / name / "journal")
        if backend == "torch":
            kw["chunk"] = 4
        cfg = cfg_pair(backend, **kw)[name == "port"]
        sup, rec = supervised(mod, cfg, plan, **policy)
        verdict = sup.run()
        runs[name] = (sup, rec, verdict, cfg)
    (jsup, jrec, jv, jcfg), (sup, rec, v, cfg) = (runs["reference"],
                                                 runs["port"])
    assert v.ok is True and v.gave_up is False, v
    assert v.restarts == restarts and v.step == cfg.steps
    assert (v.ok, v.restarts, v.gave_up, v.step, v.health) == (
        jv.ok, jv.restarts, jv.gave_up, jv.step, jv.health)
    counts = rec.counts()
    assert counts.get("fault_injected") == (2 if kind == "device_loss"
                                            else 1)
    assert counts.get("restart", 0) == restarts + (kind == "latency_spike")
    assert_same_journal(jrec, rec)
    got, want = host(sup.driver.state), host(jsup.driver.state)
    if kind in ("latency_spike", "device_loss"):
        # restored onto a smaller grid: the particle SET is the
        # uninterrupted run's
        assert tuple(sup.driver.cfg.grid_shape) == (2, 2, 4)
        assert len(rec.events("reshard")) == 1
        ref = reference_state(tservice, cfg)
        assert tservice.particle_set(*got) == tservice.particle_set(*ref)
        assert tservice.particle_set(*got) == jservice.elastic.particle_set(
            *want)
    else:
        assert_same_bytes(got, want, kind)
        if backend == "numpy" or kind != "fallback_flood":
            assert_same_bytes(got, reference_state(tservice, cfg), kind)
    if kind == "fallback_flood":
        assert sup.driver.degraded and sup.driver.engine == "planar"
        assert len(rec.events("degrade")) == 1
    if kind == "state_corruption":
        bursts = [e for e in rec.events("state_health")
                  if e.data["nan_pos"] > 0]
        assert bursts and bursts[0].data["nan_pos"] == 5


def test_state_corruption_writes_nan_into_the_device_tensor():
    """The torch backend's state is a tensor: the injector replaces it
    with a corrupted copy (the old tensor, which a snapshot may hold, is
    untouched) and journals before the damage."""
    _, cfg = cfg_pair("torch", grid_shape=(2, 2, 2), n_local=64)
    drv = tservice.ServiceDriver(cfg)
    drv.init_state()
    before = drv.state[0]
    keep = before.clone()
    f = faults.StateCorruptionFault(0, rows=3)
    f.before_step(drv)
    pos = drv.state[0]
    assert isinstance(pos, torch.Tensor) and pos is not before
    assert torch.isnan(pos[:3]).all() and not torch.isnan(pos[3:]).any()
    assert torch.equal(before, keep)
    assert drv.recorder.last("fault_injected").data == {
        "fault": "state_corruption", "step": 0, "rows": 3}
    f.before_step(drv)  # fires once
    assert drv.recorder.counts()["fault_injected"] == 1
    with pytest.raises(ValueError, match="rows must be >= 1"):
        faults.StateCorruptionFault(3, rows=0)


@pytest.mark.parametrize("seed,steps,kinds", [
    (7, 30, None), (8, 30, None), (0, 2, None), (3, 5, KINDS),
    (11, 40, KINDS), (2, 9, ("crash", "latency_spike", "device_loss")),
])
def test_seeded_plan_is_the_references(seed, steps, kinds):
    kw = {} if kinds is None else {"kinds": kinds}
    a = tservice.FaultPlan.seeded(seed, steps, **kw)
    b = jservice.FaultPlan.seeded(seed, steps, **kw)

    def sig(plan):
        return [(type(f).__name__, {k: v for k, v in vars(f).items()
                                    if not k.startswith("_")})
                for f in plan.faults]

    assert sig(a) == sig(b)
    assert sig(tservice.FaultPlan.seeded(seed, steps, **kw)) == sig(a)
    if kinds is None and steps == 30:
        assert len(a.faults) == 5


def test_seeded_plan_refusals_match_reference():
    for mod in (tservice, jservice):
        with pytest.raises(ValueError, match="steps must be >= 2"):
            mod.FaultPlan.seeded(0, 1)
        with pytest.raises(ValueError, match="unknown fault kind 'bogus'"):
            mod.FaultPlan.seeded(0, 10, kinds=("bogus",))
    with pytest.raises(ValueError, match="devices must be >= 1"):
        faults.DeviceLossFault(0)


def test_next_step_bounds_every_injector():
    """``FaultPlan.next_step`` (what splits the driver's chunks) answers
    as the reference's for every injector at every step."""
    def plans(mod):
        return mod.FaultPlan([
            mod.CrashFault(9), mod.StallFault(5, 0.1),
            mod.JournalShardLossFault(6), mod.FallbackFloodFault(3, 4),
            mod.LatencySpikeFault(12, spikes=2),
            mod.StateCorruptionFault(14), mod.DeviceLossFault(2),
            mod.TornSnapshotFault(),
        ])

    a, b = plans(tservice), plans(jservice)
    assert [a.next_step(s) for s in range(20)] == [
        b.next_step(s) for s in range(20)]
    assert tservice.FaultPlan().next_step(0) is None
    assert not tservice.FaultPlan()
    assert tservice.FaultPlan([tservice.CrashFault(None)]).next_step(4) == 4


def test_crash_loop_journal_matches_reference(tmp_path):
    """``CrashFault(None)`` crashes every attempt until the breaker
    trips: the same verdict and restart journal as the reference."""
    out = []
    for mod in (jservice, tservice):
        cfg = cfg_pair("numpy", steps=12, snapshot_every=4,
                       snapshot_dir=str(tmp_path / mod.__name__))[
            mod is tservice]
        sup, rec = supervised(mod, cfg, mod.FaultPlan([mod.CrashFault(None)]),
                              max_restarts=3)
        v = sup.run()
        out.append((v, journal(rec)))
    (jv, jj), (v, j) = out
    assert v.gave_up and not v.ok and v.restarts == 3
    assert "circuit breaker" in v.reason
    assert v._asdict() == jv._asdict()
    assert j == jj
    assert [e[1]["action"] for e in j if e[0] == "restart"] == [
        "restart"] * 3 + ["give_up"]


def test_hard_crash_exits_the_process(monkeypatch):
    """``hard=True`` journals, then calls ``os._exit`` with its code."""
    codes = []

    def fake_exit(code):
        codes.append(code)
        raise SystemExit(code)

    monkeypatch.setattr(faults.os, "_exit", fake_exit)
    _, cfg = cfg_pair("numpy", grid_shape=(2, 2, 2), n_local=64)
    drv = tservice.ServiceDriver(cfg)
    drv.init_state()
    with pytest.raises(SystemExit):
        faults.CrashFault(0, hard=True, exit_code=7).before_step(drv)
    assert codes == [7]
    assert drv.recorder.last("fault_injected").data["hard"] is True


def test_torn_snapshot_truncates_the_committed_shard(tmp_path):
    _, cfg = cfg_pair("numpy", grid_shape=(2, 2, 2), n_local=64,
                      snapshot_every=2, snapshot_dir=str(tmp_path / "s"),
                      steps=6)
    f = tservice.TornSnapshotFault(snapshot_index=0, shard=3)
    drv = tservice.ServiceDriver(cfg, faults=tservice.FaultPlan([f]))
    drv.init_state()
    with pytest.raises(tservice.InjectedCrash, match="torn snapshot"):
        drv.run()
    drv.abandon()
    from mpi_grid_redistribute_tpu_torch.utils import checkpoint

    with pytest.raises(checkpoint.CheckpointCorruptError) as ei:
        checkpoint.load(str(tmp_path / "s" / "step_00000002"))
    assert ei.value.shard == "shard_00003.npz"
    assert dataclasses.asdict(cfg)["snapshot_every"] == 2
    assert np.isfinite(host(drv.state)[0]).all()
