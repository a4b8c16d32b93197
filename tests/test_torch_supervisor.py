"""The port's ``service/supervisor.py`` against the JAX package's on the
CPU (numpy backend, the reference's own choice for these cases): the
circuit breaker's count and window edges, the seeded backoff jitter, a
red ``/healthz`` forcing restarts, the elastic restores (device loss,
an explicit grid, ``auto_reshard`` off), each with the reference's
verdict and journal."""

import dataclasses

import pytest

from mpi_grid_redistribute_tpu import service as jservice
from mpi_grid_redistribute_tpu.telemetry import StepRecorder as JRecorder
from mpi_grid_redistribute_tpu.telemetry import health as jhealth
from mpi_grid_redistribute_tpu_torch import service as tservice
from mpi_grid_redistribute_tpu_torch.telemetry import StepRecorder
from mpi_grid_redistribute_tpu_torch.telemetry import health as thealth
from torch_service_cases import (
    assert_same_bytes, cfg_pair, host, journal, reference_state,
    steady_monitor, supervised,
)

PKGS = ((jservice, JRecorder, jhealth), (tservice, StepRecorder, thealth))


class _FailFirstN:
    """Crash the first ``n`` runs at step 1, then let every run pass."""

    kind = "fail_first_n"

    def __init__(self, mod, n):
        self.mod = mod
        self.left = int(n)

    def before_step(self, driver):
        if self.left > 0 and driver.step == 1:
            self.left -= 1
            raise self.mod.InjectedCrash("scripted failure")


def _ticking_clock(spacing):
    """Each restart loop reads the same instant twice (breaker check and
    window append), instants ``spacing`` apart."""

    def gen():
        t = 0.0
        while True:
            yield t
            yield t
            t += spacing

    it = gen()
    return lambda: next(it)


def _boundary(tmp_path, n_failures, policy_kw, clock_fn):
    """Both packages' verdicts and journals for one scripted run."""
    out = []
    for mod, Rec, _ in PKGS:
        cfg = cfg_pair("numpy", steps=4)[mod is tservice]
        rec = Rec()
        plan = mod.FaultPlan([_FailFirstN(mod, n_failures)])
        sup = mod.Supervisor(
            lambda: mod.ServiceDriver(cfg, recorder=rec, faults=plan,
                                      monitor=steady_monitor(mod, rec)),
            policy=mod.RestartPolicy(**policy_kw),
            recorder=rec,
            sleep_fn=lambda s: None,
            clock=clock_fn(),
        )
        out.append((sup.run(), journal(rec)))
    (jv, jj), (v, j) = out
    assert v._asdict() == jv._asdict()
    assert j == jj
    return v, j


def _actions(j):
    return [d["action"] for k, d in j if k == "restart"]


@pytest.mark.parametrize("failures,ok,restarts", [(3, True, 3),
                                                  (4, False, 3)])
def test_breaker_count_boundary(tmp_path, failures, ok, restarts):
    """All failures at one instant: exactly max_restarts failures do not
    trip the breaker, one more does."""
    v, j = _boundary(tmp_path, failures, dict(
        max_restarts=3, backoff_base_s=0.01, backoff_cap_s=0.02),
        lambda: (lambda: 0.0))
    assert v.ok is ok and v.gave_up is (not ok) and v.restarts == restarts
    assert _actions(j) == ["restart"] * 3 + ([] if ok else ["give_up"])


@pytest.mark.parametrize("spacing,ok,restarts", [(10.0, True, 5),
                                                 (5.0, False, 2)])
def test_breaker_window_boundary_is_inclusive(tmp_path, spacing, ok,
                                              restarts):
    """Failures EXACTLY window_s apart keep at most one prior restart in
    view (max_restarts=2 never trips); closer ones trip it."""
    v, j = _boundary(tmp_path, 5, dict(
        max_restarts=2, window_s=10.0, backoff_base_s=0.01,
        backoff_cap_s=0.02), lambda: _ticking_clock(spacing))
    assert v.ok is ok and v.restarts == restarts


def test_backoff_jitter_deterministic_under_seed(tmp_path):
    def backoffs(seed):
        v, j = _boundary(tmp_path, 3, dict(
            max_restarts=5, backoff_base_s=0.01, backoff_cap_s=1.0,
            seed=seed), lambda: (lambda: 0.0))
        assert v.ok
        return [d["backoff_s"] for k, d in j
                if k == "restart" and d["action"] == "restart"]

    a = backoffs(7)
    assert len(a) == 3
    assert backoffs(7) == a
    assert backoffs(8) != a
    assert a == sorted(a) and all(x > 0 for x in a)
    policy = tservice.RestartPolicy(seed=7)
    import numpy as np

    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    jpolicy = jservice.RestartPolicy(seed=7)
    assert [policy.backoff_s(k, rng) for k in range(8)] == [
        jpolicy.backoff_s(k, jrng) for k in range(8)]


def test_healthz_alert_forces_restart(tmp_path):
    """A clean exit with a red ``/healthz`` is a failure: restarts, then
    the breaker; the reference's verdict and journal."""
    out = []
    for mod, Rec, health in PKGS:
        red = health.HealthRule("always_red", health.ALERT,
                                lambda rec: "synthetic alert")
        cfg = cfg_pair("numpy", steps=6)[mod is tservice]
        rec = Rec()
        sup = mod.Supervisor(
            lambda: mod.ServiceDriver(
                cfg, recorder=rec,
                monitor=health.HealthMonitor(rec, rules=[red])),
            policy=mod.RestartPolicy(max_restarts=2, backoff_base_s=0.01),
            recorder=rec, sleep_fn=lambda s: None,
        )
        out.append((sup.run(), journal(rec)))
    (jv, jj), (v, j) = out
    assert not v.ok and v.gave_up and v.health == "ALERT"
    assert "healthz 503" in v.reason
    assert v._asdict() == jv._asdict() and j == jj


def test_restore_latest_onto_explicit_grid(tmp_path):
    got = {}
    for mod in (jservice, tservice):
        d = tmp_path / mod.__name__
        cfg = cfg_pair("numpy", grid_shape=(2, 2, 2), snapshot_every=4,
                       snapshot_dir=str(d))[mod is tservice]
        drv = mod.ServiceDriver(cfg)
        drv.init_state()
        drv.run(max_steps=8)
        drv.close()
        res = mod.ServiceDriver(cfg)
        assert res.restore_latest(grid_shape=(1, 2, 2)) is True
        assert res.step == 8 and tuple(res.cfg.grid_shape) == (1, 2, 2)
        assert res.cfg.n_local == 512
        ev = dict(res.recorder.last("reshard").data)
        ev.pop("path")
        res.run()
        res.close()
        got[mod] = (ev, host(res.state), host(drv.state))
    (jev, jstate, jmid), (ev, state, mid) = got[jservice], got[tservice]
    assert ev == jev and ev["new_grid"] == [1, 2, 2]
    assert 0 < ev["moved"] <= ev["rows"]
    assert_same_bytes(state, jstate, "resharded run")
    assert_same_bytes(mid, jmid, "before the reshard")
    cfg = cfg_pair("numpy", grid_shape=(2, 2, 2))[1]
    assert tservice.particle_set(*state) == tservice.particle_set(
        *reference_state(tservice, cfg))


def test_elastic_restore_disabled_raises_naming_both_shapes(tmp_path):
    msgs = []
    for mod in (jservice, tservice):
        d = str(tmp_path / mod.__name__)
        cfg = cfg_pair("numpy", grid_shape=(2, 2, 2), snapshot_every=4,
                       snapshot_dir=d)[mod is tservice]
        drv = mod.ServiceDriver(cfg)
        drv.init_state()
        drv.run(max_steps=4)
        drv.close()
        same = mod.ServiceDriver(dataclasses.replace(cfg,
                                                     auto_reshard=False))
        assert same.restore_latest() is True
        strict = mod.ServiceDriver(dataclasses.replace(
            cfg, grid_shape=(1, 2, 2), n_local=512, auto_reshard=False))
        with pytest.raises(mod.ElasticRestoreError) as ei:
            strict.restore_latest()
        msgs.append(str(ei.value).replace(d, "DIR"))
    assert msgs[0] == msgs[1]
    assert "(2, 2, 2)" in msgs[1] and "(1, 2, 2)" in msgs[1]
    assert "auto_reshard is disabled" in msgs[1]


def test_device_budget_without_reshard_raises(tmp_path):
    """A device budget that forces a shrink with ``auto_reshard`` off:
    the reference's ElasticRestoreError message."""
    msgs = []
    for mod in (jservice, tservice):
        d = str(tmp_path / mod.__name__)
        cfg = cfg_pair("numpy", grid_shape=(2, 2, 2), snapshot_every=4,
                       snapshot_dir=d)[mod is tservice]
        drv = mod.ServiceDriver(cfg)
        drv.init_state()
        drv.run(max_steps=4)
        drv.close()
        rec = (JRecorder if mod is jservice else StepRecorder)()
        rec.record("restart", action="restart")
        strict = mod.ServiceDriver(
            dataclasses.replace(cfg, auto_reshard=False), recorder=rec,
            faults=mod.FaultPlan([mod.DeviceLossFault(4)]))
        with pytest.raises(mod.ElasticRestoreError) as ei:
            strict.restore_latest()
        msgs.append(str(ei.value).replace(d, "DIR"))
    assert msgs[0] == msgs[1] and "only 4" in msgs[1]


def test_supervised_restart_resumes_bit_identical_on_torch(tmp_path):
    """The torch backend under the supervisor: a crash at step 10, one
    restart from the step-8 snapshot, the uninterrupted run's bytes (the
    reference's jax driver gives the same)."""
    states = []
    for mod in (jservice, tservice):
        cfg = cfg_pair("torch", steps=16, chunk=4, snapshot_every=4,
                       snapshot_dir=str(tmp_path / mod.__name__))[
            mod is tservice]
        sup, rec = supervised(mod, cfg, mod.FaultPlan([mod.CrashFault(10)]))
        v = sup.run()
        assert v.ok and v.restarts == 1
        states.append(host(sup.driver.state))
        assert rec.last("restore").data["step"] == 8
    assert_same_bytes(states[1], states[0], "restarted torch run")
    assert_same_bytes(states[1], reference_state(tservice, cfg), "restart")
