"""The port's ``ServiceDriver`` against the JAX package's on the CPU.

With the same ``DriverConfig`` the final ``(pos, vel, ids, count)`` is
byte-equal to the reference driver's, and so is the journal (every event
kind in order, every field that is not a wall time or a path), for the
eager, chunked (7 and 16, neither dividing the horizon), pipelined and
numpy runs. The grid is ``(2, 2, 4)``: more ranks than the reference's 8
forced CPU devices, so its jax backend runs vranks on one device as the
port does (on ``(2, 2, 2)`` it builds a device mesh and picks another
engine: the particle set still agrees). Also: snapshots (restore, the
reference loading the port's snapshots, cadence under a misaligned
chunk), a chunk that overflows (grown, re-run eagerly), the chunk
reading nothing back, the eager drift's zero (C13), the pacing and
watchdog walls, the store and incident directories and the CLI."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mpi_grid_redistribute_tpu import service as jservice
from mpi_grid_redistribute_tpu.models import nbody as jnbody
from mpi_grid_redistribute_tpu_torch import service as tservice
from mpi_grid_redistribute_tpu_torch.models import nbody
from mpi_grid_redistribute_tpu_torch.utils import checkpoint
from torch_service_cases import (
    assert_same_bytes, assert_same_journal, cfg_pair, host, journal,
    reference_state, run_driver,
)

ROOT = Path(__file__).resolve().parents[1]

LEGS = {
    "eager": dict(chunk=1),
    "chunk7": dict(chunk=7),
    "chunk16": dict(chunk=16),
    "pipelined": dict(chunk=7, pipeline=True),
    "pipelined16": dict(chunk=16, pipeline=True),
}


@pytest.mark.parametrize("n_local", [256, 1024])
@pytest.mark.parametrize("leg", list(LEGS) + ["numpy"])
def test_final_state_and_journal_equal_reference(leg, n_local):
    backend = "numpy" if leg == "numpy" else "torch"
    jcfg, tcfg = cfg_pair(backend, n_local=n_local, steps=24,
                          **LEGS.get(leg, {}))
    jdrv, want = run_driver(jservice, jcfg)
    tdrv, got = run_driver(tservice, tcfg)
    assert_same_bytes(got, want, leg)
    assert_same_journal(jdrv.recorder, tdrv.recorder)
    assert tdrv.step == 24
    if backend == "torch":
        assert all(isinstance(a, torch.Tensor) for a in tdrv.state)
    counts = tdrv.recorder.counts()
    assert counts["step_latency"] == counts["redistribute"] == 24


@pytest.mark.parametrize("chunk,pipeline", [(1, False), (7, False),
                                            (7, True)])
def test_mesh_grid_particle_set_equals_reference(chunk, pipeline):
    """On ``(2, 2, 2)`` the reference builds an 8-device mesh (another
    engine); the port runs 8 vranks: the same particle set and counts."""
    jcfg, tcfg = cfg_pair("torch", grid_shape=(2, 2, 2), chunk=chunk,
                          pipeline=pipeline)
    want = run_driver(jservice, jcfg)[1]
    got = run_driver(tservice, tcfg)[1]
    assert tservice.particle_set(*got) == jservice.elastic.particle_set(
        *want)
    assert got[3].tobytes() == want[3].tobytes()


def test_all_legs_give_one_particle_set():
    sets = []
    for leg in LEGS.values():
        _, cfg = cfg_pair("torch", steps=24, **leg)
        sets.append(tservice.particle_set(*run_driver(tservice, cfg)[1]))
    _, cfg = cfg_pair("numpy", steps=24)
    sets.append(tservice.particle_set(*run_driver(tservice, cfg)[1]))
    assert all(s == sets[0] for s in sets)


def test_snapshot_restore_bit_identical(tmp_path):
    _, cfg = cfg_pair("torch", chunk=4, snapshot_every=4, keep_snapshots=2,
                      snapshot_dir=str(tmp_path / "snaps"))
    drv = tservice.ServiceDriver(cfg)
    drv.init_state()
    drv.run(max_steps=10)  # past the snapshots at steps 4 and 8
    drv.close()
    shutil.copytree(cfg.snapshot_dir, tmp_path / "copy")
    snaps = checkpoint.list_snapshots(cfg.snapshot_dir)
    assert [os.path.basename(p) for p in snaps] == ["step_00000008",
                                                   "step_00000004"]
    resumed = tservice.ServiceDriver(cfg)
    assert resumed.restore_latest() is True and resumed.step == 8
    ev = resumed.recorder.last("restore")
    assert ev.data["what"] == "state" and ev.data["snapshots_skipped"] == 0
    resumed.run()
    resumed.close()
    assert_same_bytes(host(resumed.state), reference_state(tservice, cfg))
    # the reference's driver restores the port's snapshot and finishes
    # with the same bytes
    jcfg = dataclasses.replace(cfg_pair("torch")[0], chunk=4,
                               snapshot_every=4,
                               snapshot_dir=str(tmp_path / "copy"))
    jdrv = jservice.ServiceDriver(jcfg)
    assert jdrv.restore_latest() is True and jdrv.step == 8
    jdrv.run()
    jdrv.close()
    assert_same_bytes(host(resumed.state), host(jdrv.state), "cross")


def test_snapshot_writer_gets_host_copies(tmp_path, monkeypatch):
    """The async writer receives NumPy arrays the loop made before it
    started; an in-place change of the device state afterwards does not
    reach the snapshot."""
    _, cfg = cfg_pair("torch", snapshot_every=4,
                      snapshot_dir=str(tmp_path / "s"))
    drv = tservice.ServiceDriver(cfg)
    drv.init_state()
    drv.run(max_steps=3)
    seen = []
    real_save = checkpoint.save

    def save(path, arrays, **kw):
        seen.append({k: type(v) for k, v in arrays.items()})
        drv.state[0].fill_(7.0)  # the next step overwriting the state
        return real_save(path, arrays, **kw)

    monkeypatch.setattr(checkpoint, "save", save)
    want = host(drv.state)
    drv.snapshot()
    drv.join_snapshot_writer()
    assert seen == [{k: np.ndarray for k in ("pos", "vel", "ids", "count")}]
    back, _ = checkpoint.load(os.path.join(cfg.snapshot_dir,
                                           "step_00000003"))
    assert back["pos"].tobytes() == want[0].tobytes()


def test_snapshot_write_error_surfaces_once(tmp_path, monkeypatch):
    _, cfg = cfg_pair("torch", snapshot_every=4,
                      snapshot_dir=str(tmp_path / "s"))
    drv = tservice.ServiceDriver(cfg)
    drv.init_state()

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "save", broken)
    drv.snapshot()
    with pytest.raises(RuntimeError, match="OSError: disk full"):
        drv.join_snapshot_writer()
    drv.join_snapshot_writer()  # read once, under the lock
    assert drv.abandon() is None


def test_snapshot_cadence_survives_misaligned_chunk(tmp_path):
    states = {}
    for chunk in (1, 4):
        _, cfg = cfg_pair("torch", steps=12, chunk=chunk, snapshot_every=6,
                          snapshot_dir=str(tmp_path / f"s{chunk}"))
        drv, states[chunk] = run_driver(tservice, cfg)
        steps = sorted(int(os.path.basename(p).split("_")[1])
                       for p in checkpoint.list_snapshots(cfg.snapshot_dir))
        assert steps == [6, 12]
    assert_same_bytes(states[4], states[1])


def _biased(mod, cfg):
    """A driver under a convergent drift into one rank: the hot rank
    outgrows ``n_local`` and the receive side overflows."""
    drv = mod.ServiceDriver(cfg)
    drv.init_state()
    pos, vel, ids, count = host(drv.state)
    sink = np.asarray([0.25, 0.25, 0.25], np.float32)
    vel = ((sink[None, :] - pos) / np.float32(16)).astype(np.float32)
    if mod is tservice:
        drv.state = drv._to_state(pos, vel, ids, count)
    else:
        drv.state = (pos, vel, ids, count)
    drv.run()
    drv.close()
    return drv, host(drv.state)


@pytest.mark.parametrize("chunk,pipeline", [(1, False), (8, False),
                                            (8, True)])
def test_overflow_inside_a_chunk_grows_and_reruns(chunk, pipeline):
    """A chunk whose ys show drops is discarded (with any chunk issued
    after it), the engine grows and the steps re-run eagerly; the eager
    loop heals a drop its deferred window would only report. Every leg
    ends with the oracle loop's particle set and nothing dropped."""
    _, cfg = cfg_pair("torch", grid_shape=(2, 2, 2), n_local=128, fill=0.5,
                      steps=24, chunk=chunk, pipeline=pipeline)
    drv, got = _biased(tservice, cfg)
    grows = drv.recorder.events("capacity_grow")
    assert grows and any(e.data["which"] == "recv" for e in grows)
    assert drv._rd.out_capacity > 128
    assert sum(e.data["dropped"]
               for e in drv.recorder.events("step_latency")) == 0
    _, jcfg = cfg_pair("numpy", grid_shape=(2, 2, 2), n_local=128, fill=0.5,
                       steps=24)
    _, want = _biased(tservice, jcfg)
    _, ref = _biased(jservice, cfg_pair("numpy", grid_shape=(2, 2, 2),
                                        n_local=128, fill=0.5, steps=24)[0])
    assert tservice.particle_set(*got) == tservice.particle_set(*want)
    assert tservice.particle_set(*want) == jservice.elastic.particle_set(
        *ref)
    assert got[3].tobytes() == want[3].tobytes()


_HOST_READS = ("item", "cpu", "numpy", "tolist", "__bool__", "__int__",
               "__float__", "__index__")


@pytest.mark.parametrize("pipeline", [False, True])
def test_chunk_reads_nothing_back(monkeypatch, pipeline):
    """Every host read of a tensor raises while a chunk is issued: the
    driver's chunks (and their staged ys copies) still run, and the run
    equals the eager one."""
    _, cfg = cfg_pair("torch", steps=16, chunk=16, pipeline=pipeline)
    drv = tservice.ServiceDriver(cfg)
    drv.init_state()
    real = drv._macro_fn
    issued = []

    def refuse(*args, **kwargs):
        raise AssertionError("a host read inside the chunk")

    def guarded(n):
        macro, cap, out_cap = real(n)

        def run(*state):
            saved = {k: getattr(torch.Tensor, k) for k in _HOST_READS}
            for k in _HOST_READS:
                setattr(torch.Tensor, k, refuse)
            try:
                out = macro(*state)
                staged = drv._stage_ys(out[1], None)
            finally:
                for k, v in saved.items():
                    setattr(torch.Tensor, k, v)
            issued.append((n, staged[1] is None))
            return out

        return run, cap, out_cap

    monkeypatch.setattr(drv, "_macro_fn", guarded)
    drv.run()
    drv.close()
    assert issued == [(16, True)]
    _, eager = cfg_pair("torch", steps=16)
    assert tservice.particle_set(*drv.state) == tservice.particle_set(
        *run_driver(tservice, eager)[1])


def test_eager_drift_zero_is_numpys_and_the_chunks_is_jnps():
    """C13: on an exact non-positive integer ``pos + vel * dt`` NumPy's
    ``%`` gives +0.0 (the reference's eager leg) and ``jnp.remainder``
    -0.0 (its chunk): the port's eager drift and ``service_drift`` give
    each."""
    pos = np.array([0.0, 0.0, 0.5, 0.25, -0.0, 0.75], np.float32)
    vel = np.array([-1.0, -2.0, -1.5, -2.25, -1.0, 0.25], np.float32)
    want_eager = (pos + vel * np.float32(1.0)) % np.float32(1.0)
    want_eager = np.where(want_eager >= 1, want_eager - 1, want_eager)
    want_chunk = np.asarray(jnbody.service_drift(pos, vel, 1.0))
    got_eager = nbody.eager_drift(torch.from_numpy(pos),
                                  torch.from_numpy(vel), 1.0).numpy()
    got_chunk = nbody.service_drift(torch.from_numpy(pos),
                                    torch.from_numpy(vel), 1.0).numpy()
    assert got_eager.view(np.uint32).tolist() == \
        want_eager.view(np.uint32).tolist()
    assert got_chunk.view(np.uint32).tolist() == \
        want_chunk.view(np.uint32).tolist()
    zeros = slice(0, 5)
    assert not np.signbit(got_eager[zeros]).any()
    assert np.signbit(got_chunk[zeros]).all()
    rng = np.random.default_rng(4)
    p = rng.uniform(-3, 3, 4096).astype(np.float32)
    v = rng.uniform(-2, 2, 4096).astype(np.float32)
    want = (p + v) % np.float32(1.0)
    want = np.where(want >= 1, want - 1, want)
    got = nbody.eager_drift(torch.from_numpy(p), torch.from_numpy(v),
                            1.0).numpy()
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()


@pytest.mark.parametrize("chunk", [1, 2])
def test_driver_zero_sign_per_leg(chunk):
    """The same constructed rows through both drivers: x lands on -1.0
    and -2.0 each step; the eager leg keeps +0.0, the chunk -0.0, in the
    port as in the reference."""
    got = {}
    for mod in (jservice, tservice):
        cfg = cfg_pair("torch", steps=2, chunk=chunk)[mod is tservice]
        drv = mod.ServiceDriver(cfg)
        drv.init_state()
        pos, vel, ids, count = (np.array(a) for a in host(drv.state))
        vel[:] = 0.0
        pos[:2, 0] = 0.0
        vel[0, 0], vel[1, 0] = -1.0, -2.0
        state = (pos, vel, ids, count)
        drv.state = drv._to_state(*state) if mod is tservice else state
        drv.run()
        drv.close()
        live = tservice.gather_live(dict(zip(
            ("pos", "vel", "ids", "count"), host(drv.state))), 16, 256)
        got[mod] = live["pos"][np.isin(live["ids"], [0, 1])][:, 0]
    assert got[tservice].view(np.uint32).tolist() == \
        got[jservice].view(np.uint32).tolist()
    assert (got[tservice] == 0).all()
    assert np.signbit(got[tservice]).all() == (chunk > 1)


def test_step_sleep_excluded_from_step_latency():
    _, cfg = cfg_pair("torch", n_local=64, steps=4, step_sleep=0.25)
    drv = tservice.ServiceDriver(cfg)
    drv.init_state()
    t0 = time.perf_counter()
    drv.run()
    elapsed = time.perf_counter() - t0
    drv.close()
    evs = drv.recorder.events("step_latency")
    assert [e.data["step"] for e in evs] == [1, 2, 3, 4]
    assert elapsed >= 4 * 0.25
    assert all(e.data["seconds"] < 0.125 for e in evs)


@pytest.mark.parametrize("chunk", [1, 2])
def test_step_sleep_still_counts_against_watchdog(chunk):
    _, cfg = cfg_pair("torch", n_local=64, steps=4, step_sleep=0.25,
                      watchdog_s=0.125, chunk=chunk)
    drv = tservice.ServiceDriver(cfg)
    drv.init_state()
    with pytest.raises(tservice.StallError, match="watchdog"):
        drv.run()
    evs = drv.recorder.events("step_latency")
    assert len(evs) == chunk and evs[0].data["step"] == 1
    assert evs[0].data["seconds"] < cfg.watchdog_s


@pytest.mark.parametrize("field", ["store_dir", "incident_dir"])
def test_store_and_incident_dirs_work(tmp_path, field):
    """``store_dir``: the ring drained at every boundary into a verified
    store holding the recorder's counts. ``incident_dir``: an injected
    fault leaves its bundle, scanned at the next boundary."""
    from mpi_grid_redistribute_tpu_torch.telemetry import incident, store

    _, cfg = cfg_pair("torch", steps=12, snapshot_every=4,
                      snapshot_dir=str(tmp_path / "s"),
                      **{field: str(tmp_path / field)})
    drv = tservice.ServiceDriver(cfg, faults=tservice.FaultPlan(
        [tservice.LatencySpikeFault(5, seconds=0.001, spikes=1)]))
    drv.init_state()
    drv.run()
    drv.close()
    if field == "store_dir":
        reader = store.StoreReader(cfg.store_dir, verify=True)
        assert reader.counts() == drv.recorder.counts()
        assert reader.counts()["store_drain"] == 13  # every step, close
        assert len(reader.events("step_latency")) == 13  # one spiked
    else:
        (bundle,) = incident.list_bundles(cfg.incident_dir)
        assert bundle["rule"] == "fault_latency_spike"
        assert bundle["trigger"] == "fault"
        assert drv.recorder.last("incident").data["id"] == bundle["id"]


def test_config_validation():
    with pytest.raises(ValueError, match="snapshot_dir"):
        tservice.ServiceDriver(cfg_pair("numpy", snapshot_every=4)[1])
    with pytest.raises(ValueError, match="keep_snapshots"):
        tservice.ServiceDriver(cfg_pair(
            "numpy", snapshot_every=4, snapshot_dir="x",
            keep_snapshots=1)[1])
    with pytest.raises(ValueError, match="backend must be one of"):
        tservice.ServiceDriver(tservice.DriverConfig(backend="jax"))
    ref = {f.name for f in dataclasses.fields(jservice.DriverConfig)}
    port = {f.name for f in dataclasses.fields(tservice.DriverConfig)}
    assert port - ref == {"device"} and ref <= port


def test_driver_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tservice.ServiceDriver(tservice.DriverConfig())
    # the numpy oracle needs no device
    tservice.ServiceDriver(tservice.DriverConfig(backend="numpy"))


def test_restore_latest_without_snapshots(tmp_path):
    drv = tservice.ServiceDriver(cfg_pair("torch")[1])
    assert drv.restore_latest() is False
    drv2 = tservice.ServiceDriver(cfg_pair(
        "torch", snapshot_every=4, snapshot_dir=str(tmp_path))[1])
    assert drv2.restore_latest() is False


def test_healthz_reports_skipped_snapshots(tmp_path):
    _, cfg = cfg_pair("numpy", grid_shape=(2, 2, 2), snapshot_every=4,
                      snapshot_dir=str(tmp_path / "s"), steps=8)
    run_driver(tservice, cfg)
    bad = tmp_path / "s" / "step_00000008" / "shard_00000.npz"
    bad.write_bytes(bad.read_bytes()[:10])
    drv = tservice.ServiceDriver(cfg)
    assert drv.restore_latest() and drv.step == 4
    code, verdict = drv.healthz()
    assert code == 200 and verdict["snapshots_corrupt"] == 1


def _cli(*args, timeout=240):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    cmd = [sys.executable, "-m", "mpi_grid_redistribute_tpu_torch.service",
           "--device", "cpu", "--grid", "2,2,2", "--n-local", "128",
           *args]
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=str(ROOT))


def test_cli_hard_crash_then_resume_bit_identical(tmp_path):
    snaps = str(tmp_path / "snaps")
    common = ["--steps", "10", "--seed", "5", "--snapshot-every", "3",
              "--chunk", "4"]
    r = _cli(*common, "--snapshot-dir", snaps, "--sync-snapshots",
             "--inject-crash", "5", "--hard-crash")
    assert r.returncode == 13, r.stderr
    out = tmp_path / "resumed.npz"
    r = _cli(*common, "--snapshot-dir", snaps, "--final-out", str(out))
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1])["ok"] is True
    ref_out = tmp_path / "ref.npz"
    r = _cli(*common, "--snapshot-dir", str(tmp_path / "ref"),
             "--final-out", str(ref_out))
    assert r.returncode == 0, r.stderr
    got, ref = np.load(out), np.load(ref_out)
    assert int(got["step"]) == int(ref["step"]) == 10
    for k in ("pos", "vel", "ids", "count"):
        assert got[k].tobytes() == ref[k].tobytes(), k


def test_cli_supervised_restart_and_breaker(tmp_path):
    r = _cli("--steps", "12", "--snapshot-every", "4", "--snapshot-dir",
             str(tmp_path / "s"), "--supervise", "--inject-crash", "6",
             "--final-out", str(tmp_path / "f.npz"))
    assert r.returncode == 0, r.stderr
    verdict = json.loads(r.stdout.strip().splitlines()[-1])
    assert verdict["ok"] is True and verdict["restarts"] == 1
    assert int(np.load(tmp_path / "f.npz")["step"]) == 12
    r = _cli("--steps", "8", "--supervise", "--inject-crash", "-1",
             "--max-restarts", "2", "--backoff-base", "0.01",
             "--backoff-cap", "0.02")
    assert r.returncode == 3, r.stderr
    verdict = json.loads(r.stdout.strip().splitlines()[-1])
    assert verdict["gave_up"] is True and verdict["restarts"] == 2
    # the history plane's flags: a store and the crash's bundle
    from mpi_grid_redistribute_tpu_torch.telemetry import incident, store

    r = _cli("--steps", "8", "--snapshot-every", "4", "--snapshot-dir",
             str(tmp_path / "s2"), "--supervise", "--inject-crash", "6",
             "--store-dir", str(tmp_path / "store"), "--incident-dir",
             str(tmp_path / "inc"))
    assert r.returncode == 0, r.stderr
    verdict = json.loads(r.stdout.strip().splitlines()[-1])
    assert verdict["ok"] is True and verdict["restarts"] == 1
    reader = store.StoreReader(str(tmp_path / "store"), verify=True)
    assert reader.counts()["restart"] == 1
    rules = [b["rule"] for b in incident.list_bundles(tmp_path / "inc")]
    assert rules == ["fault_crash"]


def test_journal_export_heals_a_lost_shard(tmp_path):
    _, cfg = cfg_pair("torch", snapshot_every=4,
                      snapshot_dir=str(tmp_path / "s"),
                      journal_dir=str(tmp_path / "j"), steps=12)
    drv = tservice.ServiceDriver(cfg, faults=tservice.FaultPlan(
        [tservice.JournalShardLossFault(6)]))
    drv.init_state()
    drv.run()
    drv.close()
    heals = [e for e in drv.recorder.events("restore")
             if e.data.get("what") == "journal"]
    assert len(heals) == 1 and os.path.exists(drv.journal_path)
    kinds = [json.loads(x)["kind"] for x in
             Path(drv.journal_path).read_text().splitlines()]
    assert kinds.count("snapshot") == 3
    assert [(d["step"], d["rows"], d["asynchronous"]) for _, d in
            journal(drv.recorder, {"snapshot"})] == [
        (s, 16 * 204, True) for s in (4, 8, 12)]
