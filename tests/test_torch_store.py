"""The port's journal store (``telemetry/store.py``) against the JAX
package's on the CPU.

The same event sequence goes into the reference's ``StepRecorder`` and
``JournalStore`` and into the port's, with the wall clock pinned in both
packages' recorder and store modules (the stores stamp ``time.time()``
into the manifest and retention reads it; every line is tagged with the
recorder's ``host``/``pid``, set equal). Then every segment and
``MANIFEST.json`` compare byte for byte, and ``StoreReader.events()``,
``counts()`` and ``latency_histogram()`` are equal: across rotation,
retention (by bytes and by age), compaction, the ``missed`` ledger, a
corruption ``verify`` finds, the restart watermark and a refused new
recorder incarnation. No difference is allowed.

The service driver: the port's (torch on the CPU, eager and chunks of 7,
and its numpy oracle) drains at the reference numpy driver's boundaries
with the same manifest counts (the torch engine journals its own
``engine_resolved`` and overflow-window events besides, which the numpy
backend has none of), and a supervised restart leaves no row twice.
Both drivers' step clock is pinned there: the two host-timed health
rules (``snapshot_staleness``'s cadence and ``step_time_spike``'s EMA)
read it, so an unpinned clock lets the host's load decide whether an
``alert`` lands in one run and not the other; under one clock that makes
them fire, the two drivers journal the same staleness alerts at the same
steps. The reference's wall-clock drain-overhead gate is not copied (a CPU test
under a parallel run cannot hold a 2% wall bound); the drain's cost is
measured on the card by ``chip_smoke.py``."""

import dataclasses
import os
import time
import types

import pytest

from mpi_grid_redistribute_tpu import service as jservice
from mpi_grid_redistribute_tpu.service import driver as jdriver
from mpi_grid_redistribute_tpu.telemetry import health as jhealth
from mpi_grid_redistribute_tpu.telemetry import recorder as jrecorder
from mpi_grid_redistribute_tpu.telemetry import store as jstore
from mpi_grid_redistribute_tpu_torch import service as tservice
from mpi_grid_redistribute_tpu_torch.service import driver as tdriver
from mpi_grid_redistribute_tpu_torch.telemetry import health as thealth
from mpi_grid_redistribute_tpu_torch.telemetry import recorder as trecorder
from mpi_grid_redistribute_tpu_torch.telemetry import store as tstore
from torch_service_cases import GRID, run_driver

PAIRS = ((jrecorder, jstore), (trecorder, tstore))


class Clock:
    t = 1000.0


@pytest.fixture
def clock(monkeypatch):
    """``time.time`` pinned to ``Clock.t`` in both packages' recorder and
    store modules (and nowhere else)."""
    c = Clock()
    fake = types.SimpleNamespace(time=lambda: c.t)
    for rec_mod, store_mod in PAIRS:
        monkeypatch.setattr(rec_mod, "time", fake)
        monkeypatch.setattr(store_mod, "time", fake)
    return c


def _record_chunk(rec, first, seconds, dropped):
    # the reference's record_chunk_steps, through the recorder API only
    for i, d in enumerate(dropped):
        rec.record("step_latency", step=first + i, seconds=seconds,
                   dropped=int(d))


def _drive(rec_mod, store_mod, root, clock, chunks=16, per_chunk=40,
           capacity=96, tick=0.0, **store_kw):
    """The reference test's wrapping-ring run, drained at every chunk
    boundary: eviction, rotation and (with the knobs) compaction and
    retention. ``tick`` advances the pinned clock a chunk."""
    kw = dict(segment_events=120, segment_bytes=1 << 20,
              retain_bytes=1 << 30, compact_after=1, compact_window=16)
    kw.update(store_kw)
    rec = rec_mod.StepRecorder(capacity=capacity, host="h0", pid=7)
    store = store_mod.JournalStore(str(root), **kw)
    for c in range(chunks):
        _record_chunk(rec, c * per_chunk, 0.002 * (1 + (c % 3)),
                      [c % 2] * per_chunk)
        rec.record("migrate_step", step=c, sent=3 + c, received=3 + c,
                   backlog=c % 5, dropped_recv=0, population=64)
        rec.record("fast_path", step=c, taken=c % 2, movers=10 + c)
        if c % 3 == 0:
            rec.record("state_health", step=c, nan_pos=0, nan_vel=c % 2,
                       oob=0, live=60 + c, residual=0)
        if c % 4 == 0:
            rec.record("alert", rule="imbalance_ratio", severity="WARN",
                       value=1.0 + c, step=c * per_chunk)
        if c % 7 == 0:
            rec.record("flow_snapshot", imbalance=1.0 + 0.1 * c,
                       total_rows=64, step=c * per_chunk)
        store.drain(rec)
        clock.t += tick
    return rec, store


def _tree(root):
    """Every file under a store root: ``{relative name: bytes}``."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _hist(h):
    return (list(h._bucket_counts), h._sum, h._count)


def assert_same_store(jroot, troot, jrec, trec):
    want, got = _tree(jroot), _tree(troot)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], f"{name} differs"
    jr, tr = jstore.StoreReader(str(jroot)), tstore.StoreReader(str(troot))
    assert tr.events() == jr.events()
    assert tr.counts() == jr.counts() == trec.counts() == jrec.counts()
    assert _hist(tr.latency_histogram()) == _hist(jr.latency_histogram())
    for kind in ("alert", "store_window", "step_latency"):
        assert tr.events(kind) == jr.events(kind)


SCENARIOS = {
    "compaction": dict(),
    "retention_bytes": dict(chunks=20, retain_bytes=26 << 10),
    "retention_age": dict(chunks=20, tick=10.0, retain_age_s=45.0),
    "rotation_only": dict(compact_after=10 ** 6),
    "small_windows": dict(compact_window=3, segment_events=50),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_store_bytes_equal_reference(tmp_path, clock, scenario):
    kw = SCENARIOS[scenario]
    t0 = clock.t
    jrec, js = _drive(jrecorder, jstore, tmp_path / "j", clock, **kw)
    clock.t = t0
    trec, ts = _drive(trecorder, tstore, tmp_path / "t", clock, **kw)
    assert trec.evicted > 0, "the ring never wrapped: vacuous"
    man = ts.manifest
    if scenario.startswith("retention"):
        assert man["retired"]["segments"] >= 1, "nothing retired: vacuous"
    if scenario in ("compaction", "small_windows"):
        assert any(s["kind"] == "summary" for s in man["segments"])
    if scenario == "rotation_only":
        assert sum(s["kind"] == "raw" for s in man["segments"]) >= 2
    assert_same_store(tmp_path / "j", tmp_path / "t", jrec, trec)
    # close: the final drain, rotate, compact and retention
    for store, rec in ((js, jrec), (ts, trec)):
        store.close(rec)
    assert_same_store(tmp_path / "j", tmp_path / "t", jrec, trec)
    assert not [n for n in os.listdir(tmp_path / "t") if ".tmp-" in n]


def test_missed_ledger_equal_reference(tmp_path, clock):
    """Events the ring evicts between drains land in ``missed``."""
    recs = []
    for (rec_mod, store_mod), name in zip(PAIRS, "jt"):
        rec = rec_mod.StepRecorder(capacity=8, host="h0", pid=1)
        store = store_mod.JournalStore(str(tmp_path / name),
                                       segment_events=1000)
        store.drain(rec)
        for i in range(50):
            rec.record("step_time", step=i, seconds=0.001)
        store.drain(rec)
        assert store.manifest["missed"].get("step_time", 0) > 0
        recs.append(rec)
    assert_same_store(tmp_path / "j", tmp_path / "t", *recs)


def test_verify_finds_the_same_corruption(tmp_path, clock):
    """One flipped byte of a closed segment: both readers' ``verify``
    name the same member, and a torn manifest is refused by both."""
    errs = []
    for (rec_mod, store_mod), name in zip(PAIRS, "jt"):
        _, store = _drive(rec_mod, store_mod, tmp_path / name, clock,
                          compact_after=10 ** 6)
        raws = [s for s in store.manifest["segments"] if s["kind"] == "raw"]
        store_mod.StoreReader(str(tmp_path / name), verify=True)
        victim = tmp_path / name / raws[1]["name"]
        blob = bytearray(victim.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        victim.write_bytes(bytes(blob))
        with pytest.raises(store_mod.StoreCorruptError) as ei:
            store_mod.StoreReader(str(tmp_path / name), verify=True)
        errs.append((ei.value.member, ei.value.detail))
        (tmp_path / name / "MANIFEST.json").write_text("{torn")
        with pytest.raises(store_mod.StoreCorruptError, match="MANIFEST"):
            store_mod.StoreReader(str(tmp_path / name))
    assert errs[0] == errs[1]


def test_restart_watermark_equal_reference(tmp_path, clock):
    """A fresh ``JournalStore`` over the same root and recorder resumes
    from the manifest's watermark: nothing persists twice, in both."""
    recs = []
    for (rec_mod, store_mod), name in zip(PAIRS, "jt"):
        rec = rec_mod.StepRecorder(capacity=256, host="h0", pid=1)
        store = store_mod.JournalStore(str(tmp_path / name),
                                       segment_events=10 ** 6)
        _record_chunk(rec, 0, 0.001, [0] * 10)
        store.drain(rec)
        store2 = store_mod.JournalStore(str(tmp_path / name),
                                        segment_events=10 ** 6)
        assert store2.drain(rec) == 1  # only its own store_drain row
        _record_chunk(rec, 10, 0.001, [0] * 5)
        store2.drain(rec)
        rows = store2.reader().events()
        assert len({r["seq"] for r in rows}) == len(rows)
        assert len([r for r in rows if r["kind"] == "step_latency"]) == 15
        recs.append(rec)
    assert_same_store(tmp_path / "j", tmp_path / "t", *recs)


def test_new_incarnation_refused_equal_reference(tmp_path, clock):
    """A fresh recorder whose counts regress below the manifest's is
    refused by both stores with nothing written; a recorder rebuilt by
    ``StoreReader.to_recorder`` resumes, in both."""
    recs = []
    for (rec_mod, store_mod), name in zip(PAIRS, "jt"):
        rec = rec_mod.StepRecorder(capacity=64, host="h0", pid=1)
        store = store_mod.JournalStore(str(tmp_path / name),
                                       segment_events=10 ** 6)
        _record_chunk(rec, 0, 0.001, [0] * 20)
        store.drain(rec)
        fresh = rec_mod.StepRecorder(capacity=64, host="h0", pid=1)
        _record_chunk(fresh, 0, 0.001, [0] * 5)
        store2 = store_mod.JournalStore(str(tmp_path / name),
                                        segment_events=10 ** 6)
        with pytest.raises(ValueError, match="incarnation"):
            store2.drain(fresh)
        assert store2.reader().manifest["missed"] == {}
        rebuilt = store2.reader().to_recorder()
        assert rebuilt.counts() == rec.counts()
        assert store2.drain(rebuilt) == 1
        recs.append(rebuilt)
    # the rebuilt recorders are tagged "store"/0 and replayed the rows
    assert_same_store(tmp_path / "j", tmp_path / "t", *recs)


def test_store_helpers(tmp_path, clock):
    rec = trecorder.StepRecorder(capacity=64, host="h0", pid=1)
    root = tmp_path / "runs" / "a" / "store"
    store = tstore.JournalStore(str(root))
    rec.record("step_time", step=0, seconds=0.001)
    store.close(rec)
    assert tstore.StoreReader(str(root)).manifest["active"] is None
    assert tstore.is_store(str(root)) and not tstore.is_store(str(tmp_path))
    assert tstore.list_stores(str(tmp_path)) == [str(root)]
    assert [r["kind"] for r in store.reader().events()] == [
        "step_time", "store_drain"]
    tstore.wipe(str(root))
    assert not root.exists()
    with pytest.raises(ValueError, match="segment_events"):
        tstore.JournalStore(str(root), segment_events=0)


# ------------------------------------------------------- the driver

DRIVER_LEGS = {
    "numpy": dict(backend="numpy"),
    "torch_eager": dict(backend="torch", device="cpu", chunk=1),
    "torch_chunk7": dict(backend="torch", device="cpu", chunk=7),
}


def _pin_step_clock(monkeypatch, perf_counter):
    """``time.perf_counter`` of both service drivers (their step clock,
    and nothing else's) replaced by ``perf_counter``."""
    fake = types.SimpleNamespace(perf_counter=perf_counter, sleep=time.sleep)
    for mod in (jdriver, tdriver):
        monkeypatch.setattr(mod, "time", fake)


def _driver_pair(tmp_path, leg):
    """The reference numpy driver's and the port's ``leg`` driver's
    configs over one run (24 steps, a snapshot every 4)."""
    base = dict(grid_shape=GRID, n_local=256, steps=24, seed=3,
                snapshot_every=4, store_segment_events=64,
                chunk=DRIVER_LEGS[leg].get("chunk", 7))
    jcfg = jservice.DriverConfig(
        backend="numpy", snapshot_dir=str(tmp_path / "js"),
        store_dir=str(tmp_path / "jst"), **base)
    port_kw = {k: v for k, v in DRIVER_LEGS[leg].items() if k != "chunk"}
    tcfg = tservice.DriverConfig(
        snapshot_dir=str(tmp_path / "ts"), store_dir=str(tmp_path / "tst"),
        **port_kw, **base)
    return jcfg, tcfg


@pytest.mark.parametrize("leg", list(DRIVER_LEGS))
def test_driver_drains_at_reference_boundaries(tmp_path, monkeypatch, leg):
    """The port's driver drains where the reference numpy driver drains
    (the ``ctx_step`` of every ``store_drain``), its store verifies, and
    its manifest counts equal its recorder's and the reference's on every
    kind the reference journals. The step clock is pinned (a constant),
    so neither run's host-timed rules fire on the host's load."""
    _pin_step_clock(monkeypatch, lambda: 0.0)
    jcfg, tcfg = _driver_pair(tmp_path, leg)
    jdrv, _ = run_driver(jservice, jcfg)
    tdrv, _ = run_driver(tservice, tcfg)
    jr = jstore.StoreReader(jcfg.store_dir, verify=True)
    tr = tstore.StoreReader(tcfg.store_dir, verify=True)
    assert tr.counts() == tdrv.recorder.counts()
    assert jr.counts() == jdrv.recorder.counts()
    steps = [r.get("ctx_step") for r in tr.events("store_drain")]
    assert steps == [r.get("ctx_step") for r in jr.events("store_drain")]
    assert tr.manifest["drains"] == jr.manifest["drains"] == len(steps)
    assert {k: v for k, v in tr.counts().items() if k in jr.counts()} \
        == jr.counts()
    if leg == "numpy":
        assert tr.counts() == jr.counts()
    assert sorted(r["step"] for r in tr.events("step_latency")) == list(
        range(1, 25))


@pytest.mark.parametrize("leg", ["numpy", "torch_eager"])
def test_driver_staleness_alerts_match_reference_under_one_clock(
        tmp_path, monkeypatch, leg):
    """What made the boundary comparison unsteady: ``snapshot_staleness``
    compares the age of the last ``snapshot`` event (its health check
    runs right after the snapshot, behind the writer thread's start, the
    prune and the journal export) with twice the cadence ``snapshot_every
    x`` the step-time EMA, so on a loaded host it fires in one run and
    not the other. Under one clock that ticks a fixed 1 ms a read and a
    health clock 1000 s ahead, it fires at every health check after the
    first snapshot, in both drivers, at the same steps."""
    ticks = iter(range(10**9))
    _pin_step_clock(monkeypatch, lambda: next(ticks) * 1e-3)
    ahead = types.SimpleNamespace(time=lambda: time.time() + 1000.0)
    for mod in (jhealth, thealth):
        monkeypatch.setattr(mod, "time", ahead)
    jcfg, tcfg = _driver_pair(tmp_path, leg)
    jdrv, _ = run_driver(jservice, jcfg)
    tdrv, _ = run_driver(tservice, tcfg)

    def stale(drv):
        return [e.data.get("ctx_step") for e in drv.recorder.events("alert")
                if e.data.get("rule") == "snapshot_staleness"]

    # one alert a snapshot boundary (steps 4, 8, ..., 24), each stamped
    # with the step its chunk started at
    assert stale(jdrv) == stale(tdrv)
    assert len(stale(tdrv)) == 6


def test_supervised_restart_store_no_duplicates(tmp_path):
    """A crash-injected supervised run re-opens the same store root: no
    ``(host, pid, seq)`` persists twice and the counts are the shared
    journal's."""
    cfg = tservice.DriverConfig(
        grid_shape=(2, 2, 2), n_local=128, steps=24, seed=3,
        backend="torch", device="cpu", chunk=4, snapshot_every=4,
        snapshot_dir=str(tmp_path / "snaps"),
        store_dir=str(tmp_path / "store"))
    rec = trecorder.StepRecorder(capacity=4096, host="h0", pid=1)
    faults = tservice.FaultPlan([tservice.CrashFault(10)])

    def factory(grid_shape=None):
        c = cfg
        if grid_shape is not None:
            c = dataclasses.replace(c, grid_shape=tuple(grid_shape))
        return tservice.ServiceDriver(c, recorder=rec, faults=faults)

    sup = tservice.Supervisor(
        factory, policy=tservice.RestartPolicy(
            max_restarts=3, backoff_base_s=0.01, backoff_cap_s=0.02),
        recorder=rec, sleep_fn=lambda s: None)
    verdict = sup.run()
    assert verdict.ok is True and verdict.restarts == 1, verdict
    reader = tstore.StoreReader(str(tmp_path / "store"), verify=True)
    keys = [(r["host"], r["pid"], r["seq"]) for r in reader.events()]
    assert len(keys) == len(set(keys)), "the restart duplicated rows"
    assert reader.counts() == rec.counts()
    assert reader.counts()["restart"] == 1
