"""The port's runtime thread sanitizer (``telemetry/tsan.py``) over the
port's ``StepRecorder``, against the JAX package's on the CPU.

The tracer is clean on the port's recorder: a writer thread racing
scrapes, the supervised driver (torch on the CPU) with its snapshot
writer and a store, and ``metrics_serve`` answering concurrent
``/metrics``, ``/query`` and ``/events`` over a live ring. It fails on
the first unguarded access once a lock is stripped (a lockless read and
write of ``_counts``, a rogue thread's append, a ``record`` that skips
the lock), naming the field, the operation and the thread. The same
single-threaded sequence of recorder calls leaves the same audit log
(field, operation, lock held) under both packages' tracers: the port's
recorder takes its lock exactly where the reference's does."""

import dataclasses
import http.server
import threading
import urllib.request

import pytest

from mpi_grid_redistribute_tpu.telemetry import StepRecorder as JRecorder
from mpi_grid_redistribute_tpu.telemetry import tsan as jtsan
from mpi_grid_redistribute_tpu_torch import service as tservice
from mpi_grid_redistribute_tpu_torch.telemetry import StepRecorder
from mpi_grid_redistribute_tpu_torch.telemetry import (
    ThreadAccessTracer,
    store,
)
from mpi_grid_redistribute_tpu_torch.tools import metrics_serve


def _script(rec):
    rec.record("step_time", step=0, seconds=0.001)
    rec.record_at("alert", 5.0, rule="r", severity="WARN")
    rec.events()
    rec.events("alert")
    rec.counts()
    rec.last("step_time")
    len(rec)
    rec.total_recorded
    rec.evicted
    for i in range(12):  # wraps the 8-slot ring
        rec.record("step_time", step=i, seconds=0.001)
    rec.clear()
    rec.record("x")


def test_audit_log_equals_reference():
    logs = []
    for rec_cls, tracer_cls in ((JRecorder, jtsan.ThreadAccessTracer),
                                (StepRecorder, ThreadAccessTracer)):
        rec = rec_cls(capacity=8, host="h", pid=1)
        with tracer_cls(rec) as tracer:
            _script(rec)
        logs.append([(a.field, a.op, a.lock_held) for a in tracer.accesses])
        assert tracer.violations() == []
        audits = rec.events("thread_audit")
        assert [e.data["action"] for e in audits] == ["disarm"]
    assert logs[1] == logs[0]
    assert len(logs[1]) > 20


def test_clean_under_a_racing_writer():
    rec = StepRecorder(capacity=512)

    def writer():
        for i in range(200):
            rec.record("step_time", step=i, seconds=0.001)

    with ThreadAccessTracer(rec) as tracer:
        t = threading.Thread(target=writer, daemon=True)
        t.start()
        for _ in range(50):
            rec.counts()
            rec.events("step_time")
        t.join()
        tracer.assert_clean()
        assert len(tracer.by_thread()) >= 2
    audits = rec.events("thread_audit")
    assert [e.data["action"] for e in audits] == ["arm", "disarm"]
    assert audits[1].data["violations"] == 0
    assert audits[1].data["threads"] >= 2
    assert rec.counts()["step_time"] == 200


def test_detects_a_lockless_read_and_write():
    rec = StepRecorder(capacity=8)
    with ThreadAccessTracer(rec) as tracer:
        rec.record("ok")
        assert tracer.violations() == []
        rec._counts["x"] = rec._counts.get("x", 0) + 1  # the lock stripped
        bad = tracer.violations()
        assert [(v.field, v.op) for v in bad] == [("_counts", "read"),
                                                  ("_counts", "write")]
        with pytest.raises(AssertionError, match="unguarded"):
            tracer.assert_clean()


def test_names_the_thread_of_a_rogue_append():
    rec = StepRecorder(capacity=8)
    with ThreadAccessTracer(rec) as tracer:
        t = threading.Thread(target=lambda: rec._ring.append(None),
                             name="rogue-writer", daemon=True)
        t.start()
        t.join()
        (v,) = tracer.violations()
        assert (v.thread_name, v.field, v.op) == ("rogue-writer", "_ring",
                                                  "write")


def test_catches_a_record_that_skips_the_lock(monkeypatch):
    """Strip the lock from the port's own ``record``: the first call is
    flagged, single-threaded, with no timing luck needed."""
    monkeypatch.setattr(
        StepRecorder, "record",
        lambda self, kind, **data: self._record_locked(kind, None, data))
    rec = StepRecorder(capacity=8)
    with ThreadAccessTracer(rec) as tracer:
        rec.record("step_time", seconds=0.001)
        assert {v.field for v in tracer.violations()} == {"_counts", "_ring"}
        with pytest.raises(AssertionError):
            tracer.assert_clean()


def test_disarm_restores_the_recorder():
    rec = StepRecorder(capacity=16)
    orig = (rec._lock, rec._ring, rec._counts)
    with ThreadAccessTracer(rec):
        rec.record("a")
        assert rec._lock is not orig[0]
    assert (rec._lock, rec._ring, rec._counts) == orig
    assert type(rec._counts) is dict
    assert rec.counts()["a"] == 1
    assert [e.kind for e in rec.events()] == ["thread_audit", "a",
                                              "thread_audit"]


@pytest.mark.parametrize("kind", ["crash", "torn_snapshot"])
def test_clean_over_the_supervised_driver(tmp_path, kind):
    """The step loop, the asynchronous snapshot writer, the health pass,
    the flight recorder and the store drains all take the lock."""
    fault = (tservice.CrashFault(9) if kind == "crash"
             else tservice.TornSnapshotFault(snapshot_index=1))
    cfg = tservice.DriverConfig(
        grid_shape=(2, 2, 2), n_local=256, steps=24, seed=3,
        backend="torch", device="cpu", chunk=4, snapshot_every=4,
        snapshot_dir=str(tmp_path / "snaps"),
        store_dir=str(tmp_path / "store"),
        incident_dir=str(tmp_path / "inc"))
    rec = StepRecorder()
    plan = tservice.FaultPlan([fault])

    def factory(grid_shape=None):
        c = cfg
        if grid_shape is not None:
            c = dataclasses.replace(c, grid_shape=tuple(grid_shape))
        return tservice.ServiceDriver(c, recorder=rec, faults=plan)

    sup = tservice.Supervisor(
        factory, policy=tservice.RestartPolicy(
            max_restarts=5, backoff_base_s=0.01, backoff_cap_s=0.02),
        recorder=rec, sleep_fn=lambda s: None)
    with ThreadAccessTracer(rec) as tracer:
        verdict = sup.run()
        tracer.assert_clean()
        assert tracer.accesses
    assert verdict.ok is True, verdict
    reader = store.StoreReader(str(tmp_path / "store"), verify=True)
    # the arm event predates the store's first drain; the disarm follows
    # the last, so the store holds the counts at its last drain
    assert reader.counts()["thread_audit"] == 1


def test_clean_under_concurrent_scrapes():
    """``metrics_serve`` over a LIVE ring written by a step thread:
    parallel ``/metrics``, ``/query`` and cursor-resumed ``/events``."""
    import json

    rec = StepRecorder(capacity=512, host="h0", pid=1)
    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), metrics_serve.make_handler(lambda: rec))
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    errors = []

    def get(path):
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.read().decode("utf-8")

    def writer():
        for i in range(300):
            rec.record("step_time", step=i, seconds=0.001)

    def reader(path, n=8):
        try:
            cursor = ""
            for _ in range(n):
                body = get(path.format(cursor=cursor))
                if path.startswith("/events"):
                    cursor = json.loads(body)["cursor"]
        except Exception as e:  # surfaced below
            errors.append(e)

    try:
        with ThreadAccessTracer(rec) as tracer:
            threads = [threading.Thread(target=writer, daemon=True)] + [
                threading.Thread(target=reader, args=(p,), daemon=True)
                for p in ("/metrics", "/metrics",
                          "/query?agg=count&window_s=60",
                          "/events?limit=64&cursor={cursor}")]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not errors, errors
            tracer.assert_clean()
            assert len(tracer.by_thread()) >= 3
    finally:
        server.shutdown()
        server.server_close()
    assert rec.counts()["step_time"] == 300
