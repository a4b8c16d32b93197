"""The port's flight recorder (``telemetry/incident.py``) against the JAX
package's on the CPU.

The same seeded journal goes into both packages' recorders, under the
same step context, and each flight recorder captures with the same
injected clock: the bundles of an ALERT, of a fault scan and of a
regression label are byte-equal file for file. The one named
difference is ``env.json``, the machine fingerprint (the port's names
torch, its CUDA and the card; the reference's jax and its backend): of
it only the python version is compared. ``metrics.prom`` is byte-equal too: the
journal replay carries no roof, so no line of it changes. Also:
debounce per rule, the ``keep`` bound, ``install`` idempotent across
monitor restarts, the driver's bundles under a supervised SLO breach,
and the ``incident`` tool's ``list``/``show``/``export``."""

import dataclasses
import json
import os

import pytest

from mpi_grid_redistribute_tpu.telemetry import StepRecorder as JRecorder
from mpi_grid_redistribute_tpu.telemetry import context as jcontext
from mpi_grid_redistribute_tpu.telemetry import incident as jincident
from mpi_grid_redistribute_tpu_torch import service as tservice
from mpi_grid_redistribute_tpu_torch.telemetry import StepRecorder
from mpi_grid_redistribute_tpu_torch.telemetry import context as tcontext
from mpi_grid_redistribute_tpu_torch.telemetry import health
from mpi_grid_redistribute_tpu_torch.telemetry import incident
from mpi_grid_redistribute_tpu_torch.tools import incident as incident_cli

PKGS = {"j": (JRecorder, jcontext, jincident),
        "t": (StepRecorder, tcontext, incident)}
# the bundle file whose bytes name the machine: only its python compared
MACHINE_FILES = {"env.json"}


def _seeded_journal(rec, context_lib, n=6):
    """A small deterministic journal under a fixed context: migrate steps,
    a flow snapshot, an alert and a fault."""
    with context_lib.use(context_lib.StepContext(
            trace="fixed-trace", step=7, attempt=0, origin="test")):
        for s in range(n):
            rec.record_at("migrate_step", 100.0 + s, step=s, sent=4 + s,
                          received=4 + s, backlog=s, dropped_recv=0,
                          population=64)
            rec.record_at("step_latency", 100.2 + s, step=s + 1,
                          seconds=0.001 * (s + 1), dropped=0)
        rec.record_at("flow_snapshot", 100.5, steps=1, n_ranks=2,
                      moved_rows_total=4, imbalance=1.25,
                      top_pairs=[[0, 1, 3]])
        rec.record_at("alert", 101.0, rule="backlog_growth",
                      severity="ALERT", reason="backlog grew")
        rec.record_at("fault_injected", 102.0, fault="crash", step=5)


def _pair(tmp_path, **fr_kw):
    """``{name: (recorder, flight recorder)}`` for both packages over the
    same seeded journal, bundles under ``tmp_path / name``."""
    out = {}
    for name, (rec_cls, ctx, inc) in PKGS.items():
        rec = rec_cls(host="h0", pid=3)
        _seeded_journal(rec, ctx)
        kw = dict(clock=lambda: 111.0)
        kw.update(fr_kw)
        out[name] = (rec, inc.FlightRecorder(rec, str(tmp_path / name),
                                             **kw))
    return out


def assert_same_bundle(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        wa = open(os.path.join(a, name), "rb").read()
        wb = open(os.path.join(b, name), "rb").read()
        if name in MACHINE_FILES:
            assert json.loads(wb)["python"] == json.loads(wa)["python"]
            continue
        assert wb == wa, f"{name} differs from the reference's"


TRIGGERS = {
    "alert": lambda fr: [fr.capture(rule="backlog_growth",
                                    reason="backlog grew")],
    "fault_scan": lambda fr: fr.scan_faults(),
    "regression": lambda fr: fr.capture_regression(
        lines=["REGRESSION  value: current 1 vs best 2", "OK  ms_per_step"],
        labels={"value": "REGRESSION", "ms_per_step": "OK"}),
    "on_finding": lambda fr: [fr.on_finding(health.Finding(
        "backlog_growth", health.ALERT, "backlog grew"))],
}


@pytest.mark.parametrize("trigger", list(TRIGGERS))
def test_bundle_bytes_equal_reference(tmp_path, trigger):
    pair = _pair(tmp_path)
    made = {name: TRIGGERS[trigger](fr) for name, (_, fr) in pair.items()}
    assert len(made["t"]) == 1 and made["t"][0] is not None
    assert [os.path.basename(p) for p in made["t"]] == [
        os.path.basename(p) for p in made["j"]]
    assert_same_bundle(made["j"][0], made["t"][0])
    env = json.load(open(os.path.join(made["t"][0], "env.json")))
    assert env["torch"] and env["device"] == "cpu"
    # the incident event each journaled after its files
    (jrec, _), (trec, _) = pair["j"], pair["t"]
    assert trec.last("incident").data == jrec.last("incident").data
    assert trec.counts() == jrec.counts()


def test_second_bundle_holds_the_first_incident(tmp_path):
    """A later bundle's frozen window holds the first capture's
    ``incident`` event (id, not path): still byte-equal."""
    pair = _pair(tmp_path, debounce_s=0.0)
    outs = {}
    for name, (_, fr) in pair.items():
        fr.capture(rule="r1", reason="x")
        outs[name] = fr.capture(rule="r2", reason="y")
    assert_same_bundle(outs["j"], outs["t"])
    lines = open(os.path.join(outs["t"], "journal.jsonl")).read()
    assert '"kind": "incident"' in lines


def test_debounce_and_prune(tmp_path):
    rec = StepRecorder()
    _seeded_journal(rec, tcontext)
    now = [0.0]
    fr = incident.FlightRecorder(rec, str(tmp_path), debounce_s=60.0,
                                 keep=2, clock=lambda: now[0])
    assert fr.capture(rule="r1", reason="x") is not None
    now[0] = 30.0
    assert fr.capture(rule="r1", reason="x") is None  # inside the window
    assert fr.capture(rule="r2", reason="y") is not None  # its own clock
    now[0] = 120.0
    assert fr.capture(rule="r1", reason="x") is not None
    ids = [e["id"] for e in incident.list_bundles(tmp_path)]
    assert len(ids) == 2 and "incident-0003-r1" in ids
    assert rec.counts()["incident"] == 3
    with pytest.raises(ValueError, match="keep"):
        incident.FlightRecorder(rec, str(tmp_path), keep=0)
    with pytest.raises(ValueError, match="debounce_s"):
        incident.FlightRecorder(rec, str(tmp_path), debounce_s=-1)


def test_install_idempotent_across_monitor_restarts(tmp_path):
    rec = StepRecorder()
    mon1 = health.HealthMonitor(rec, rules=[])
    fr = incident.install(mon1, rec, tmp_path)
    assert incident.install(mon1, rec, tmp_path) is fr
    assert sum(getattr(cb, "__self__", None) is fr
               for cb in mon1.callbacks) == 1
    mon2 = health.HealthMonitor(rec, rules=[])
    assert incident.install(mon2, rec, tmp_path) is fr
    assert any(getattr(cb, "__self__", None) is fr for cb in mon2.callbacks)
    assert incident.install(mon2, rec, tmp_path / "other") is not fr


def test_scan_faults_cursor_and_list_load(tmp_path):
    rec = StepRecorder()
    _seeded_journal(rec, tcontext)
    fr = incident.FlightRecorder(rec, str(tmp_path), debounce_s=0.0,
                                 clock=lambda: 5.0)
    (first,) = fr.scan_faults()
    index = json.load(open(os.path.join(first, "index.json")))
    assert index["rule"] == "fault_crash" and index["trigger"] == "fault"
    assert index["context"]["trace"] == "fixed-trace"
    assert fr.scan_faults() == []  # the cursor advanced
    bad = tmp_path / "incident-9999-bad"
    bad.mkdir()
    (bad / "index.json").write_text("{not json")
    entries = incident.list_bundles(tmp_path)
    assert "error" in entries[0]
    loaded = incident.load_bundle(tmp_path, "incident-0001-fault_crash")
    assert "journal.jsonl" in loaded["files_present"]
    assert incident.list_bundles(tmp_path / "missing") == []


def test_driver_supervised_slo_breach_freezes_bundles(tmp_path):
    """The port's driver with ``incident_dir`` (torch on the CPU): an
    injected latency spike breaches the p99 SLO under the supervisor;
    alert- AND fault-triggered bundles are frozen, all under the run's
    one trace, one bundle per ALERT rule across restarts (the flight
    recorder survives them), and the journaled ``incident`` events
    mirror the bundles one to one."""
    bundles = tmp_path / "incidents"
    cfg = tservice.DriverConfig(
        grid_shape=(2, 2, 2), n_local=256, steps=32, seed=3,
        backend="torch", device="cpu", snapshot_every=4,
        snapshot_dir=str(tmp_path / "snaps"), slo_latency_p99_s=0.25,
        slo_window=4, incident_dir=str(bundles))
    rec = StepRecorder()
    faults = tservice.FaultPlan(
        [tservice.LatencySpikeFault(2, seconds=1.0, spikes=6)])

    def factory(grid_shape=None):
        c = cfg
        if grid_shape is not None:
            c = dataclasses.replace(c, grid_shape=tuple(grid_shape))
        return tservice.ServiceDriver(c, recorder=rec, faults=faults)

    sup = tservice.Supervisor(
        factory, policy=tservice.RestartPolicy(
            max_restarts=5, backoff_base_s=0.01, backoff_cap_s=0.02,
            shrink_after=2),
        recorder=rec, sleep_fn=lambda s: None)
    verdict = sup.run()
    assert verdict.ok is True and verdict.restarts >= 1, verdict
    entries = incident.list_bundles(bundles)
    assert entries and all("error" not in e for e in entries)
    assert {"alert", "fault"} <= {e["trigger"] for e in entries}
    traces = {e["context"].get("trace") for e in entries}
    assert len(traces) == 1 and None not in traces
    alert_rules = {e.data["rule"] for e in rec.events("alert")
                   if e.data.get("severity") == health.ALERT}
    bundle_rules = [e["rule"] for e in entries if e["trigger"] == "alert"]
    assert "slo_latency_p99" in bundle_rules
    assert sorted(bundle_rules) == sorted(set(bundle_rules))
    assert set(bundle_rules) <= alert_rules
    assert sorted(e.data["id"] for e in rec.events("incident")) == sorted(
        e["id"] for e in entries)


def test_incident_cli_list_show_export(tmp_path, capsys):
    rec = StepRecorder()
    _seeded_journal(rec, tcontext)
    fr = incident.FlightRecorder(rec, str(tmp_path), clock=lambda: 7.0)
    fr.capture(rule="backlog_growth", reason="backlog grew")
    bid = "incident-0001-backlog_growth"
    assert incident_cli.main(["list", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert bid in out and "trigger=alert" in out
    assert "trace=fixed-trace" in out
    assert incident_cli.main(["list", str(tmp_path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)[0]["id"] == bid
    assert incident_cli.main(["show", str(tmp_path), bid]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["rule"] == "backlog_growth"
    assert "journal.jsonl" in doc["files_present"]
    with pytest.raises(SystemExit):
        incident_cli.main(["show", str(tmp_path), "incident-0000-nope"])
    trace_out = tmp_path / "trace.json"
    assert incident_cli.main(["export", str(tmp_path), bid, "--out",
                              str(trace_out)]) == 0
    assert "perfetto" in capsys.readouterr().out
    phases = {e.get("ph") for e in json.load(open(trace_out))["traceEvents"]}
    assert {"s", "f"} <= phases  # the context's causal arrow
    assert incident_cli.main(["list", str(tmp_path / "empty")]) == 0
    assert "no bundles" in capsys.readouterr().out
