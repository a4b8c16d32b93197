"""End-to-end incident-observatory smoke on the port (the twin of the JAX
package's ``scripts/incident_demo.py``).

A supervised service run of the port's torch driver, on the card
(``--device cpu``: on the CPU), with an injected latency-spike flood,
breaches the p99 SLO; the health pass fires the
:class:`~..telemetry.incident.FlightRecorder`, and the bundles are
checked end to end (the reference drives its numpy backend; the
assertions are its four):

* I001: at least one debounced bundle exists, alert- and
  fault-triggered;
* I002: every ``index.json`` carries the triggering step context (the
  ``trace`` join key of ``telemetry/context.py``);
* I003: a standing rule re-confirmed across restarts stays debounced to
  ONE bundle;
* I004: the frozen journal window exports to a Perfetto trace whose
  causal flow arrows (``ph="s"/"f"``) link the cause step to the alert.

    python -m mpi_grid_redistribute_tpu_torch.tools.incident_demo
    python -m mpi_grid_redistribute_tpu_torch.tools.incident_demo \\
        --check --device cpu [--format=sarif]
    python -m mpi_grid_redistribute_tpu_torch.tools.incident_demo \\
        --keep DIR

``--check``: exit 0 clean, 1 findings, 2 usage error; findings recorded
in ``analysis/incident_demo_baseline.json`` (none: an incident fault is
fixed, never baselined; ``--update-baseline`` writes it) are reported
apart and do not fail.
"""

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile

RULE_DOCS = {
    "I001": "a fault-injected supervised run must leave at least one "
    "incident bundle behind (alert- and fault-triggered)",
    "I002": "every bundle index must carry the triggering step context "
    "(trace join key)",
    "I003": "a standing alert re-confirmed across restarts must stay "
    "debounced to one bundle per rule",
    "I004": "a bundle's frozen journal must export to a Perfetto trace "
    "with causal flow arrows",
}

# the explanation the committed baseline file carries
BASELINE_DOC = [
    "Expected-clean contract for `python -m",
    "mpi_grid_redistribute_tpu_torch.tools.incident_demo --check`: a",
    "fault-injected supervised torch run must leave debounced bundles",
    "with both triggers (I001), a trace id in every index (I002), one",
    "bundle per standing rule across restarts (I003) and a frozen",
    "journal that exports to a Perfetto trace with flow arrows (I004).",
    "An incident fault is fixed, never baselined.",
]

_SELF = "mpi_grid_redistribute_tpu_torch/tools/incident_demo.py"


def _finding(rule, message):
    from mpi_grid_redistribute_tpu_torch.analysis.core import Finding

    return Finding(rule=rule, path=_SELF, line=1, col=0, message=message)


def run_demo(out_dir, verbose=True, device=None):
    """Drive the incident loop on ``device`` (``None``: the GPU, raising
    without one); returns (findings, bundle entries)."""
    from mpi_grid_redistribute_tpu_torch.service import (
        DriverConfig,
        FaultPlan,
        LatencySpikeFault,
        RestartPolicy,
        ServiceDriver,
        Supervisor,
    )
    from mpi_grid_redistribute_tpu_torch.telemetry import (
        StepRecorder,
        incident,
        merge_journals,
        traceview,
    )

    snaps = os.path.join(out_dir, "snaps")
    bundles = os.path.join(out_dir, "incidents")
    cfg = DriverConfig(
        grid_shape=(2, 2, 2),
        n_local=256,
        steps=32,
        seed=3,
        backend="torch",
        device=device,
        snapshot_every=4,
        snapshot_dir=snaps,
        slo_latency_p99_s=0.25,
        slo_window=4,
        incident_dir=bundles,
    )
    rec = StepRecorder()
    plan = FaultPlan([LatencySpikeFault(2, seconds=1.0, spikes=6)])

    def factory(grid_shape=None):
        c = cfg
        if grid_shape is not None:
            c = dataclasses.replace(c, grid_shape=tuple(grid_shape))
        return ServiceDriver(c, recorder=rec, faults=plan)

    sup = Supervisor(
        factory,
        policy=RestartPolicy(
            max_restarts=5, backoff_base_s=0.01, backoff_cap_s=0.02,
            shrink_after=2,
        ),
        recorder=rec,
        sleep_fn=lambda s: None,
    )
    verdict = sup.run()
    if verbose:
        print(
            f"demo: supervised run done (ok={verdict.ok} "
            f"restarts={verdict.restarts} health={verdict.health})"
        )

    findings = []
    entries = incident.list_bundles(bundles)
    if verbose:
        for e in entries:
            print(
                f"demo: bundle {e.get('id')} rule={e.get('rule')} "
                f"trigger={e.get('trigger')} "
                f"trace={(e.get('context') or {}).get('trace')}"
            )
    if not entries:
        findings.append(_finding(
            "I001", "supervised fault run produced no incident bundles"
        ))
        return findings, entries
    triggers = {e.get("trigger") for e in entries}
    if not {"alert", "fault"} <= triggers:
        findings.append(_finding(
            "I001",
            f"expected both alert- and fault-triggered bundles, "
            f"got triggers {sorted(triggers)}",
        ))
    for e in entries:
        ctx = e.get("context") or {}
        if not ctx.get("trace"):
            findings.append(_finding(
                "I002",
                f"bundle {e.get('id')} index carries no trace id "
                f"(context={ctx})",
            ))
    rules = [e.get("rule") for e in entries]
    dupes = sorted({r for r in rules if rules.count(r) > 1})
    if dupes:
        findings.append(_finding(
            "I003",
            f"debounce failed: multiple bundles for rule(s) {dupes}",
        ))

    # export smoke: the alert-triggered bundle's frozen journal ->
    # Perfetto trace; the causal flow arrows must link cause -> alert
    target = next(
        (e for e in entries if e.get("trigger") == "alert"), entries[0]
    )
    journal = os.path.join(
        bundles, str(target.get("id")), "journal.jsonl"
    )
    trace_out = os.path.join(out_dir, "incident.trace.json")
    try:
        merged = merge_journals([journal])
        traceview.write_trace(trace_out, merged.to_recorder())
        with open(trace_out, "r", encoding="utf-8") as fh:
            events = json.load(fh)["traceEvents"]
        phases = {ev.get("ph") for ev in events}
        if not {"s", "f"} <= phases:
            findings.append(_finding(
                "I004",
                f"exported trace of {target.get('id')} has no causal "
                f"flow arrows (phases={sorted(phases)})",
            ))
        elif verbose:
            n_flow = sum(1 for ev in events if ev.get("ph") in ("s", "f"))
            print(
                f"demo: exported {trace_out} "
                f"({len(events)} events, {n_flow} flow endpoints)"
            )
    except Exception as exc:
        findings.append(_finding(
            "I004",
            f"bundle export failed: {type(exc).__name__}: {exc}",
        ))
    return findings, entries


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Fault-injected incident-observatory smoke: "
        "supervised run -> flight-recorder bundles -> Perfetto export."
    )
    p.add_argument(
        "--check",
        action="store_true",
        help="CI gate mode: findings only, exit 1 when any fire",
    )
    p.add_argument(
        "--format",
        choices=("text", "sarif"),
        default="text",
        help="finding output format (sarif implies --check semantics)",
    )
    p.add_argument(
        "--device",
        default=None,
        help="where the supervised driver runs (default: the GPU; 'cpu')",
    )
    p.add_argument(
        "--keep",
        metavar="DIR",
        default=None,
        help="run in DIR and keep the bundles (default: tempdir, "
        "removed on exit)",
    )
    p.add_argument(
        "--update-baseline",
        action="store_true",
        help="write this run's findings as the committed baseline "
        "(expected empty)",
    )
    args = p.parse_args(argv)

    out_dir = args.keep or tempfile.mkdtemp(prefix="incident_demo_")
    try:
        findings, _ = run_demo(out_dir, verbose=args.format != "sarif",
                               device=args.device)
    finally:
        if args.keep is None:
            shutil.rmtree(out_dir, ignore_errors=True)

    from mpi_grid_redistribute_tpu_torch.analysis import baseline, core

    path = baseline.incident_demo_baseline_path()
    if args.update_baseline:
        baseline.write_baseline(path, findings, BASELINE_DOC)
    findings, grandfathered = baseline.split_baselined(
        findings, baseline.load_baseline(path))
    if args.format == "sarif":
        from mpi_grid_redistribute_tpu_torch.analysis.sarif import to_sarif

        json.dump(
            to_sarif(findings, "incident-demo", RULE_DOCS),
            sys.stdout,
            indent=2,
        )
        print()
    else:
        for f in findings:
            print(f"{f.rule}: {f.message}")
        for f in grandfathered:
            print(f"{f.rule} (baselined): {f.message}")
        if not findings:
            print("incident-demo: clean")
    return core.exit_code(findings)


if __name__ == "__main__":
    sys.exit(main())
