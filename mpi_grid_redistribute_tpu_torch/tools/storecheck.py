"""Journal-store integrity checker over the port's ``JournalStore`` (the
twin of the JAX package's ``scripts/storecheck.py``).

It verifies the store's on-disk contract (``telemetry/store.py``): the
segment checksums against the manifest, the exact count ledger, segment
order, the rotation and retention bounds and compaction exactness. The
stores are byte-equal to the reference's, so this checker passes on a
store the reference wrote, and the reference's on one the port wrote.

With no argument it builds a demo store in a temporary directory: a live
``StepRecorder`` with a tiny ring drained through rotation, compaction
AND retention, the ring wrapping many times, then checks every
invariant end to end, the headline one included
(``metrics.from_journal`` over the drained and compacted store reports
all-time counts equal to the live recorder's, after eviction). With a
PATH it checks a real store's file-level invariants (ST01-ST03,
ST05-ST06).

    python -m mpi_grid_redistribute_tpu_torch.tools.storecheck
    python -m mpi_grid_redistribute_tpu_torch.tools.storecheck --check \\
        [--format=sarif]
    python -m mpi_grid_redistribute_tpu_torch.tools.storecheck STORE_DIR
    python -m mpi_grid_redistribute_tpu_torch.tools.storecheck --keep DIR

``--check`` gates the findings: exit 0 clean, 1 findings, 2 usage
error; findings recorded in ``analysis/storecheck_baseline.json`` (none:
any finding is a fault of the store; ``--update-baseline`` writes it)
are reported apart and do not fail. ``--format=sarif`` emits the
findings as one SARIF run.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

RULE_DOCS = {
    "ST01": "every closed segment's sha256 must match its manifest "
    "entry (torn/modified segments are corruption, not data)",
    "ST02": "count conservation: manifest all-time counts must equal "
    "retired + closed-segment + active + missed counts, per kind",
    "ST03": "closed segments must cover monotone, non-overlapping seq "
    "ranges, and the drain watermark must be their maximum",
    "ST04": "rotation bound: no closed segment may exceed the "
    "configured segment_events by more than one drain batch",
    "ST05": "retention bound: closed segments must fit the configured "
    "retain_bytes budget after every publish",
    "ST06": "compaction exactness: a summary segment's per-kind counts, "
    "window sketches, state-health corruption ledgers and verbatim "
    "non-step rows must reproduce its raw source exactly",
    "ST07": "end-to-end exactness: metrics.from_journal over the "
    "drained+compacted store must equal the live recorder's all-time "
    "counts after ring eviction, and its grid_state_* corruption "
    "totals must equal a direct walk of the retained segment files",
}

# the explanation the committed baseline file carries
BASELINE_DOC = [
    "Expected-clean contract for `python -m",
    "mpi_grid_redistribute_tpu_torch.tools.storecheck --check`: the",
    "journal-store demo (rotation + compaction + retention on a wrapping",
    "ring) must satisfy every ST01-ST07 invariant, including exact",
    "all-time counts from a drained and compacted store after eviction.",
    "Any finding is a fault of telemetry/store.py: fix the store, do not",
    "add entries here.",
]

_SELF = "mpi_grid_redistribute_tpu_torch/tools/storecheck.py"


def _finding(rule, message):
    from mpi_grid_redistribute_tpu_torch.analysis.core import Finding

    return Finding(rule=rule, path=_SELF, line=1, col=0, message=message)


def _check_segments(reader, root):
    """ST01 + ST03 over a reader's manifest."""
    from mpi_grid_redistribute_tpu_torch.telemetry import store as store_lib

    findings = []
    try:
        reader.verify()
    except store_lib.StoreCorruptError as e:
        findings.append(_finding("ST01", str(e)))
    man = reader.manifest
    prev_max = None
    prev_name = None
    for seg in man["segments"]:
        lo, hi = seg.get("seq_min"), seg.get("seq_max")
        if lo is None or hi is None or lo > hi:
            findings.append(_finding(
                "ST03",
                f"{seg['name']} has a bad seq range [{lo}, {hi}]",
            ))
            continue
        if prev_max is not None and lo <= prev_max:
            findings.append(_finding(
                "ST03",
                f"{seg['name']} seq range [{lo}, {hi}] overlaps "
                f"{prev_name} (ends at {prev_max})",
            ))
        prev_max, prev_name = hi, seg["name"]
    tail = man.get("active") or (
        man["segments"][-1] if man["segments"] else None
    )
    if tail and tail.get("seq_max") is not None:
        if int(man["drained_seq"]) != int(tail["seq_max"]):
            findings.append(_finding(
                "ST03",
                f"drain watermark {man['drained_seq']} != newest "
                f"segment's seq_max {tail['seq_max']}",
            ))
    return findings


def _check_ledger(man):
    """ST02: exact count conservation across the whole store life."""
    findings = []
    total = {k: int(v) for k, v in man["retired"]["counts"].items()}

    def fold(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + int(v)

    for seg in man["segments"]:
        fold(seg["counts"])
    if man.get("active"):
        fold(man["active"]["counts"])
    fold(man.get("missed", {}))
    declared = {k: int(v) for k, v in man["counts"].items()}
    if total != declared:
        diff = {
            k: (total.get(k, 0), declared.get(k, 0))
            for k in set(total) | set(declared)
            if total.get(k, 0) != declared.get(k, 0)
        }
        findings.append(_finding(
            "ST02",
            f"count ledger broken (ledger vs manifest): {diff}",
        ))
    return findings


def _check_retention(man):
    """ST05 against the manifest's own recorded config."""
    budget = int(man.get("config", {}).get("retain_bytes", 0))
    if not budget:
        return []
    closed = sum(int(s["bytes"]) for s in man["segments"])
    if closed > budget:
        return [_finding(
            "ST05",
            f"closed segments hold {closed} bytes "
            f"(> retain_bytes {budget})",
        )]
    return []


def _check_compaction(reader, root):
    """ST06: re-derive every summary segment's ledger from its file."""
    from mpi_grid_redistribute_tpu_torch.telemetry.store import COMPACT_KINDS

    findings = []
    for seg in reader.manifest["segments"]:
        if seg.get("kind") != "summary":
            continue
        path = os.path.join(root, seg["name"])
        windows = []
        verbatim = {}
        try:
            with open(path, encoding="utf-8") as f:
                for ln in f:
                    if not ln.strip():
                        continue
                    row = json.loads(ln)
                    if row.get("kind") == "store_window":
                        windows.append(row)
                    else:
                        k = row.get("kind")
                        verbatim[k] = verbatim.get(k, 0) + 1
        except (OSError, ValueError) as e:
            findings.append(_finding(
                "ST06", f"{seg['name']} unreadable: {e}"
            ))
            continue
        # re-derived per-kind counts: window ledgers + verbatim rows
        derived = dict(verbatim)
        sketched = 0
        for w in windows:
            for k, v in w.get("counts", {}).items():
                derived[k] = derived.get(k, 0) + int(v)
            sketched += int(w.get("latency", {}).get("count", 0))
        declared = {k: int(v) for k, v in seg["counts"].items()}
        if derived != declared:
            findings.append(_finding(
                "ST06",
                f"{seg['name']} counts diverge from its rows: "
                f"file {derived} vs manifest {declared}",
            ))
        if sum(declared.values()) != int(seg["events"]):
            findings.append(_finding(
                "ST06",
                f"{seg['name']} counts sum "
                f"{sum(declared.values())} != events {seg['events']}",
            ))
        # every step_latency the raw segment held must be in a sketch
        expect = declared.get("step_latency", 0)
        if sketched != expect:
            findings.append(_finding(
                "ST06",
                f"{seg['name']} latency sketches hold {sketched} "
                f"samples, source had {expect} step_latency events",
            ))
        bad_kind = [k for k in verbatim if k in COMPACT_KINDS]
        if bad_kind:
            findings.append(_finding(
                "ST06",
                f"{seg['name']} kept per-step kind(s) {bad_kind} "
                f"verbatim (should be windowed)",
            ))
        # a window that swallowed state_health rows must carry the
        # corruption ledger, or compaction silently forgot corruption
        for w in windows:
            n_state = int(w.get("counts", {}).get("state_health", 0))
            if n_state and "state" not in w:
                findings.append(_finding(
                    "ST06",
                    f"{seg['name']} window at seq {w.get('seq')} holds "
                    f"{n_state} state_health rows but no state ledger",
                ))
    return findings


def _state_totals_from_disk(reader, root):
    """Corrupt-row totals re-derived by walking every retained segment
    file directly: raw ``state_health`` rows plus the ``state`` ledgers
    of compacted windows. The independent ground truth ST07 holds
    ``metrics.from_journal`` (which folds the same two row shapes
    through a different code path) to."""
    totals = {"nan_pos": 0, "nan_vel": 0, "oob": 0}
    man = reader.manifest
    segs = list(man["segments"])
    if man.get("active"):
        segs.append(man["active"])
    for seg in segs:
        with open(os.path.join(root, seg["name"]), encoding="utf-8") as f:
            for ln in f:
                if not ln.strip():
                    continue
                row = json.loads(ln)
                if row.get("kind") == "state_health":
                    for k in totals:
                        totals[k] += int(row.get(k, 0))
                elif row.get("kind") == "store_window":
                    st = row.get("state")
                    if st:
                        for k in totals:
                            totals[k] += int(st.get(k, 0))
    return totals


def check_store(root, batch_bound=None):
    """File-level invariants on any store root. ``batch_bound`` (max
    events one drain can append — the ring capacity in the demo)
    enables the ST04 rotation bound."""
    from mpi_grid_redistribute_tpu_torch.telemetry import store as store_lib

    try:
        reader = store_lib.StoreReader(root)
    except store_lib.StoreCorruptError as e:
        return [_finding("ST01", str(e))], None
    man = reader.manifest
    findings = []
    findings += _check_segments(reader, root)
    findings += _check_ledger(man)
    findings += _check_retention(man)
    findings += _check_compaction(reader, root)
    if batch_bound is not None:
        limit = int(man["config"]["segment_events"]) + int(batch_bound)
        for seg in man["segments"]:
            if int(seg["events"]) > limit:
                findings.append(_finding(
                    "ST04",
                    f"{seg['name']} holds {seg['events']} events "
                    f"(> segment_events + drain batch = {limit})",
                ))
    return findings, reader


def run_demo(out_dir, verbose=True):
    """Build a demo store through rotation/compaction/retention with a
    wrapping ring; returns (findings, reader)."""
    from mpi_grid_redistribute_tpu_torch import telemetry
    from mpi_grid_redistribute_tpu_torch.telemetry import (
        StepRecorder,
        record_chunk_steps,
    )
    from mpi_grid_redistribute_tpu_torch.telemetry import store as store_lib

    root = os.path.join(out_dir, "store")
    capacity = 96
    rec = StepRecorder(capacity=capacity, host="demo", pid=1)
    st = store_lib.JournalStore(
        root,
        segment_events=120,
        segment_bytes=1 << 20,
        retain_bytes=26 << 10,
        compact_after=1,
        compact_window=16,
    )
    # 20 chunks x 45 step_latency events + a sprinkling of non-step
    # events: the 96-slot ring wraps ~9x, rotation closes ~8 segments,
    # compaction summarises all but the newest, retention retires the
    # oldest — every lifecycle path runs. Each chunk also journals a
    # few probed-run state_health rows with two NaN/OOB
    # bursts late enough to survive retention, so the compacted
    # windows' corruption ledgers are exercised non-vacuously
    for chunk in range(20):
        record_chunk_steps(rec, chunk * 45, 0.002, [0] * 45)
        for i in range(3):
            rec.record(
                "state_health",
                step=chunk * 45 + 15 * i,
                live=360,
                nan_pos=4 if (chunk, i) == (16, 1) else 0,
                nan_vel=0,
                oob=2 if (chunk, i) == (18, 2) else 0,
                residual=0,
            )
        if chunk % 4 == 0:
            rec.record(
                "alert", rule="demo_rule", severity="warn",
                reason=f"chunk {chunk}",
            )
        if chunk % 7 == 0:
            rec.record("flow_snapshot", imbalance=1.0 + 0.01 * chunk)
        st.drain(rec)
    st.close(rec)

    findings, reader = check_store(root, batch_bound=capacity)
    if reader is None:
        return findings, None
    man = reader.manifest

    # the demo must actually exercise the machinery it claims to check
    if rec.evicted <= 0:
        findings.append(_finding(
            "ST07", "demo ring never wrapped; exactness check is vacuous"
        ))
    if man["retired"]["segments"] < 1:
        findings.append(_finding(
            "ST05", "demo retention never retired a segment"
        ))
    if not any(s["kind"] == "summary" for s in man["segments"]):
        findings.append(_finding(
            "ST06", "demo compaction never produced a summary segment"
        ))

    # ST07: the headline — counts from disk == live recorder counts
    live = rec.counts()
    stored = reader.counts()
    if stored != live:
        findings.append(_finding(
            "ST07",
            f"store counts != live recorder counts after eviction: "
            f"store {stored} vs live {live}",
        ))
    reg = telemetry.MetricsRegistry.from_journal(reader)
    fam = reg.get("grid_journal_events")  # rendered with _total suffix
    scraped = {}
    for values, child in fam.children():  # labelnames == ("kind",)
        scraped[values[0]] = int(child._value)
    if scraped != {k: int(v) for k, v in live.items()}:
        findings.append(_finding(
            "ST07",
            f"from_journal counters diverge from the live recorder: "
            f"scraped {scraped} vs live {live}",
        ))

    # ST07 state leg: the scrape's corruption totals (raw state_health
    # rows for the newest segments, compacted `state` ledgers for the
    # rest) must equal a direct walk of the retained segment files
    disk = _state_totals_from_disk(reader, root)
    if not (disk["nan_pos"] and disk["oob"]):
        findings.append(_finding(
            "ST06",
            f"demo corruption bursts did not survive to a retained "
            f"segment ({disk}); state-ledger exactness is vacuous",
        ))
    state_scraped = {"nan_pos": 0, "nan_vel": 0, "oob": 0}
    for values, child in reg.get("grid_state_nan").children():
        state_scraped[f"nan_{values[0]}"] = int(child._value)
    for values, child in reg.get("grid_state_oob").children():
        state_scraped["oob"] = int(child._value)
    if state_scraped != disk:
        findings.append(_finding(
            "ST07",
            f"grid_state_* corruption totals diverge from the segment "
            f"files: scraped {state_scraped} vs disk {disk}",
        ))

    if verbose:
        kinds = ", ".join(f"{k}={v}" for k, v in sorted(live.items()))
        print(
            f"demo: {rec.total_recorded} events ({kinds}), "
            f"ring evicted {rec.evicted}"
        )
        print(
            f"demo: store {len(man['segments'])} segments "
            f"(+{man['retired']['segments']} retired, "
            f"{sum(1 for s in man['segments'] if s['kind'] == 'summary')}"
            f" summaries), {man['drains']} drains, missed={man['missed']}"
        )
        h = reader.latency_histogram()
        print(
            f"demo: merged latency histogram n={h.count} "
            f"p99={h.quantile(0.99):.6g}s"
        )
        print(
            f"demo: state corruption totals from disk "
            f"nan_pos={disk['nan_pos']} nan_vel={disk['nan_vel']} "
            f"oob={disk['oob']} (raw rows + compacted ledgers)"
        )
    return findings, reader


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Journal-store integrity checker: demo-store "
        "lifecycle invariants or a real store's file-level contract."
    )
    p.add_argument(
        "path",
        nargs="?",
        default=None,
        help="existing store root to check (default: build and check "
        "a demo store)",
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
        "--keep",
        metavar="DIR",
        default=None,
        help="build the demo store in DIR and keep it (default: "
        "tempdir, removed on exit)",
    )
    p.add_argument(
        "--update-baseline",
        action="store_true",
        help="write this run's findings as the committed baseline "
        "(expected empty)",
    )
    args = p.parse_args(argv)

    if args.path is not None:
        findings, _ = check_store(args.path)
    else:
        out_dir = args.keep or tempfile.mkdtemp(prefix="storecheck_")
        try:
            findings, _ = run_demo(
                out_dir, verbose=args.format != "sarif"
            )
        finally:
            if args.keep is None:
                shutil.rmtree(out_dir, ignore_errors=True)

    from mpi_grid_redistribute_tpu_torch.analysis import baseline, core

    path = baseline.storecheck_baseline_path()
    if args.update_baseline:
        baseline.write_baseline(path, findings, BASELINE_DOC)
    findings, grandfathered = baseline.split_baselined(
        findings, baseline.load_baseline(path))
    if args.format == "sarif":
        from mpi_grid_redistribute_tpu_torch.analysis.sarif import to_sarif

        json.dump(
            to_sarif(findings, "storecheck", RULE_DOCS),
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
            print("storecheck: clean")
    return core.exit_code(findings)


if __name__ == "__main__":
    sys.exit(main())
