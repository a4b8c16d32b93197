"""Run index over the port's evidence: headline captures and journal-store
runs, one trajectory view (the twin of the JAX package's
``scripts/history.py``).

It indexes the port's headline captures (``bench/headline.py`` JSON
lines, or ``BENCH``-style wrappers with ``parsed``) and
``telemetry.store`` roots (what a service driver started with
``--store-dir`` leaves), renders the trajectory across captures and,
with ``--check``, classifies one capture against every indexed one
through ``telemetry.regress.classify_capture``.

``--bench GLOB`` has no default: the repo's ``BENCH_r*.json`` are TPU
captures of the reference, never the card's history. A capture that is
not the port's (a TPU capture, or one with no fingerprint) is refused
with exit 2, as ``telemetry.regress.main`` refuses it.

    python -m mpi_grid_redistribute_tpu_torch.tools.history \\
        --bench 'captures/*.json' --stores runs/
    python -m mpi_grid_redistribute_tpu_torch.tools.history \\
        --bench 'captures/*.json' --json
    python -m mpi_grid_redistribute_tpu_torch.tools.history \\
        --bench 'captures/*.json' --check capture.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

_SPARK = "▁▂▃▄▅▆▇█"


def _load(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def index_benches(patterns):
    """Index captures: one entry per readable file matching
    ``patterns`` (revision number parsed from the filename, guarded
    metrics via ``regress.extract_metrics``, ``stack`` the package whose
    fingerprint it carries: ``"torch"``, ``"jax"`` or None), ordered by
    revision."""
    from mpi_grid_redistribute_tpu_torch.telemetry import regress

    entries = []
    for pattern in patterns:
        for path in sorted(glob.glob(pattern)):
            try:
                doc = _load(path)
            except (OSError, ValueError) as e:
                entries.append(
                    {"path": path, "error": str(e), "metrics": None}
                )
                continue
            m = re.search(r"r(\d+)", os.path.basename(path))
            parsed = doc.get("parsed", doc) if isinstance(doc, dict) else {}
            entries.append(
                {
                    "path": path,
                    "rev": int(m.group(1)) if m else None,
                    "metrics": regress.extract_metrics(doc),
                    "spread": regress._spread_of(doc),
                    "platform": (
                        (regress._env_of(doc) or {}).get("platform")
                    ),
                    "stack": regress._stack_of(doc),
                    "config": parsed.get("config")
                    if isinstance(parsed, dict)
                    else None,
                    "doc": doc,
                }
            )
    entries.sort(key=lambda e: (e.get("rev") is None, e.get("rev"), e["path"]))
    return entries


def index_stores(root):
    """Index journal-store runs under ``root``: writer, span, exact
    event totals and the merged-store p99 per run, newest first."""
    from mpi_grid_redistribute_tpu_torch.telemetry import store as store_lib

    entries = []
    for store_root in store_lib.list_stores(root):
        try:
            reader = store_lib.StoreReader(store_root)
        except store_lib.StoreCorruptError as e:
            entries.append({"root": store_root, "error": str(e)})
            continue
        man = reader.manifest
        counts = reader.counts()
        h = reader.latency_histogram()
        entries.append(
            {
                "root": store_root,
                "writer": man.get("writer"),
                "created": man.get("created"),
                "updated": man.get("updated"),
                "events_total": sum(counts.values()),
                "steps": counts.get("step_latency", 0),
                "p99_s": h.quantile(0.99) if h.count else None,
                "segments": len(man.get("segments", [])),
                "retired": man.get("retired", {}).get("segments", 0),
                "bytes": sum(s["bytes"] for s in man.get("segments", []))
                + (man.get("active") or {}).get("bytes", 0),
            }
        )
    return entries


def build_index(bench_patterns, stores_root=None):
    benches = index_benches(bench_patterns)
    index = {
        "benches": [
            {k: v for k, v in e.items() if k != "doc"} for e in benches
        ],
        "stores": index_stores(stores_root) if stores_root else [],
    }
    return index, benches


def sparkline(values):
    vals = [v for v in values if v is not None]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    out = []
    for v in values:
        if v is None:
            out.append(" ")
        else:
            out.append(_SPARK[int((v - lo) / span * (len(_SPARK) - 1))])
    return "".join(out)


def render_trajectory(benches, stores):
    """Human view: the headline metric across revisions plus each
    indexed store run."""
    lines = ["run history"]
    usable = [b for b in benches if b.get("metrics")]
    if usable:
        values = [b["metrics"].get("value") for b in usable]
        lines.append(
            "  bench trajectory (value = particles/sec/card)   "
            + sparkline(values)
        )
        best = max(v for v in values if v is not None)
        for b in usable:
            v = b["metrics"].get("value")
            ms = b["metrics"].get("ms_per_step")
            rel = f"{v / best * 100:5.1f}% of best" if v else ""
            lines.append(
                f"    r{b['rev']:02d}  value={v:.4g}"
                + (f"  ms_per_step={ms:.4g}" if ms else "")
                + (f"  [{b['platform']}]" if b.get("platform") else "")
                + f"  {rel}"
            )
    else:
        lines.append("  (no usable bench captures)")
    bad = [b for b in benches if b.get("error")]
    for b in bad:
        lines.append(f"    unreadable: {b['path']}: {b['error']}")
    if stores:
        lines.append("  store runs (newest first)")
        for s in stores:
            if s.get("error"):
                lines.append(f"    corrupt: {s['root']}: {s['error']}")
                continue
            writer = s.get("writer") or {}
            p99 = s.get("p99_s")
            lines.append(
                f"    {s['root']}  steps={s['steps']}"
                f"  events={s['events_total']}"
                + (f"  p99={p99:.4g}s" if p99 is not None else "")
                + f"  segs={s['segments']}(+{s['retired']})"
                + (
                    f"  writer={writer.get('host')}:{writer.get('pid')}"
                    if writer
                    else ""
                )
            )
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Index bench captures + journal-store runs; render "
        "the perf trajectory or gate a capture against it."
    )
    p.add_argument(
        "--bench",
        action="append",
        default=[],
        metavar="GLOB",
        help="glob of the port's headline captures (repeatable; no "
        "default: the repo's BENCH_r*.json are TPU captures)",
    )
    p.add_argument(
        "--stores",
        metavar="DIR",
        help="directory to scan for journal-store roots (each child "
        "with a MANIFEST.json is one run)",
    )
    p.add_argument("--json", action="store_true",
                   help="print the run-index as JSON and exit")
    p.add_argument(
        "--check",
        metavar="CAPTURE",
        help="classify CAPTURE (a bench JSON line or BENCH wrapper) "
        "against the indexed history via regress.classify_capture; "
        "exit 1 on REGRESSION",
    )
    p.add_argument("--threshold", type=float, default=0.10,
                   help="regression threshold for --check")
    args = p.parse_args(argv)

    from mpi_grid_redistribute_tpu_torch.telemetry import regress

    index, benches = build_index(args.bench, args.stores)
    foreign = [b["path"] for b in benches
               if not b.get("error") and b.get("stack") != "torch"]
    if foreign:
        # a TPU capture (or one with no fingerprint) is another machine
        # and another program: never a point of the card's trajectory
        print(
            f"history: refused: {len(foreign)} capture(s) are not the "
            "port's (a TPU capture or no fingerprint): "
            + ", ".join(foreign[:5]), file=sys.stderr)
        return 2

    if args.check:
        try:
            current = _load(args.check)
        except (OSError, ValueError) as e:
            print(f"history: cannot read capture: {e}", file=sys.stderr)
            return 1
        if regress._stack_of(current) != "torch":
            print("history: refused: the capture to check has no port "
                  "fingerprint (env.torch)", file=sys.stderr)
            return 2
        history = [b["doc"] for b in benches if b.get("metrics")]
        ok, lines, _labels = regress.classify_capture(
            current, history, threshold=args.threshold
        )
        print(f"history: capture vs {len(history)} indexed runs")
        for ln in lines:
            print("  " + ln)
        return 0 if ok else 1

    if args.json:
        json.dump(index, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
        return 0

    sys.stdout.write(render_trajectory(benches, index["stores"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
