"""The racecheck CLI (the twin of the JAX package's
``scripts/racecheck.py``): the host-thread shared-state checker of
``analysis/racecheck.py`` over the port's package, ``tools/`` included.

    python -m mpi_grid_redistribute_tpu_torch.tools.racecheck --check
    python -m mpi_grid_redistribute_tpu_torch.tools.racecheck \\
        [PATH ...] [--format=text|json|sarif|github] [--rules T001,T003]
    python -m mpi_grid_redistribute_tpu_torch.tools.racecheck --list-threads
    python -m mpi_grid_redistribute_tpu_torch.tools.racecheck \\
        --check-baseline             # stale entries only

Findings recorded in ``analysis/racecheck_baseline.json`` are reported
apart and do not fail; each entry carries the justification of why its
finding cannot occur at run time. ``--write-baseline`` rewrites the
entries and keeps the justification of every entry that still matches
(a new one is written unjustified, to be justified by hand or fixed).
Exit codes: 0 clean, 1 findings (or, with ``--check``, stale baseline
entries), 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PKG = os.path.join(_REPO, "mpi_grid_redistribute_tpu_torch")

BASELINE_DOC = [
    "racecheck baseline: justified static over-approximations. The",
    "analyzer is object-insensitive (a class's fields are merged across",
    "instances) and flow-insensitive (it cannot see run-time flags), so",
    "each entry describes an instance or flag configuration that cannot",
    "occur, and its justification names the confinement argument.",
    "Matching is line-insensitive (rule, path, symbol, message). Remove",
    "entries as the code makes them stale (--check reports that); never",
    "add one to silence a new finding: fix it, or suppress it inline with",
    "a racecheck disable marker and a comment saying why.",
]
UNJUSTIFIED = ("UNJUSTIFIED: say why this finding cannot occur at run "
               "time, or fix the code")


def _parser() -> argparse.ArgumentParser:
    from mpi_grid_redistribute_tpu_torch.analysis.baseline import (
        racecheck_baseline_path,
    )

    p = argparse.ArgumentParser(
        prog="mpi_grid_redistribute_tpu_torch.tools.racecheck",
        description="AST-based host-thread shared-state analyzer for the "
        "port's service control plane (rules T001-T005).")
    p.add_argument("paths", nargs="*", default=[_PKG],
                   help="files or directories to scan (default: the port's "
                   "package, tools/ included)")
    p.add_argument("--format", choices=("text", "json", "sarif", "github"),
                   default="text", help="output format")
    p.add_argument("--rules", default=None, metavar="T00x[,T00y]",
                   help="comma-separated subset of rules to run")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="baseline file (default: "
                   f"{os.path.relpath(racecheck_baseline_path(), _REPO)})")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline; report every finding")
    p.add_argument("--write-baseline", action="store_true",
                   help="write the current findings to the baseline, "
                   "keeping matched justifications, and exit 0")
    p.add_argument("--check", action="store_true",
                   help="CI mode: also fail on stale baseline entries")
    p.add_argument("--check-baseline", action="store_true",
                   help="report stale baseline entries only")
    p.add_argument("--root", default=_REPO,
                   help="path-relativization root (default: the repo)")
    p.add_argument("--list-rules", action="store_true",
                   help="list rules and exit")
    p.add_argument("--list-threads", action="store_true",
                   help="dump the inferred thread topology and exit")
    return p


def _print_threads(model) -> None:
    from mpi_grid_redistribute_tpu_torch.analysis.racecheck import lock_str

    print("thread roots:")
    if not model.root_by_label:
        print("  (none: single-threaded project)")
    for label in sorted(model.root_by_label):
        r = model.root_by_label[label]
        flags = [f"daemon={r.daemon}", f"joined={r.joined}"]
        if r.multi:
            flags.append("multi")
        if r.marked_writer:
            flags.append("recorder-writer")
        n = len(model.reach.get(label, ()))
        print(f"  {label}  [{', '.join(flags)}]  reaches {n} function(s)")
    shared = []
    for (owner, field), accs in sorted(model.shared_entries().items()):
        live = [a for a in accs if not a.init]
        if not live:
            continue
        labels = set()
        for a in live:
            labels |= model.roots_of(a.fnkey)
        if len(labels) < 2:
            continue
        locks = None
        for a in live:
            locks = a.locks if locks is None else (locks & a.locks)
        guard = ("/".join(sorted(lock_str(lk) for lk in locks))
                 if locks else "UNGUARDED")
        shared.append((live[0].symbol, sorted(labels), guard))
    print("cross-thread fields:")
    if not shared:
        print("  (none)")
    for sym, labels, guard in shared:
        print(f"  {sym}  threads={{{', '.join(labels)}}}  guard={guard}")


def write_justified_baseline(path: str, findings) -> None:
    """The baseline of ``findings``, one entry a baseline key, each
    keeping the justification its matching entry had (new entries:
    :data:`UNJUSTIFIED`)."""
    old = {}
    if os.path.exists(path):
        with open(path, encoding="utf-8") as fh:
            for e in json.load(fh).get("findings", []):
                old[(e["rule"], e["path"], e["symbol"], e["message"])] = (
                    e.get("justification", UNJUSTIFIED))
    keys = sorted({f.baseline_key() for f in findings},
                  key=lambda k: (k[1], k[0], k[2], k[3]))
    entries = [
        {"rule": r, "path": p, "symbol": sym, "message": msg,
         "justification": old.get((r, p, sym, msg), UNJUSTIFIED)}
        for r, p, sym, msg in keys
    ]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"_doc": BASELINE_DOC, "findings": entries}, fh, indent=1)
        fh.write("\n")


def main(argv: Optional[Sequence[str]] = None) -> int:
    from mpi_grid_redistribute_tpu_torch.analysis import racecheck, sarif
    from mpi_grid_redistribute_tpu_torch.analysis.baseline import (
        load_baseline,
        racecheck_baseline_path,
        split_baselined,
    )

    args = _parser().parse_args(argv)
    if args.list_rules:
        for rid in racecheck.T_RULE_IDS:
            print(f"{rid}  {racecheck.T_RULE_DOCS[rid]}")
        return 0
    rules: Optional[List[str]] = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in racecheck.T_RULE_IDS]
        if unknown:
            print(f"racecheck: unknown rule(s): {', '.join(unknown)} "
                  f"(known: {', '.join(racecheck.T_RULE_IDS)})",
                  file=sys.stderr)
            return 2
    try:
        model = racecheck.build_model(args.paths, root=args.root)
        if args.list_threads:
            _print_threads(model)
            return 0
        findings = racecheck.run_racecheck(args.paths, root=args.root,
                                           rules=rules, model=model)
    except SystemExit as e:  # a file that does not parse
        print(f"racecheck: {e}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or racecheck_baseline_path()
    if args.write_baseline:
        write_justified_baseline(baseline_path, findings)
        print(f"racecheck: wrote {len(findings)} finding(s) to "
              f"{baseline_path}")
        return 0

    baseline = set() if args.no_baseline else load_baseline(baseline_path)
    new, grandfathered = split_baselined(findings, baseline)
    stale: List[tuple] = []
    if (args.check or args.check_baseline) and baseline:
        stale = sorted(baseline - {f.baseline_key() for f in grandfathered})
    stale_lines = [f"stale baseline entry (code fixed? remove it): "
                   f"{k[0]} {k[1]} [{k[2]}]" for k in stale]
    if args.check_baseline:
        for line in stale_lines:
            print(line)
        print(f"racecheck: {len(stale)} stale baseline entr(y/ies) of "
              f"{len(baseline)}")
        return 1 if stale else 0

    if args.format == "json":
        print(json.dumps({"findings": [f.to_dict() for f in new],
                          "baselined": len(grandfathered),
                          "stale_baseline": [list(k) for k in stale]},
                         indent=2))
    elif args.format == "sarif":
        print(json.dumps(sarif.to_sarif(new, "racecheck",
                                        racecheck.T_RULE_DOCS), indent=2))
    elif args.format == "github":
        for line in sarif.github_annotations(new):
            print(line)
    else:
        for f in new:
            print(f.render())
        summary = f"racecheck: {len(new)} finding(s)"
        if grandfathered:
            summary += f", {len(grandfathered)} baselined"
        if stale:
            summary += f", {len(stale)} stale baseline entr(y/ies)"
        print(summary)
    for line in stale_lines:
        print(line, file=sys.stderr if args.format != "text" else sys.stdout)
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
