"""gridlint's command line (the port's counterpart of the JAX package's
``analysis/cli.py``), run as ``python -m
mpi_grid_redistribute_tpu_torch.tools.gridlint [PATH ...]``.

Exit codes: 0 clean (or everything baselined); 1 findings not in the
baseline; 2 a usage error or a file that does not parse. ``--check`` is
the CI entry point: it also fails on a stale baseline entry (one that
matches nothing, so the baseline can only shrink) and on an entry with
no justification. ``--write-baseline`` rewrites the entries and keeps
the justification of every entry that still matches (a new one is
written unjustified, to be justified by hand or fixed).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

from mpi_grid_redistribute_tpu_torch.analysis.core import (
    NOT_APPLICABLE,
    RULE_IDS,
    run_gridlint,
)

_HERE = os.path.dirname(os.path.abspath(__file__))
UNJUSTIFIED = ""

RULE_DOCS = {
    "G001": "not applicable: shard_map collective order and axis-name "
    "literals (the port has no shard_map; progcheck's J001 checks every "
    "rank's collective sequence on recorded runs)",
    "G002": "no host reads (.item/.tolist/.cpu/.numpy, int()/float()/"
    "bool() of a tensor, telemetry.phases.host_read, "
    "torch.cuda.synchronize) on the step path",
    "G003": "no data-dependent shapes (nonzero/unique/masked_select, "
    "one-argument torch.where, boolean-mask indexing) on the step path",
    "G004": "fuse_fields/_fuse_planar and .view to a 32-bit dtype on "
    "caller data must carry an itemsize/element_size() guard (the planar "
    "32-bit row contract)",
    "G005": "not applicable: pallas_call grids and BlockSpecs (the port's "
    "kernels are CUDA; kernelcheck's K000-K003 and K005 check them on the "
    "card)",
    "G006": "no sorts or arange-indexed gathers inside "
    "fastpath-engine-marked functions (mover-sparse cost contract)",
    "G007": "no torch imports or device syncs in scrape-path-marked "
    "modules (the metrics plane is host-only)",
    "G008": "no bare `except:` or swallowed exceptions in "
    "service-path-marked modules (the supervisor must see every fault)",
    "G009": "no host syncs (np.asarray, .item/.tolist/.cpu/.numpy, "
    "torch.cuda.synchronize, float()/int()/bool() of non-literals) inside "
    "resident-path-marked functions (the chunk interior stays on the "
    "device)",
    "G010": "fastpath-engine/resident-path-marked functions must hold at "
    "least one traced_span (profiler, knockout and progcheck attribution)",
}

BASELINE_DOC = [
    "gridlint baseline: findings accepted at the linter's introduction in "
    "the port. Matching is line-insensitive (rule, path, symbol, message).",
    "Every entry carries its justification; never add an entry to dodge a "
    "new finding: fix it, or suppress it inline with a reason.",
]


def default_baseline_path() -> str:
    return os.path.join(_HERE, "gridlint_baseline.json")


def load_entries(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as fh:
        return list(json.load(fh).get("findings", []))


def write_justified_baseline(path: str, findings) -> None:
    """The baseline of ``findings``, each entry keeping the justification
    its matching entry had (new entries: unjustified)."""
    old = {(e["rule"], e["path"], e["symbol"], e["message"]):
           e.get("justification", UNJUSTIFIED) for e in load_entries(path)}
    keys = sorted({f.baseline_key() for f in findings},
                  key=lambda k: (k[1], k[0], k[2], k[3]))
    entries = [{"rule": r, "path": p, "symbol": sym, "message": msg,
                "justification": old.get((r, p, sym, msg), UNJUSTIFIED)}
               for r, p, sym, msg in keys]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"_doc": BASELINE_DOC, "findings": entries}, fh, indent=1)
        fh.write("\n")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_grid_redistribute_tpu_torch.tools.gridlint",
        description="AST invariant checker of the port: host reads on "
        "the step path, the planar row contract, the fast-path, scrape, "
        "service and resident contracts and span coverage.")
    p.add_argument("paths", nargs="*",
                   default=["mpi_grid_redistribute_tpu_torch/"],
                   help="files or directories to scan (default: the port)")
    p.add_argument("--format", choices=("text", "json", "sarif", "github"),
                   default="text", help="output format")
    p.add_argument("--rules", default=None, metavar="G00x[,G00y]",
                   help="comma-separated subset of rules to run")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help=f"baseline file (default: {default_baseline_path()})")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline; report every finding")
    p.add_argument("--write-baseline", action="store_true",
                   help="write the findings to the baseline (keeping "
                   "matched justifications) and exit 0")
    p.add_argument("--check", action="store_true",
                   help="CI mode: also fail on stale or unjustified "
                   "baseline entries")
    p.add_argument("--check-baseline", action="store_true",
                   help="baseline hygiene only: report stale entries")
    p.add_argument("--root", default=None,
                   help="path-relativization root (default: cwd)")
    p.add_argument("--list-rules", action="store_true",
                   help="list rules and exit")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    from mpi_grid_redistribute_tpu_torch.analysis import sarif
    from mpi_grid_redistribute_tpu_torch.analysis.baseline import (
        split_baselined,
    )

    args = _parser().parse_args(argv)
    if args.list_rules:
        for rid in RULE_IDS:
            print(f"{rid}  {RULE_DOCS[rid]}")
        return 0
    rules: Optional[List[str]] = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in RULE_IDS]
        if unknown:
            print(f"gridlint: unknown rule(s): {', '.join(unknown)} "
                  f"(known: {', '.join(RULE_IDS)})", file=sys.stderr)
            return 2
    try:
        findings = run_gridlint(args.paths, root=args.root, rules=rules)
    except SystemExit as e:  # a file that does not parse
        print(f"gridlint: {e}", file=sys.stderr)
        return 2

    path = args.baseline or default_baseline_path()
    if args.write_baseline:
        write_justified_baseline(path, findings)
        print(f"gridlint: wrote {len(findings)} finding(s) to {path}")
        return 0
    entries = [] if args.no_baseline else load_entries(path)
    baseline = {(e["rule"], e["path"], e["symbol"], e["message"])
                for e in entries}
    new, grandfathered = split_baselined(findings, baseline)
    problems: List[str] = []
    if (args.check or args.check_baseline) and baseline:
        matched = {f.baseline_key() for f in grandfathered}
        problems += [f"stale baseline entry (code fixed? remove it): "
                     f"{k[0]} {k[1]} [{k[2]}]"
                     for k in sorted(baseline - matched)]
    if args.check:
        problems += [f"baseline entry without a justification: "
                     f"{e['rule']} {e['path']} [{e['symbol']}]"
                     for e in entries if not e.get("justification")]
    if args.check_baseline:
        for line in problems:
            print(line)
        print(f"gridlint: {len(problems)} stale baseline entr(y/ies) of "
              f"{len(baseline)}")
        return 1 if problems else 0

    if args.format == "json":
        print(json.dumps({"findings": [f.to_dict() for f in new],
                          "baselined": len(grandfathered),
                          "baseline_problems": problems}, indent=2))
    elif args.format == "sarif":
        print(json.dumps(sarif.to_sarif(new, "gridlint", RULE_DOCS),
                         indent=2))
    elif args.format == "github":
        for line in sarif.github_annotations(new):
            print(line)
    else:
        for rid in NOT_APPLICABLE:
            print(f"{rid}: {RULE_DOCS[rid]}")
        for f in new:
            print(f.render())
        summary = f"gridlint: {len(new)} finding(s)"
        if grandfathered:
            summary += f", {len(grandfathered)} baselined"
        if problems:
            summary += f", {len(problems)} baseline problem(s)"
        print(summary)
    for line in problems:
        print(line, file=sys.stderr if args.format != "text" else sys.stdout)
    return 1 if (new or problems) else 0


if __name__ == "__main__":
    sys.exit(main())
