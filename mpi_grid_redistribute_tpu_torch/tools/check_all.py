"""The umbrella gate: every analyzer of the port, one SARIF file (the
twin of the JAX package's ``scripts/check_all.py``).

    python -m mpi_grid_redistribute_tpu_torch.tools.check_all \\
        [--sarif-out PATH] [--analyzers A,B] [--device cpu]
    python -m mpi_grid_redistribute_tpu_torch.tools.check_all --lint

:data:`ANALYZERS` is the one list of the port's eight tools. Each runs
in its own process with ``--check`` (and ``--format=sarif`` unless
``--lint``), all of them at once: the two registry checkers start a
world of ranks each and the rest are quick, so the gate takes about as
long as its slowest row. In the default mode their SARIF runs are merged
into one document with ``analysis/sarif.py``'s ``merge_sarif``;
``--lint`` prints each tool's status and the last two lines of its text
(the whole text when it fails) instead. progcheck and shardcheck judge
one recording of the program registry: the first to start records it
into a temporary file (``progcheck.RECORDS_CACHE_ENV``), the other waits
for it and reads it. ``--device`` goes to the
tools that run programs; a tool that needs the card (kernelcheck builds
its kernels with ``nvcc``) does not run on ``cpu``: it is named as
"needs the card", never counted as clean, and the exit code says so.
Each row's seconds are printed.

Exit codes: 0 every tool ran and is clean; 1 a tool found something; 2
a usage or parse error; 3 every tool that ran is clean, but a tool that
needs the card did not run.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
EXIT_NEEDS_CARD = 3
# progcheck.RECORDS_CACHE_ENV (not imported: this module stays light)
RECORDS_CACHE_ENV = "MPI_GRID_PROGCHECK_RECORDS"

# name, module run with -m, its arguments, the committed baseline it
# gates against, whether it takes --device, whether it needs the card
Analyzer = collections.namedtuple(
    "Analyzer", ["name", "module", "args", "baseline", "device", "card"])

_PKG = "mpi_grid_redistribute_tpu_torch"
ANALYZERS = (
    Analyzer("gridlint", f"{_PKG}.tools.gridlint", [f"{_PKG}/", "--check"],
             f"{_PKG}/analysis/gridlint_baseline.json", False, False),
    Analyzer("progcheck", f"{_PKG}.analysis.progcheck", ["--check"],
             f"{_PKG}/analysis/progprofile_baseline.json", True, False),
    Analyzer("shardcheck", f"{_PKG}.tools.shardcheck", ["--check"],
             f"{_PKG}/analysis/progprofile_baseline.json", True, False),
    Analyzer("attribution", f"{_PKG}.tools.attribution", ["--check"],
             f"{_PKG}/telemetry/attribution_baseline.json", False, False),
    Analyzer("racecheck", f"{_PKG}.tools.racecheck", ["--check"],
             f"{_PKG}/analysis/racecheck_baseline.json", False, False),
    Analyzer("kernelcheck", f"{_PKG}.tools.kernelcheck", ["--check"],
             f"{_PKG}/analysis/kernelcheck_baseline.json", True, True),
    Analyzer("incident-demo", f"{_PKG}.tools.incident_demo", ["--check"],
             f"{_PKG}/analysis/incident_demo_baseline.json", True, False),
    Analyzer("storecheck", f"{_PKG}.tools.storecheck", ["--check"],
             f"{_PKG}/analysis/storecheck_baseline.json", False, False),
)


def _select(spec):
    if not spec:
        return list(ANALYZERS)
    by_name = {a.name: a for a in ANALYZERS}
    wanted = [s.strip() for s in spec.split(",") if s.strip()]
    unknown = [w for w in wanted if w not in by_name]
    if unknown:
        print(f"check: unknown analyzer(s): {', '.join(unknown)} "
              f"(known: {', '.join(by_name)})", file=sys.stderr)
        return None
    return [by_name[w] for w in wanted]


def _on_card(device: Optional[str]) -> bool:
    if device is not None:
        return not str(device).startswith("cpu")
    import torch

    return torch.cuda.is_available()


def command(tool: Analyzer, lint: bool, device: Optional[str]) -> List[str]:
    cmd = [sys.executable, "-m", tool.module] + list(tool.args)
    if tool.device and device is not None:
        cmd += ["--device", device]
    if not lint:
        cmd.append("--format=sarif")
    return cmd


def main(argv: Optional[Sequence[str]] = None) -> int:
    from mpi_grid_redistribute_tpu_torch.analysis.sarif import merge_sarif

    p = argparse.ArgumentParser(
        prog=f"{_PKG}.tools.check_all",
        description="Run every analyzer of the port and merge their SARIF "
        "runs into one file.")
    p.add_argument("--sarif-out",
                   default=os.path.join(REPO, "analysis_merged.sarif"),
                   metavar="PATH", help="merged SARIF output path (default: "
                   "analysis_merged.sarif at the repo root)")
    p.add_argument("--analyzers", default=None, metavar="NAME[,NAME]",
                   help="comma-separated subset of the registry; default: "
                   f"all ({', '.join(a.name for a in ANALYZERS)})")
    p.add_argument("--lint", action="store_true",
                   help="plain-text mode: each analyzer's --check output, "
                   "no SARIF capture or merging")
    p.add_argument("--device", default=None,
                   help="where the tools run their programs (default: the "
                   "GPU); 'cpu' skips the tools that need the card")
    args = p.parse_args(argv)
    selected = _select(args.analyzers)
    if selected is None:
        return 2
    card = _on_card(args.device)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep)
                  if x])
    # progcheck and shardcheck judge one recording of the registry (the
    # first of them to start records it, the other waits and reads it)
    records = tempfile.TemporaryDirectory(prefix="check_all_")
    env.setdefault(RECORDS_CACHE_ENV,
                   os.path.join(records.name, "registry.pkl"))

    def run(tool):
        t0 = time.monotonic()
        proc = subprocess.run(command(tool, args.lint, args.device),
                              cwd=REPO, env=env, capture_output=True,
                              text=True)
        return proc, time.monotonic() - t0

    runnable = [t for t in selected if card or not t.card]
    with records, concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, len(runnable))) as pool:
        futures = {t.name: pool.submit(run, t) for t in runnable}
        done = {name: f.result() for name, f in futures.items()}
    docs, worst, skipped = [], 0, []
    for tool in selected:
        if tool.name not in done:
            skipped.append(tool.name)
            print(f"check: {tool.name} needs the card: not run (not clean)")
            continue
        proc, dt = done[tool.name]
        out, err = proc.stdout, proc.stderr
        if proc.returncode == 2:
            print(f"check: {tool.name} usage/parse error:", file=sys.stderr)
            sys.stderr.write(err)
            worst = max(worst, 2)
            continue
        status = "clean" if proc.returncode == 0 else "FAILED"
        if args.lint:
            print(f"check: {tool.name} {status} (exit {proc.returncode}, "
                  f"{dt:.1f}s)")
            if proc.returncode != 0 and out.strip():
                sys.stdout.write(out)
            else:  # the tool's own summary lines
                for line in out.strip().splitlines()[-2:]:
                    print(f"  | {line}")
        else:
            try:
                doc = json.loads(out)
            except ValueError:
                print(f"check: {tool.name} produced no parseable SARIF "
                      f"(exit {proc.returncode}):", file=sys.stderr)
                sys.stderr.write(out + err)
                worst = max(worst, 2)
                continue
            docs.append(doc)
            n = sum(len(r.get("results", [])) for r in doc.get("runs", []))
            print(f"check: {tool.name} {status} ({n} finding(s), exit "
                  f"{proc.returncode}, {dt:.1f}s)")
        if proc.returncode != 0 and err.strip():
            sys.stderr.write(err)
        worst = max(worst, min(proc.returncode, 1))
    if not args.lint and worst < 2:
        merged = merge_sarif(docs)
        with open(args.sarif_out, "w", encoding="utf-8") as fh:
            json.dump(merged, fh, indent=2)
            fh.write("\n")
        print(f"check: merged {len(merged['runs'])} run(s) -> "
              f"{args.sarif_out}")
    if worst:
        return worst
    if skipped:
        print(f"check: not clean: {', '.join(skipped)} did not run "
              "(needs the card)")
        return EXIT_NEEDS_CARD
    return 0


if __name__ == "__main__":
    sys.exit(main())
