"""The kernelcheck CLI (the twin of the JAX package's
``scripts/kernelcheck.py``): run the K rules of
``analysis/kernelcheck.py`` over the six registered cases on the card.

    python -m mpi_grid_redistribute_tpu_torch.tools.kernelcheck --check
    python -m mpi_grid_redistribute_tpu_torch.tools.kernelcheck \\
        [--format=text|json|sarif|github] [--rules K001,K005] \\
        [--kernels NAME[,NAME]]
    python -m mpi_grid_redistribute_tpu_torch.tools.kernelcheck \\
        --update-baseline            # write K003's table, on the card
    python -m mpi_grid_redistribute_tpu_torch.tools.kernelcheck \\
        --check-baseline             # stale entries, runs nothing
    python -m mpi_grid_redistribute_tpu_torch.tools.kernelcheck --sanitize
    python -m mpi_grid_redistribute_tpu_torch.tools.kernelcheck \\
        --device cpu                 # the plain routes, no K003

Exit codes: 0 clean, 1 findings or baseline drift, 2 usage error (and
``--sanitize`` without a working ``compute-sanitizer``).

``--sanitize`` re-runs each case in a child process under
``compute-sanitizer --tool memcheck`` (reads and writes out of bounds,
reported as K001) and then ``--tool racecheck`` (shared-memory hazards,
reported as K002). A sanitizer that is missing or does not start is
never a pass: the command says so and exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from typing import List, Optional, Sequence

EXIT_USAGE = 2

_SUMMARY = {
    "memcheck": re.compile(r"ERROR SUMMARY:\s*(\d+)\s+error"),
    "racecheck": re.compile(
        r"RACECHECK SUMMARY:\s*(\d+)\s+hazard|ERROR SUMMARY:\s*(\d+)\s+error"),
}
SANITIZER_RULE = {"memcheck": "K001", "racecheck": "K002"}


def _parser() -> argparse.ArgumentParser:
    from mpi_grid_redistribute_tpu_torch.analysis.baseline import (
        kernelcheck_baseline_path,
    )

    p = argparse.ArgumentParser(
        prog="mpi_grid_redistribute_tpu_torch.tools.kernelcheck",
        description="Check the port's CUDA kernels at the reference's "
        "registered shapes: rules K000-K005 (K004 not applicable).")
    p.add_argument("--format", choices=("text", "json", "sarif", "github"),
                   default="text", help="output format")
    p.add_argument("--rules", default=None, metavar="K00x[,K00y]",
                   help="comma-separated subset of rules to run")
    p.add_argument("--kernels", default=None, metavar="NAME[,NAME]",
                   help="comma-separated subset of registered cases")
    p.add_argument("--device", default=None,
                   help="default: the GPU; 'cpu' checks the plain routes")
    p.add_argument("--baseline", default=None, metavar="PATH",
                   help="K003 footprint baseline (default: "
                   f"{os.path.relpath(kernelcheck_baseline_path())})")
    p.add_argument("--check", action="store_true",
                   help="CI mode: also fail on baseline entries for "
                   "unregistered cases")
    p.add_argument("--update-baseline", action="store_true",
                   help="write this run's K003 footprints and nvcc version "
                   "to the baseline and exit 0 (on the card)")
    p.add_argument("--check-baseline", action="store_true",
                   help="flag baseline entries whose case is no longer "
                   "registered, without running anything")
    p.add_argument("--sanitize", action="store_true",
                   help="run every case under compute-sanitizer memcheck "
                   "and racecheck (on the card)")
    p.add_argument("--sanitize-log", default=None, metavar="DIR",
                   help="with --sanitize: keep each child's output in DIR")
    p.add_argument("--list-rules", action="store_true",
                   help="list the rules and exit")
    p.add_argument("--list-kernels", action="store_true",
                   help="list the registered cases and exit")
    return p


def _sanitizer() -> Optional[str]:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "compute-sanitizer"),
        shutil.which("compute-sanitizer"),
    ):
        if cand and os.path.exists(cand):
            return cand
    return None


# the sanitizer's own failure (as "Device not supported"), as against an
# error it found in the program
_TOOL_ERROR = re.compile(r"^=========\s+Error:\s*(.*\S)", re.M)


def sanitizer_failure(text: str) -> Optional[str]:
    """The sanitizer's own first error line, when it could not check the
    program (its summary then counts that failure, not the program's)."""
    m = _TOOL_ERROR.search(text)
    return None if m is None else m.group(1)


def parse_sanitizer(tool: str, text: str) -> Optional[int]:
    """The error or hazard count of a sanitizer run's summary line, or
    ``None`` when the tool did not check the program: no summary, or an
    error of the sanitizer's own (:func:`sanitizer_failure`)."""
    m = _SUMMARY[tool].search(text)
    if m is None or sanitizer_failure(text) is not None:
        return None
    return int(next(g for g in m.groups() if g is not None))


# a sanitizer report's backtrace and address lines
_FRAME_LINES = ("at ", "by ", "Host Frame", "Saved host backtrace", "in ",
                "Address ")


def _first_errors(text: str, k: int = 2) -> str:
    """The first ``k`` distinct error lines a sanitizer printed."""
    seen = []
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("=========") or "SUMMARY" in line:
            continue
        msg = line.strip("= ").strip()
        if (msg and msg != "COMPUTE-SANITIZER" and msg not in seen
                and not msg.startswith(_FRAME_LINES)):
            seen.append(msg)
        if len(seen) == k:
            break
    return "; ".join(seen)


def sanitize(names: Sequence[str], timeout: float = 900.0,
             log_dir: Optional[str] = None):
    """Each case in a child under each sanitizer tool. Returns
    ``(findings, table, failure)``: ``table[case][tool]`` the count,
    ``failure`` a message when the sanitizer is missing or did not run
    (then the caller exits 2). ``log_dir`` keeps each child's whole
    output as ``<case>.<tool>.txt``."""
    from mpi_grid_redistribute_tpu_torch.analysis.kernelcheck import (
        KernelFinding,
    )
    from mpi_grid_redistribute_tpu_torch.ops import _build

    cs = _sanitizer()
    if cs is None:
        return [], {}, ("compute-sanitizer not found (looked in "
                        "$CUDA_HOME/bin, /usr/local/cuda/bin and PATH)")
    _build.build_all()  # once here, so the children only load
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    findings, table = [], {}
    for name in names:
        table[name] = {}
        for tool in ("memcheck", "racecheck"):
            cmd = [cs, "--tool", tool, "--print-limit", "20",
                   sys.executable, "-m",
                   "mpi_grid_redistribute_tpu_torch.tools.kernelcheck",
                   "--kernels", name, "--rules", "K000,K005"]
            try:
                p = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=timeout)
            except subprocess.TimeoutExpired:
                return findings, table, (
                    f"compute-sanitizer --tool {tool} on {name} did not end "
                    f"within {timeout:.0f} s")
            text = p.stdout + p.stderr
            if log_dir:
                with open(os.path.join(log_dir, f"{name}.{tool}.txt"), "w",
                          encoding="utf-8") as fh:
                    fh.write(text)
            n = parse_sanitizer(tool, text)
            if n is None:
                why = sanitizer_failure(text) or (
                    "no summary line:\n"
                    + "\n".join(text.strip().splitlines()[-8:]))
                return findings, table, (
                    f"compute-sanitizer --tool {tool} did not check {name} "
                    f"(exit {p.returncode}): {why}")
            table[name][tool] = n
            if n:
                findings.append(KernelFinding(
                    SANITIZER_RULE[tool], name,
                    f"compute-sanitizer --tool {tool} reports {n} "
                    f"error(s): {_first_errors(text)}"))
            if p.returncode != 0:
                last = [ln for ln in text.strip().splitlines()
                        if not ln.startswith("=========")][-1:]
                findings.append(KernelFinding(
                    "K005", name, f"the case failed under compute-sanitizer "
                    f"--tool {tool} (exit {p.returncode}): "
                    f"{' '.join(last)}"))
    return findings, table, None


def _emit(findings, fmt, kernels, footprints, n_suppressed, extra=None):
    from mpi_grid_redistribute_tpu_torch.analysis import rules_kernel, sarif

    if fmt == "json":
        doc = {"findings": [f.to_dict() for f in findings],
               "suppressed": n_suppressed, "kernels": sorted(kernels),
               "footprints": footprints}
        doc.update(extra or {})
        print(json.dumps(doc, indent=2, sort_keys=True))
    elif fmt == "sarif":
        print(json.dumps(sarif.to_sarif(findings, "kernelcheck",
                                        rules_kernel.RULE_DOCS), indent=2))
    elif fmt == "github":
        for line in sarif.github_annotations(findings):
            print(line)
    else:
        for f in findings:
            print(f.render())
        summary = (f"kernelcheck: {len(findings)} finding(s) over "
                   f"{len(kernels)} case(s)")
        if n_suppressed:
            summary += f", {n_suppressed} suppressed"
        print(summary)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from mpi_grid_redistribute_tpu_torch import _device
    from mpi_grid_redistribute_tpu_torch.analysis import kernelcheck as kc
    from mpi_grid_redistribute_tpu_torch.analysis import rules_kernel
    from mpi_grid_redistribute_tpu_torch.analysis.baseline import (
        kernelcheck_baseline_path,
        load_kernelcheck_baseline,
        write_kernelcheck_baseline,
    )

    args = _parser().parse_args(argv)
    if args.list_rules:
        for rid in kc.K_RULE_IDS:
            print(f"{rid}  {rules_kernel.RULE_DOCS[rid]}")
        return 0

    rules: Optional[List[str]] = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in kc.RUN_RULES]
        if unknown:
            print(f"kernelcheck: unknown or not applicable rule(s): "
                  f"{', '.join(unknown)} (runnable: "
                  f"{', '.join(kc.RUN_RULES)})", file=sys.stderr)
            return EXIT_USAGE

    kernels = kc.default_kernels()
    if args.list_kernels:
        for name in sorted(kernels):
            spec = kernels[name]
            tag = " [scatter]" if spec.scatter else ""
            print(f"{name}{tag}  {spec.description}\n    {spec.op} against "
                  f"{spec.plain_op}")
        return 0

    base_path = args.baseline or kernelcheck_baseline_path()
    if args.check_baseline:
        baseline = load_kernelcheck_baseline(base_path)
        if baseline is None:
            print(f"kernelcheck: no footprint baseline at {base_path} — run "
                  "tools.kernelcheck --update-baseline on the card")
            return 1
        stale = sorted(set(baseline["footprints"]) - set(kernels))
        for name in stale:
            print(f"stale footprint baseline entry (case unregistered? "
                  f"remove it with --update-baseline): {name}")
        return 1 if stale else 0

    if args.kernels:
        wanted = [k.strip() for k in args.kernels.split(",") if k.strip()]
        unknown = [k for k in wanted if k not in kernels]
        if unknown:
            print(f"kernelcheck: unknown case(s): {', '.join(unknown)} "
                  f"(known: {', '.join(sorted(kernels))})", file=sys.stderr)
            return EXIT_USAGE
        kernels = {n: kernels[n] for n in wanted}

    try:
        dev = _device.resolve(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"kernelcheck: {e}", file=sys.stderr)
        return EXIT_USAGE
    if (args.update_baseline or args.sanitize) and dev.type != "cuda":
        print("kernelcheck: --update-baseline and --sanitize run on the "
              "card", file=sys.stderr)
        return EXIT_USAGE

    if args.sanitize:
        findings, table, failure = sanitize(sorted(kernels),
                                            log_dir=args.sanitize_log)
        for name in sorted(table):
            cells = ", ".join(f"{t} {n}" for t, n in table[name].items())
            print(f"sanitize {name}: {cells}", file=sys.stderr)
        if failure is not None:
            print(f"kernelcheck --sanitize: {failure}", file=sys.stderr)
            return EXIT_USAGE
        findings, n_suppressed = kc.apply_suppressions(findings)
        _emit(findings, args.format, kernels, {}, n_suppressed,
              {"sanitize": table})
        return 1 if findings else 0

    findings, footprints, n_suppressed = kc.run_kernelcheck(
        kernels, rules=rules, device=dev, partial=args.kernels is not None)

    if args.update_baseline:
        from mpi_grid_redistribute_tpu_torch.ops import _build
        from mpi_grid_redistribute_tpu_torch.telemetry import regress

        write_kernelcheck_baseline(base_path, footprints,
                                   _build.nvcc_version(),
                                   regress._smi_name_power_limit())
        print(f"kernelcheck: wrote {len(footprints)} footprint(s) to "
              f"{base_path}")
        for f in findings:
            print(f.render())
        return 0

    if footprints:  # K003 ran (on the card): the exact gate
        from mpi_grid_redistribute_tpu_torch.ops import _build

        findings += rules_kernel.compare_footprints(
            footprints, load_kernelcheck_baseline(base_path),
            _build.nvcc_version(), check_stale=args.check,
            partial=args.kernels is not None)
        findings.sort(key=lambda f: (f.rule, f.kernel, f.message))
    elif dev.type != "cuda" and args.format == "text":
        print("kernelcheck: on the CPU the ops take their plain routes; "
              "K000's launch counts and K003 need the card and were not run")
    _emit(findings, args.format, kernels, footprints, n_suppressed)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
