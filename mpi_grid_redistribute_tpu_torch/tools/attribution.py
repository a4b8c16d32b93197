"""Continuous attribution on the port: the knockout phase tables and the
counted rooflines, one CLI (the twin of the JAX package's
``scripts/attribution.py``).

The committed snapshot (``telemetry/attribution_baseline.json``) is the
single source: a measurement on the card writes it, the markdown tables
in ``PERF.md`` are RENDERED from it between ``<!-- attribution:* -->``
markers, and a structural gate keeps the two in step.

    python -m mpi_grid_redistribute_tpu_torch.tools.attribution
    python -m mpi_grid_redistribute_tpu_torch.tools.attribution \\
        --update-baseline            # re-measure on the card
    python -m mpi_grid_redistribute_tpu_torch.tools.attribution --render
    python -m mpi_grid_redistribute_tpu_torch.tools.attribution \\
        --check [--format=sarif|json|github]

* ``--update-baseline`` RE-MEASURES on the card (``--device``; default
  the GPU): the three knockouts (``bench/knockout_stages.py``, the
  migrate step, and ``bench/knockout_pipeline.py``, the pipelined step,
  at both committed shapes on grid (2, 2, 2); ``bench/knockout_deposit.
  py``, the scan deposit, at (4, 4, 4) and (2, 2, 2) x 2^20 rows), and
  the roofline report
  (``telemetry.roofline.roofline_report``: every registered program
  counted, the vrank and macro-step programs timed) at the registry's
  width (``roofline``) and at ``n_local`` 2^20 for the one-device
  programs (``roofline_wide``). The card's name and power limit are
  written beside them (``device``). A row whose ``achieved_fraction``
  exceeds ``roofline.ACHIEVED_FRACTION_MAX`` (1.05) means a count too
  high: the snapshot is not written and the command exits 1. With
  ``--engines deposit`` (any of the knockouts) only those tables are
  re-measured and merged into the snapshot, each with its card.
* ``--render`` regenerates the ``PERF.md`` tables from the snapshot:
  each cumulative reading with its spread (the range of its samples),
  and a negative delta larger than the two readings' spreads marked
  ``non-monotone`` (the cut step read slower than the longer one: no
  attribution).
* ``--check`` NEVER re-measures (timings depend on the card): A001 the
  snapshot exists, names its card, and its phase names match the live
  knockout definitions; A002 the rendered ``PERF.md`` tables match the
  snapshot byte for byte; A003 the roofline section covers every
  registered program and nothing else, and no measured row is above
  1.05. Exit 0 clean, 1 findings, 2 usage error. A checkout of the
  program files alone holds no ``PERF.md``: there A002 has no table to
  compare, says so on stderr, and A001 and A003 still gate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from mpi_grid_redistribute_tpu_torch.analysis.baseline import (
    attribution_baseline_path,
    load_attribution_baseline,
    write_attribution_baseline,
)
from mpi_grid_redistribute_tpu_torch.analysis.core import Finding, exit_code
from mpi_grid_redistribute_tpu_torch.analysis.sarif import (
    github_annotations,
    to_sarif,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PERF_MD = os.path.join(REPO, "PERF.md")
GRID = "2,2,2"
SHAPES = (4096, 65536)
WIDE_N_LOCAL = 2**20

STAGE_LABELS = {
    1: "1 drift + wrap + bin",
    2: "2 stable key sort + counts",
    3: "3 local allocation fixpoint",
    4: "4 vacated-slot plan",
    5: "5 arrival gather",
    6: "6 landing plan",
    7: "7 landing (overlay)",
    8: "8 free-stack update (**full step**)",
}

ENGINES = ("migrate", "pipeline", "deposit")
# the deposit knockout's shapes: (vrank grid, rows a vrank), the
# reference's default and config 5's
DEPOSIT_SHAPES = (("4,4,4", 2**20), ("2,2,2", 2**20))
ROOFLINE_SECTIONS = ("roofline", "roofline_wide")

RULE_DOCS = {
    "A001": "committed attribution snapshot must exist, name its card, "
    "and its phase names/counts must match the live knockout definitions",
    "A002": "PERF.md rendered phase and roofline tables must match the "
    "committed snapshot (run tools.attribution --render)",
    "A003": "the snapshot's roofline section must cover every "
    "registered program, no measured achieved_fraction above 1.05",
}

_BASELINE_REL = os.path.relpath(attribution_baseline_path(), REPO)


def _live_phases(engine):
    """The knockout's phase tokens, from its module, so this gate cannot
    drift from what the measurement cuts."""
    if engine == "migrate":
        from mpi_grid_redistribute_tpu_torch.bench import knockout_stages

        return list(knockout_stages.PHASES)
    if engine == "deposit":
        from mpi_grid_redistribute_tpu_torch.bench import knockout_deposit

        return list(knockout_deposit.PHASES)
    from mpi_grid_redistribute_tpu_torch.bench import knockout_pipeline

    return list(knockout_pipeline.PHASES)


# ---------------------------------------------------------------------
# measurement (--update-baseline)
# ---------------------------------------------------------------------


def _run_knockout(engine, n_local, device, grid_text=GRID):
    from mpi_grid_redistribute_tpu_torch.bench import (
        knockout_deposit,
        knockout_pipeline,
        knockout_stages,
    )

    grid = tuple(int(x) for x in grid_text.split(","))
    print(f"attribution: measuring {engine} @ n_local={n_local} (grid "
          f"{grid_text}) ...", file=sys.stderr, flush=True)
    if engine == "migrate":
        rows = knockout_stages.run(n_local, grid, device=device)
    elif engine == "deposit":
        rows = knockout_deposit.run(n_local, grid, device=device)
    else:
        rows = knockout_pipeline.run(n_local, grid, device=device)
    return [r._asdict() for r in rows]


def _measure_phase_tables(device, engines=ENGINES):
    tables = {}
    for engine in engines:
        if engine == "deposit":
            shapes = {f"{g}x{n}": {"grid": g, "n": n,
                                   "rows": _run_knockout(engine, n, device, g)}
                      for g, n in DEPOSIT_SHAPES}
            tables[engine] = {"grid": None, "phases": _live_phases(engine),
                              "shapes": shapes,
                              "device": _device_label(device)}
            continue
        shapes = {str(n): {"rows": _run_knockout(engine, n, device)}
                  for n in SHAPES}
        tables[engine] = {"grid": GRID, "phases": _live_phases(engine),
                          "shapes": shapes}
    return tables


def _measure_roofline(device, n_local=None, recorder=None):
    """Roofline rows of every registered program (``n_local`` None: the
    registry's width) or of the one-device programs at ``n_local``."""
    from mpi_grid_redistribute_tpu_torch.analysis import progcheck
    from mpi_grid_redistribute_tpu_torch.telemetry import roofline

    programs = progcheck.default_programs()
    if n_local is not None:
        programs = {k: v for k, v in programs.items()
                    if v.topology == "vranks"}
    print(f"attribution: counting and timing {len(programs)} programs "
          f"(n_local {n_local or 'registry'}) ...", file=sys.stderr,
          flush=True)
    costs = {}  # the one-device programs counted on the build they time
    measured = roofline.measure_programs(programs, device=device,
                                         n_local=n_local, costs=costs)
    sharded = {k: v for k, v in programs.items() if v.topology == "sharded"}
    if sharded:
        costs.update(progcheck.program_costs(sharded, device=device,
                                             n_local=n_local))
    report = roofline.roofline_report(programs, measured, recorder,
                                      costs=costs)
    n_disc = sum(1 for r in report.values() if r["discrepancy"])
    print(f"attribution: roofline over {len(report)} programs, {n_disc} "
          "discrepancy(ies) journaled", file=sys.stderr)
    return report


def _device_label(device):
    """``{"name", "power_limit", "torch", "cuda"}`` of the card measured
    on (``nvidia-smi``'s name and power limit); the CPU when asked."""
    import torch

    from mpi_grid_redistribute_tpu_torch import _device
    from mpi_grid_redistribute_tpu_torch.telemetry import regress

    dev = _device.resolve(device)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None,
                "torch": torch.__version__, "cuda": None}
    smi = regress._smi_name_power_limit() or ""
    name, _, limit = smi.partition(",")
    return {"name": name.strip() or torch.cuda.get_device_name(dev),
            "power_limit": limit.strip() or None,
            "torch": torch.__version__, "cuda": torch.version.cuda}


# ---------------------------------------------------------------------
# rendering (baseline -> PERF.md)
# ---------------------------------------------------------------------


def _shape_label(grid, n):
    v = 1
    for x in grid.split(","):
        v *= int(x)
    if n % 1024 == 0:
        return f"{v}×{n // 1024}k"
    return f"{v}×{n}"


def _fmt_ms(seconds, bold=False):
    s = f"{seconds * 1e3:.2f}"
    return f"**{s}**" if bold else s


def _fmt_spread(seconds):
    return "—" if seconds is None else f"{seconds * 1e3:.2f}"


def non_monotone(rows, i) -> bool:
    """Row ``i``'s delta is negative by more than the spreads of the two
    readings it is the difference of: no attribution."""
    if i == 0:
        return False
    a, b = rows[i - 1].get("spread_s"), rows[i].get("spread_s")
    if a is None or b is None:
        return False
    return -rows[i]["delta_s"] > a + b


def _fmt_delta(rows, i):
    if i == 0:
        return "(first)"
    ms = rows[i]["delta_s"] * 1e3
    text = f"+{ms:.2f}" if ms >= 0 else f"−{-ms:.2f}"
    return text + " non-monotone" if non_monotone(rows, i) else text


def _row_label(engine, phase, last):
    if engine == "migrate":
        return STAGE_LABELS.get(phase, str(phase))
    return f"{phase} (**full**)" if last else str(phase)


def _shapes(table):
    """``[(key, grid, n)]`` of a table's shapes, smallest first: a shape
    names its own grid (the deposit's) or takes the table's."""
    out = []
    for key, shape in table["shapes"].items():
        grid = shape.get("grid") or table["grid"]
        n = int(shape.get("n", key))
        v = 1
        for x in grid.split(","):
            v *= int(x)
        out.append((v * n, key, grid, n))
    return [(key, grid, n) for _, key, grid, n in sorted(out)]


def render_table(engine, table):
    """Deterministic markdown for one engine's committed phase table."""
    shapes = _shapes(table)
    header = "| phase (cumulative) |"
    rule = "|---|"
    for _, grid, n in shapes:
        header += f" {_shape_label(grid, n)} ms | ± | delta |"
        rule += "---|---|---|"
    lines = [header, rule]
    phases = table["phases"]
    for i, phase in enumerate(phases):
        last = i == len(phases) - 1
        cells = [_row_label(engine, phase, last)]
        for key, _, _ in shapes:
            rows = table["shapes"][key]["rows"]
            cells.append(_fmt_ms(rows[i]["cumulative_s"], bold=last))
            cells.append(_fmt_spread(rows[i].get("spread_s")))
            cells.append(_fmt_delta(rows, i))
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def _rendered(doc):
    """``{marker name: markdown}`` of every table the snapshot renders."""
    from mpi_grid_redistribute_tpu_torch.telemetry.roofline import (
        format_roofline_table,
    )

    out = {}
    tables = doc.get("phase_tables") or {}
    for engine in ENGINES:
        if engine in tables:
            out[engine] = render_table(engine, tables[engine])
    for section in ROOFLINE_SECTIONS:
        if doc.get(section):
            out[section] = format_roofline_table(doc[section])
    return out


def _marker(name, which):
    return f"<!-- attribution:{name}:{which} -->"


def _split_markers(text, name):
    """(before, inside, after) of the marker region, or None when the
    markers are absent or malformed."""
    begin, end = _marker(name, "begin"), _marker(name, "end")
    i = text.find(begin)
    j = text.find(end)
    if i < 0 or j < 0 or j <= i:
        return None
    i_end = i + len(begin)
    return text[:i_end], text[i_end:j], text[j:]


def render_markdown(doc, text):
    """``text`` with every marker region re-rendered from ``doc``; raises
    SystemExit on a missing section or markers."""
    rendered = _rendered(doc)
    for name in ENGINES + ROOFLINE_SECTIONS:
        if name not in rendered:
            raise SystemExit(
                f"attribution: snapshot has no {name!r} section — run "
                "--update-baseline first")
        parts = _split_markers(text, name)
        if parts is None:
            raise SystemExit(
                f"attribution: PERF.md is missing the "
                f"{_marker(name, 'begin')} / {_marker(name, 'end')} "
                "markers")
        before, _, after = parts
        text = before + "\n" + rendered[name] + "\n" + after
    return text


# ---------------------------------------------------------------------
# the structural gate (--check)
# ---------------------------------------------------------------------


def check_findings(doc=None, perf_md=PERF_MD):
    """Structural findings against the snapshot (default: the committed
    one). Never re-measures."""
    findings = []

    def fail(rule, path, msg):
        findings.append(Finding(rule, path, 1, 0, msg, "attribution"))

    if doc is None:
        doc = load_attribution_baseline()
    if doc is None:
        fail("A001", _BASELINE_REL,
             "no committed attribution snapshot — run python -m "
             "mpi_grid_redistribute_tpu_torch.tools.attribution "
             "--update-baseline on the card")
        return findings
    dev = doc.get("device") or {}
    if not dev.get("name") or dev.get("name") == "cpu":
        fail("A001", _BASELINE_REL,
             "the snapshot names no card it was measured on — "
             "re-measure with --update-baseline on the card")

    tables = doc.get("phase_tables") or {}
    for engine in ENGINES:
        table = tables.get(engine)
        if table is None:
            fail("A001", _BASELINE_REL,
                 f"snapshot has no phase_tables[{engine!r}] section — "
                 "run --update-baseline")
            continue
        live = _live_phases(engine)
        committed = table.get("phases")
        if committed != live:
            fail("A001", _BASELINE_REL,
                 f"phase_tables[{engine!r}].phases {committed!r} != the "
                 f"live knockout definition {live!r} — the step's phase "
                 "structure changed; run --update-baseline")
            continue
        for n, shape in sorted((table.get("shapes") or {}).items()):
            got = [r.get("phase") for r in shape.get("rows", [])]
            if got != live:
                fail("A001", _BASELINE_REL,
                     f"phase_tables[{engine!r}] shape {n}: measured row "
                     f"phases {got!r} != the live knockout definition "
                     f"{live!r} — run --update-baseline")

    from mpi_grid_redistribute_tpu_torch.analysis import progcheck

    programs = progcheck.default_programs()
    want = sorted(programs)
    have = sorted(doc.get("roofline") or {})
    for name in want:
        if name not in have:
            fail("A003", _BASELINE_REL,
                 f"registered program {name!r} missing from the roofline "
                 "section — run --update-baseline")
    for name in have:
        if name not in want:
            fail("A003", _BASELINE_REL,
                 f"roofline section names {name!r}, which is not a "
                 "registered program — run --update-baseline")
    wide_want = sorted(k for k, v in programs.items()
                       if v.topology == "vranks")
    wide_have = sorted(doc.get("roofline_wide") or {})
    if wide_have != wide_want:
        fail("A003", _BASELINE_REL,
             f"roofline_wide covers {wide_have}, not the one-device "
             f"programs {wide_want} — run --update-baseline")
    from mpi_grid_redistribute_tpu_torch.telemetry import roofline

    for section in ROOFLINE_SECTIONS:
        for name in roofline.over_roof(doc.get(section) or {}):
            fail("A003", _BASELINE_REL,
                 f"{section}[{name!r}] achieved_fraction "
                 f"{doc[section][name]['achieved_fraction']:.4f} > "
                 f"{roofline.ACHIEVED_FRACTION_MAX}: the count is too high "
                 "— fix it and run --update-baseline")

    if not findings and os.path.exists(perf_md):
        with open(perf_md, "r", encoding="utf-8") as fh:
            text = fh.read()
        rendered = _rendered(doc)
        for name in ENGINES + ROOFLINE_SECTIONS:
            parts = _split_markers(text, name)
            if parts is None:
                fail("A002", "PERF.md",
                     f"missing {_marker(name, 'begin')} markers for the "
                     "rendered table")
                continue
            if parts[1].strip("\n") != rendered[name]:
                fail("A002", "PERF.md",
                     f"the rendered {name} table is stale vs the "
                     "committed snapshot — run python -m "
                     "mpi_grid_redistribute_tpu_torch.tools.attribution "
                     "--render")
    return findings


# ---------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------


def _emit(findings, fmt):
    if fmt == "sarif":
        print(json.dumps(to_sarif(findings, "attribution", RULE_DOCS),
                         indent=2))
    elif fmt == "json":
        print(json.dumps([{"rule": f.rule, "path": f.path,
                           "message": f.message} for f in findings],
                         indent=2))
    elif fmt == "github":
        for line in github_annotations(findings):
            print(line)
    else:
        for f in findings:
            print(f"{f.path}: {f.rule} {f.message}")
        if not findings:
            print("attribution: clean")


def _flag_non_monotone(tables):
    for engine, table in tables.items():
        for n, shape in table["shapes"].items():
            flagged = [r["phase"] for i, r in enumerate(shape["rows"])
                       if non_monotone(shape["rows"], i)]
            if flagged:
                print(f"attribution: {engine} at {n}: non-monotone phases "
                      f"{flagged} (a negative delta beyond the readings' "
                      "spread)", file=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="mpi_grid_redistribute_tpu_torch.tools.attribution",
        description="knockout phase tables + counted rooflines: measure, "
        "render, and gate the committed attribution snapshot")
    p.add_argument("--update-baseline", action="store_true",
                   help="re-measure on the card and rewrite the snapshot")
    p.add_argument("--device", default=None,
                   help="where --update-baseline measures (default: the "
                   "GPU)")
    p.add_argument("--render", action="store_true",
                   help="regenerate the PERF.md tables from the snapshot")
    p.add_argument("--check", action="store_true",
                   help="structural gate (never re-measures)")
    p.add_argument("--engines", default=None, metavar="ENGINE[,ENGINE]",
                   help="with --update-baseline: re-measure only these "
                   f"knockouts ({', '.join(ENGINES)}) and keep the rest of "
                   "the snapshot")
    p.add_argument("--format", default="text",
                   choices=("text", "json", "sarif", "github"), dest="fmt")
    args = p.parse_args(argv)
    engines = None
    if args.engines:
        engines = [e.strip() for e in args.engines.split(",") if e.strip()]
        unknown = [e for e in engines if e not in ENGINES]
        if unknown or not args.update_baseline:
            print(f"attribution: --engines takes {', '.join(ENGINES)} with "
                  "--update-baseline", file=sys.stderr)
            return 2

    if args.update_baseline and engines:
        tables = dict((load_attribution_baseline() or {}).get(
            "phase_tables") or {})
        tables.update(_measure_phase_tables(args.device, engines))
        _flag_non_monotone(tables)
        write_attribution_baseline(None, phase_tables=tables)
        print(f"attribution: re-measured {', '.join(engines)} into "
              f"{_BASELINE_REL}", file=sys.stderr)
    elif args.update_baseline:
        from mpi_grid_redistribute_tpu_torch.telemetry.recorder import (
            StepRecorder,
        )

        from mpi_grid_redistribute_tpu_torch.telemetry import roofline

        rec = StepRecorder()
        label = _device_label(args.device)
        tables = _measure_phase_tables(args.device)
        narrow = _measure_roofline(args.device, recorder=rec)
        wide = _measure_roofline(args.device, n_local=WIDE_N_LOCAL)
        over = [(section, name, report[name]["achieved_fraction"])
                for section, report in (("roofline", narrow),
                                        ("roofline_wide", wide))
                for name in roofline.over_roof(report)]
        if over:
            print(f"attribution: achieved_fraction above "
                  f"{roofline.ACHIEVED_FRACTION_MAX} (a count too high), "
                  f"the snapshot is not written: {over}", file=sys.stderr)
            return 1
        _flag_non_monotone(tables)
        write_attribution_baseline(
            None, device=label, phase_tables=tables, roofline=narrow,
            roofline_wide=wide)
        print(f"attribution: wrote {_BASELINE_REL} ({len(tables)} phase "
              f"tables, {len(narrow)} + {len(wide)} roofline rows, "
              f"{label['name']}, {label['power_limit']}; "
              f"{rec.counts().get('roofline', 0)} roofline events)",
              file=sys.stderr)

    if args.render:
        doc = load_attribution_baseline()
        if doc is None:
            print("attribution: no snapshot to render — run "
                  "--update-baseline first", file=sys.stderr)
            return 2
        with open(PERF_MD, "r", encoding="utf-8") as fh:
            text = fh.read()
        new = render_markdown(doc, text)
        if new != text:
            with open(PERF_MD, "w", encoding="utf-8") as fh:
                fh.write(new)
            print("attribution: re-rendered the PERF.md tables",
                  file=sys.stderr)
        else:
            print("attribution: PERF.md already current", file=sys.stderr)

    if args.check:
        if not os.path.exists(PERF_MD):
            print("attribution: A002 not checked: no PERF.md in this "
                  "checkout (A001 and A003 checked)", file=sys.stderr)
        findings = check_findings()
        _emit(findings, args.fmt)
        return exit_code(findings)

    if not (args.update_baseline or args.render):
        doc = load_attribution_baseline()
        if doc is None:
            print("attribution: no committed snapshot — run "
                  "--update-baseline", file=sys.stderr)
            return 2
        dev = doc.get("device") or {}
        print(f"measured on {dev.get('name')}, {dev.get('power_limit')}")
        for name, md in _rendered(doc).items():
            print(f"## {name}")
            print(md)
            print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
