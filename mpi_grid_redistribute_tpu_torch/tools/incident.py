"""Inspect flight-recorder incident bundles (the twin of the JAX
package's ``scripts/incident.py``).

A bundle directory is what :class:`~..telemetry.incident.FlightRecorder`
froze when an ALERT, an injected fault or a bench REGRESSION fired: the
retained journal window, all-time counts, the OpenMetrics exposition,
the health findings, the flow snapshot, the env fingerprint and the
triggering step context, indexed by ``index.json``. Three subcommands:

* ``list DIR``: one line per bundle (id, rule, trigger, capture time,
  triggering trace id), oldest first; ``--json`` prints the raw index
  entries instead;
* ``show DIR ID``: a bundle's ``index.json`` plus the files present;
* ``export DIR ID --out TRACE.json``: the bundle's frozen journal window
  as a Perfetto/Chrome trace (open at https://ui.perfetto.dev).

    python -m mpi_grid_redistribute_tpu_torch.tools.incident list DIR
    python -m mpi_grid_redistribute_tpu_torch.tools.incident show DIR ID
    python -m mpi_grid_redistribute_tpu_torch.tools.incident export \\
        DIR ID --out incident.trace.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def cmd_list(args) -> int:
    from mpi_grid_redistribute_tpu_torch.telemetry import (
        incident as incident_lib,
    )

    entries = incident_lib.list_bundles(args.dir)
    if args.json:
        json.dump(entries, sys.stdout, indent=2, sort_keys=True)
        print()
        return 0
    if not entries:
        print(f"no bundles under {args.dir}")
        return 0
    for e in entries:
        if "error" in e:
            print(f"{e.get('id', '?')}: UNREADABLE ({e['error']})")
            continue
        trace = (e.get("context") or {}).get("trace", "-")
        print(
            f"{e.get('id')}  rule={e.get('rule')}  "
            f"trigger={e.get('trigger')}  t={e.get('captured_at')}  "
            f"trace={trace}"
        )
    return 0


def cmd_show(args) -> int:
    from mpi_grid_redistribute_tpu_torch.telemetry import (
        incident as incident_lib,
    )

    try:
        index = incident_lib.load_bundle(args.dir, args.id)
    except (OSError, ValueError) as exc:
        raise SystemExit(f"{args.dir}/{args.id}: {exc}")
    json.dump(index, sys.stdout, indent=2, sort_keys=True)
    print()
    return 0


def cmd_export(args) -> int:
    from mpi_grid_redistribute_tpu_torch.telemetry import (
        aggregate,
        traceview,
    )

    journal = os.path.join(args.dir, args.id, "journal.jsonl")
    if not os.path.isfile(journal):
        raise SystemExit(f"{journal}: no frozen journal in this bundle")
    # the frozen window is a normal to_jsonl export: re-hydrate it
    # through the aggregation layer (one shard), so the trace is what a
    # pod merge of the same lines would show
    rec = aggregate.merge_journals([journal]).to_recorder()
    n_ev = traceview.write_trace(args.out, rec)
    print(
        f"wrote {args.out} ({n_ev} trace events) — open at "
        f"https://ui.perfetto.dev"
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mpi_grid_redistribute_tpu_torch.tools.incident",
        description="List, inspect and export flight-recorder incident "
        "bundles (telemetry/incident.py).",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_list = sub.add_parser("list", help="list bundles under a directory")
    p_list.add_argument("dir", help="incident bundle root")
    p_list.add_argument(
        "--json", action="store_true", help="print raw index entries"
    )
    p_list.set_defaults(fn=cmd_list)

    p_show = sub.add_parser("show", help="print one bundle's index")
    p_show.add_argument("dir", help="incident bundle root")
    p_show.add_argument("id", help="bundle id (see `list`)")
    p_show.set_defaults(fn=cmd_show)

    p_exp = sub.add_parser(
        "export", help="export a bundle's journal window to a Perfetto trace"
    )
    p_exp.add_argument("dir", help="incident bundle root")
    p_exp.add_argument("id", help="bundle id (see `list`)")
    p_exp.add_argument("--out", required=True, help="output trace JSON path")
    p_exp.set_defaults(fn=cmd_export)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
