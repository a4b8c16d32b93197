"""Export the port's telemetry to a Perfetto/Chrome-trace JSON (the twin of
the JAX package's ``scripts/trace_export.py``; a CLI over
:mod:`..telemetry.traceview`). Sources, combinable:

* ``--journal FILE``: a JSON Lines journal written by
  ``StepRecorder.to_jsonl``; its events become the instant and counter
  tracks;
* ``--phases FILE``: a JSON list of phase rows, as
  ``bench/knockout_stages.py`` and ``bench/knockout_pipeline.py`` write
  them (``KNOCKOUT_JSON=file``); the rows become the duration lane;
* ``--demo``: run a small drift loop of the port on the card (``--device
  cpu``: on the CPU) and trace its journal.

``--roofline PROGRAM`` annotates the duration lane with PROGRAM's row of
the port's attribution snapshot (``telemetry/attribution_baseline.json``,
``tools.attribution``). On the same journal and phases file the trace
is the reference's, byte for byte.

    python -m mpi_grid_redistribute_tpu_torch.tools.trace_export \\
        --journal run.jsonl --out trace.json
    KNOCKOUT_JSON=phases.json python -m \\
        mpi_grid_redistribute_tpu_torch.bench.knockout_stages 4096
    python -m mpi_grid_redistribute_tpu_torch.tools.trace_export \\
        --phases phases.json --roofline migrate_sparse_vranks --out t.json
    python -m mpi_grid_redistribute_tpu_torch.tools.trace_export \\
        --demo --out trace.json

Open the output at https://ui.perfetto.dev or chrome://tracing.
"""

from __future__ import annotations

import argparse
import json
import sys


def load_journal(path: str):
    """Re-hydrate a StepRecorder from a ``to_jsonl`` export."""
    from mpi_grid_redistribute_tpu_torch import telemetry

    rec = telemetry.StepRecorder()
    n_lines = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            kind = obj.pop("kind")
            obj.pop("seq", None)
            t = obj.pop("time", None)
            # envelope tags identify the writer, not the event: keep the
            # payload clean and carry the identity on the recorder
            host, pid = obj.pop("host", None), obj.pop("pid", None)
            if host is not None:
                rec.host = str(host)
            if pid is not None:
                rec.pid = int(pid)
            # record_at keeps the original wall time, so the track
            # timestamps are honest (record() would stamp "now")
            rec.record_at(kind, t, **obj)
            n_lines += 1
    if n_lines == 0:
        raise SystemExit(f"{path}: empty journal")
    return rec


def load_phases(path: str):
    """Load phase rows dumped as JSON into PhaseTiming tuples."""
    from mpi_grid_redistribute_tpu_torch.telemetry import phases as phases_lib

    with open(path) as f:
        rows = json.load(f)
    if not isinstance(rows, list):
        raise SystemExit(f"{path}: expected a JSON list of phase rows")
    out = []
    for r in rows:
        out.append(
            phases_lib.PhaseTiming(
                phase=r["phase"],
                cumulative_s=float(r["cumulative_s"]),
                delta_s=float(r["delta_s"]),
                logical_bytes=(
                    None
                    if r.get("logical_bytes") is None
                    else int(r["logical_bytes"])
                ),
                roofline_s=(
                    None
                    if r.get("roofline_s") is None
                    else float(r["roofline_s"])
                ),
            )
        )
    return out


def demo_recorder(steps: int = 16, device=None):
    """Run a small drift loop of the port on ``device`` (``None``: the
    GPU, raising without one) and return its populated journal."""
    import numpy as np

    from mpi_grid_redistribute_tpu_torch import _device, telemetry
    from mpi_grid_redistribute_tpu_torch.bench import common
    from mpi_grid_redistribute_tpu_torch.domain import Domain
    from mpi_grid_redistribute_tpu_torch.models import nbody

    dev = _device.resolve(device)
    grid_shape = (2, 2, 2)
    dev_grid, vgrid, _ = common.pick_layout(grid_shape)
    rng = np.random.default_rng(0)
    n_local = 1 << 11
    pos, _, alive = common.uniform_state(grid_shape, n_local, 0.9, rng)
    vel = (0.02 * (rng.random(pos.shape, dtype=np.float32) - 0.5)).astype(
        np.float32
    )
    cfg = nbody.DriftConfig(
        domain=Domain(0.0, 1.0, periodic=True), grid=dev_grid, dt=1.0,
        capacity=max(64, n_local // 4), n_local=n_local,
    )
    loop = nbody.make_migrate_loop(cfg, steps, vgrid=vgrid, device=dev)
    _, _, _, st = loop(
        nbody.rows_to_planar(pos, vgrid.nranks),
        nbody.rows_to_planar(vel, vgrid.nranks),
        alive,
    )
    rec = telemetry.StepRecorder()
    telemetry.record_migrate_steps(rec, st, rank_totals=True)
    acc = telemetry.FlowAccumulator()
    acc.update(st)
    telemetry.record_flow_snapshot(rec, acc)
    telemetry.HealthMonitor(rec).evaluate()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mpi_grid_redistribute_tpu_torch.tools.trace_export",
        description="Export a journal, knockout phase rows or a demo run "
        "to a Perfetto/Chrome-trace JSON.")
    ap.add_argument("--journal", type=str, default=None,
                    help="StepRecorder JSONL export to re-hydrate")
    ap.add_argument("--phases", type=str, default=None,
                    help="JSON list of attribute_phases rows "
                         "(KNOCKOUT_JSON=file of bench/knockout_*.py)")
    ap.add_argument("--demo", action="store_true",
                    help="run a small drift loop in-process and trace it")
    ap.add_argument("--device", default=None,
                    help="where --demo runs (default: the GPU; 'cpu')")
    ap.add_argument("--steps", type=int, default=16,
                    help="demo drift steps (default 16)")
    ap.add_argument("--step-seconds", type=float, default=None,
                    help="measured per-step seconds for the counter "
                         "track's synthetic time axis (default 1 ms)")
    ap.add_argument("--roofline", type=str, default=None,
                    metavar="PROGRAM",
                    help="annotate the --phases duration lane with "
                         "PROGRAM's row of the port's attribution "
                         "snapshot (telemetry/attribution_baseline.json)")
    ap.add_argument("--out", type=str, required=True,
                    help="output trace JSON path")
    args = ap.parse_args(argv)

    if not (args.journal or args.phases or args.demo):
        ap.error("nothing to export: give --journal, --phases, or --demo")

    from mpi_grid_redistribute_tpu_torch.telemetry import traceview

    rec = None
    if args.journal:
        rec = load_journal(args.journal)
    elif args.demo:
        rec = demo_recorder(steps=args.steps, device=args.device)
    timings = load_phases(args.phases) if args.phases else None

    annotations = None
    if args.roofline:
        if not timings:
            ap.error("--roofline annotates the phase lane: give --phases")
        from mpi_grid_redistribute_tpu_torch.analysis.baseline import (
            load_attribution_baseline,
        )

        doc = load_attribution_baseline()
        row = ((doc or {}).get("roofline") or {}).get(args.roofline)
        if row is None:
            raise SystemExit(
                f"--roofline: program {args.roofline!r} is not in the "
                "port's attribution snapshot — see tools.attribution "
                "--update-baseline"
            )
        cost = {
            k: row.get(k)
            for k in (
                "flops",
                "bytes_accessed",
                "t_predicted_s",
                "bound_by",
                "bytes_ratio",
            )
        }
        annotations = {str(t.phase): cost for t in timings}

    n_ev = traceview.write_trace(
        args.out, rec, phase_timings=timings,
        step_seconds=args.step_seconds,
        annotations=annotations,
    )
    print(f"wrote {args.out} ({n_ev} trace events) — open at "
          f"https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    sys.exit(main())
