"""Runnable end-to-end demo of the port (the twin of the JAX package's
``examples/drift_demo.py``): the ``mpirun demo.py`` experience on one
card.

It generates random particles, redistributes them onto a 2x2x2 grid of
subdomains (8 vranks on the card), asserts every particle landed inside
its owner's subdomain, runs a short periodic drift loop with a migrate
every step, prints a per-rank stats table and the observatory's verdict,
and with ``--plot`` writes a CIC density image to ``drift_demo.png``
beside this file (or, without matplotlib, prints the density mesh's
sum).

    python -m mpi_grid_redistribute_tpu_torch.examples.drift_demo
    python -m mpi_grid_redistribute_tpu_torch.examples.drift_demo \\
        --device cpu --n 4096 --steps 3
    python -m mpi_grid_redistribute_tpu_torch.examples.drift_demo \\
        --bias --expect-alert
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="mpi_grid_redistribute_tpu_torch.examples.drift_demo",
        description="Redistribute, drift and observe particles on a 2x2x2 "
        "grid of subdomains.")
    ap.add_argument("--n", type=int, default=1 << 16,
                    help="total particles (default 65536)")
    ap.add_argument("--steps", type=int, default=20,
                    help="drift steps (default 20)")
    ap.add_argument("--device", default=None,
                    help="where it runs (default: the GPU; 'cpu')")
    ap.add_argument("--plot", action="store_true",
                    help="write drift_demo.png (needs matplotlib)")
    ap.add_argument("--bias", action="store_true",
                    help="convergent velocity field (particles pile into "
                         "one shard): the health monitor fires a "
                         "backlog-growth alert")
    ap.add_argument("--trace", type=str, default=None,
                    help="write a Perfetto/Chrome-trace JSON of the "
                         "telemetry journal here")
    ap.add_argument("--expect-alert", action="store_true",
                    help="exit non-zero unless the monitor ALERTs (pair "
                         "with --bias)")
    ap.add_argument("--halo", action="store_true",
                    help="after the drift loop, run one ghost exchange "
                         "(rd.halo()) on the redistributed state and print "
                         "per-rank ghost counts")
    ap.add_argument("--corrupt", action="store_true",
                    help="state-health drill: a short supervised service "
                         "loop with the probes armed, a NaN burst mid-run; "
                         "exit non-zero unless the corruption is detected, "
                         "paged (nan_detected ALERT + incident bundle "
                         "naming the step) and rolled back")
    args = ap.parse_args(argv)

    import torch

    import mpi_grid_redistribute_tpu_torch as pt
    from mpi_grid_redistribute_tpu_torch import _device, oracle, telemetry
    from mpi_grid_redistribute_tpu_torch.bench import common
    from mpi_grid_redistribute_tpu_torch.models import nbody
    from mpi_grid_redistribute_tpu_torch.telemetry import report as report_lib
    from mpi_grid_redistribute_tpu_torch.utils import stats as stats_lib

    dev = _device.resolve(args.device)
    grid_shape = (2, 2, 2)
    domain = pt.Domain(0.0, 1.0, periodic=True)
    R = 8
    n_local = args.n // R
    rng = np.random.default_rng(0)

    # --- 1. one-shot redistribute + ownership check (the classic demo) --
    pos = rng.random((R * n_local, 3), dtype=np.float32)
    vel = (0.2 * (rng.random((R * n_local, 3), dtype=np.float32) - 0.5))
    ids = np.arange(R * n_local, dtype=np.int32)

    # out_capacity > n_local leaves free slots per shard: the landing
    # headroom the drift loop's resident-slot migration needs
    out_cap = (n_local * 5) // 4
    rd = pt.GridRedistribute(
        domain, grid_shape, capacity_factor=4.0, out_capacity=out_cap,
        device=dev,
    )
    res = rd.redistribute(pos, vel, ids)
    count = res.count.cpu().numpy()
    positions = res.positions.cpu().numpy()
    shards = [positions[r * out_cap: r * out_cap + count[r]]
              for r in range(R)]
    oracle.assert_ownership(domain, rd.grid, shards)
    assert count.sum() == R * n_local
    print(f"redistributed {R * n_local} particles over {grid_shape}: "
          f"every particle is inside its owner's subdomain")

    summary = stats_lib.summarize_redistribute(res.stats)
    print("rank   held  received-from-remote")
    recv = res.stats.recv_counts.cpu().numpy()
    for r in range(R):
        remote = int(recv[r].sum() - recv[r, r])
        print(f"{r:4d} {count[r]:6d} {remote:10d}")
    print(f"moved {summary['moved_rows']:.0f} rows total; "
          f"recv imbalance {summary['recv_imbalance']:.3f}; "
          f"dropped {summary['dropped_send'] + summary['dropped_recv']}")
    # resolve the deferred overflow window here (one read at a known
    # point), and show the merged telemetry surface
    rd.flush_overflow_checks()
    print("telemetry: " + report_lib.format_report(rd.report()))

    # --- 2. drift loop: a migrate every step ------------------------------
    dev_grid, vgrid, n_chips = common.pick_layout(grid_shape)
    cap = max(64, n_local // 4)
    cfg = nbody.DriftConfig(
        domain=domain, grid=dev_grid, dt=0.05, capacity=cap,
        n_local=out_cap,
    )
    if args.bias:
        # convergent flight plan: every particle flies straight at one
        # shard's center, ~2/3 of the way there when the run ends, so the
        # sink's landing slots run out in the final steps and the
        # senders' backlog is still climbing (what backlog_growth pages)
        sink = np.asarray([0.25, 0.25, 0.25], np.float32)
        vel = (sink[None, :] - pos) / (args.steps * 0.05) * 0.65
        res = rd.redistribute(pos, vel, ids)
        rd.flush_overflow_checks()
        count = res.count.cpu().numpy()
    loop = nbody.make_migrate_loop(cfg, args.steps, vgrid=vgrid, device=dev)
    # drift from the redistributed (owner-placed) state: valid rows per
    # shard become the alive mask, the rest are free landing slots
    alive = (np.arange(out_cap)[None, :] < count[:, None]).reshape(-1)
    p, v, a, st = loop(
        nbody.rows_to_planar(res.positions.cpu().numpy(), vgrid.nranks),
        nbody.rows_to_planar(res.fields[0].cpu().numpy(), vgrid.nranks),
        alive,
    )
    p = nbody.planar_to_rows(p, 3, vgrid.nranks)  # the loop returns planar
    msum = stats_lib.summarize_migrate(st)
    assert int(a.sum()) == R * n_local, "conservation violated"
    stats_lib.check_no_loss(st)
    print(f"\ndrift loop: {args.steps} steps on {n_chips} device(s)"
          f" ({vgrid.nranks} vranks)"
          f"; migration {msum['migration_fraction']:.2%}/step, "
          f"population imbalance {msum['population_imbalance']:.3f}, "
          f"no particles lost")

    # --- 2b. grid observatory: flow + health + trace ----------------------
    rec = telemetry.StepRecorder()
    telemetry.record_migrate_steps(rec, st, rank_totals=True)
    acc = telemetry.FlowAccumulator()
    acc.update(st)
    telemetry.record_flow_snapshot(rec, acc)
    monitor = telemetry.HealthMonitor(
        rec,
        on_alert=lambda f: print(f"  !! {f.severity} {f.rule}: {f.reason}"),
    )
    verdict = monitor.evaluate()
    hot = acc.top_pairs(k=3)
    print(f"\nobservatory: health={verdict['status']}; "
          f"imbalance {acc.imbalance:.2f}x; hot links "
          + ", ".join(f"{s}->{d}:{n}" for s, d, n in hot))
    if args.trace:
        n_ev = telemetry.write_trace(args.trace, rec)
        print(f"wrote {args.trace} ({n_ev} trace events)")
    if args.expect_alert and verdict["status"] != "ALERT":
        print("expected an ALERT but the monitor stayed "
              f"{verdict['status']}")
        sys.exit(2)
    if not args.expect_alert and verdict["status"] == "ALERT":
        print("unexpected ALERT on a balanced workload")
        sys.exit(1)

    # --- 2c. state-health drill (--corrupt) -------------------------------
    if args.corrupt:
        import shutil
        import tempfile

        from mpi_grid_redistribute_tpu_torch.service import (
            DriverConfig,
            FaultPlan,
            RestartPolicy,
            ServiceDriver,
            StateCorruptionFault,
            Supervisor,
        )
        from mpi_grid_redistribute_tpu_torch.telemetry import (
            incident as incident_lib,
        )

        root = tempfile.mkdtemp(prefix="drift_corrupt_")
        try:
            rec2 = telemetry.StepRecorder()
            svc_cfg = DriverConfig(
                grid_shape=grid_shape, n_local=256, steps=24, seed=7,
                backend="torch", device=dev, snapshot_every=4,
                snapshot_dir=os.path.join(root, "snaps"),
                probes="counters",
                incident_dir=os.path.join(root, "incidents"),
            )
            plan = FaultPlan([StateCorruptionFault(6, rows=5)])
            sup = Supervisor(
                lambda: ServiceDriver(svc_cfg, recorder=rec2, faults=plan),
                policy=RestartPolicy(
                    backoff_base_s=0.01, backoff_cap_s=0.02
                ),
                recorder=rec2,
                sleep_fn=lambda s: None,
            )
            sv = sup.run()
            nan_steps = sorted(
                e.data["step"] for e in rec2.events("state_health")
                if e.data.get("nan_pos") or e.data.get("nan_vel")
            )
            alerts = [
                e for e in rec2.events("alert")
                if e.data.get("rule") == "nan_detected"
            ]
            restores = [
                e for e in rec2.events("restore")
                if e.data.get("what") == "state"
            ]
            bundles = incident_lib.list_bundles(svc_cfg.incident_dir)
            checks = {
                "probes saw the NaN burst": bool(nan_steps),
                "nan_detected paged": bool(alerts),
                "incident bundle names the step": any(
                    b.get("rule") == "nan_detected"
                    and nan_steps
                    and f"step {nan_steps[0]}" in str(b.get("reason", ""))
                    for b in bundles
                ),
                "restored pre-corruption snapshot": bool(
                    restores and nan_steps
                    and int(restores[-1].data["step"]) < nan_steps[0]
                ),
                "recovered in one restart": bool(
                    sv.ok and sv.restarts == 1 and sv.step == svc_cfg.steps
                ),
            }
            print("\ncorruption drill (NaN burst at a probed step):")
            for name, ok in checks.items():
                print(f"  {'ok' if ok else 'FAIL'}  {name}")
            if nan_steps:
                print(f"  corruption entered at step {nan_steps[0]}, "
                      f"restored to step "
                      f"{restores[-1].data['step'] if restores else '?'}")
            if not all(checks.values()):
                sys.exit(3)
        finally:
            shutil.rmtree(root, ignore_errors=True)

    # --- 2d. optional halo exchange (the public halo API) ----------------
    if args.halo:
        # ghosts for the owner-placed state of step 1: every shard gets
        # copies of neighbor particles within `width` of its faces,
        # shifted into its frame across the periodic wraps
        width = 0.25 * min(rd.grid.cell_widths(domain))
        hres = rd.halo(res.positions, res.fields[0], width=width,
                       count=res.count)
        gcount = hres.ghost_count.cpu().numpy()
        assert int(hres.overflow.sum()) == 0, "halo overflow after auto-grow"
        print(f"\nhalo exchange: width {width:.3f} -> "
              f"{int(gcount.sum())} ghosts "
              f"(per rank: {', '.join(str(int(c)) for c in gcount)}); "
              "zero overflow")

    # --- 3. optional density plot ----------------------------------------
    if args.plot:
        dep_cfg = nbody.DriftConfig(
            domain=domain, grid=dev_grid, dt=0.0, capacity=cap,
            n_local=out_cap, deposit_shape=(64, 64, 64),
        )
        dep = nbody.build_deposit_masked(dep_cfg)
        rows = torch.as_tensor(p).to(dev)
        rho = dep(rows, torch.ones((rows.shape[0],), dtype=torch.float32,
                                   device=dev), a.to(dev))
        rho = rho.cpu().numpy()
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.imshow(rho.sum(axis=2).T, origin="lower", cmap="viridis")
            plt.colorbar(label="projected density")
            plt.title("drift_demo: CIC density (z-projection)")
            out = os.path.join(os.path.dirname(__file__), "drift_demo.png")
            plt.savefig(out, dpi=120)
            print(f"wrote {out}")
        except ImportError:
            print("matplotlib unavailable; skipped plot "
                  f"(density mesh sum {rho.sum():.1f})")


if __name__ == "__main__":
    main()
