"""grid-top: a live terminal dashboard over the port's telemetry (the twin
of the JAX package's ``scripts/grid_top.py``; stdlib plus the port's
``telemetry.store`` and ``telemetry.query``).

Two sources:

* ``--store DIR``: a durable journal store (``telemetry/store.py``; what
  a service driver started with ``--store-dir`` keeps), read through
  :class:`~..telemetry.store.StoreReader` and the query plane, so
  compacted ``store_window`` summaries give exact counts and quantile
  sketches beside the raw events;
* ``--url http://host:port``: a ``tools.metrics_serve`` endpoint, polled
  for ``/metrics`` (an OpenMetrics parse), ``/healthz``, ``/query`` and
  ``/incidents``.

Panels: step rate and p50/p99 step latency, fast-path share, engine mix,
flow imbalance, population and backlog, state health (when the run
journaled ``state_health`` probe events; a nonzero corruption counter
flags ``** CORRUPT **``), the health verdict, recent alerts and
incidents. ``--once`` prints one plain snapshot and exits 0 when the
source was readable (the CI mode); on the same store its bytes are the
reference's.

    python -m mpi_grid_redistribute_tpu_torch.tools.grid_top --store DIR
    python -m mpi_grid_redistribute_tpu_torch.tools.grid_top \\
        --url http://127.0.0.1:9100 --interval 1
    python -m mpi_grid_redistribute_tpu_torch.tools.grid_top \\
        --store DIR --once
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request

_CLEAR = "\x1b[H\x1b[2J"


# ----------------------------------------------------- store collector


def collect_store(store_dir: str) -> dict:
    """One dashboard snapshot from a journal store on disk."""
    from mpi_grid_redistribute_tpu_torch.telemetry import query as query_lib
    from mpi_grid_redistribute_tpu_torch.telemetry import store as store_lib

    reader = store_lib.StoreReader(store_dir)
    rows = query_lib.rows_of(reader)
    counts = reader.counts()
    man = reader.manifest

    # step timing: merged histogram over raw samples + compacted
    # sketches — the exact-quantile path
    h = reader.latency_histogram()
    p50 = h.quantile(0.5) if h.count else None
    p99 = h.quantile(0.99) if h.count else None

    # step rate over the last minute of retained rows
    step_rows = query_lib.filter_rows(rows, kind="step_latency,store_window")
    rate = None
    if step_rows:
        t_hi = max(query_lib._row_time(r) for r in step_rows)
        recent = query_lib.filter_rows(step_rows, since=t_hi - 60.0)
        n = sum(query_lib._row_weight(r) for r in recent)
        span = t_hi - min(query_lib._row_time(r) for r in recent)
        rate = n / span if span > 0 else float(n)

    # fast path: raw events + compacted window sums
    fp_taken = fp_total = 0
    imbalance = None
    dropped = 0
    state = None  # stays None until a probe event proves probes were on
    for r in rows:
        kind = r.get("kind")
        if kind == "fast_path":
            fp_total += 1
            fp_taken += int(r.get("taken", 0))
        elif kind == "store_window":
            fp = r.get("fast_path", {})
            fp_taken += int(fp.get("taken", 0))
            fp_total += int(fp.get("total", 0))
            dropped += int(r.get("dropped", {}).get("total", 0))
            for _, v in r.get("imbalance", []):
                imbalance = v
            st = r.get("state")
            if st:
                state = state or {"nan": 0, "oob": 0,
                                  "live": None, "residual": None}
                state["nan"] += int(st.get("nan_pos", 0))
                state["nan"] += int(st.get("nan_vel", 0))
                state["oob"] += int(st.get("oob", 0))
                if st.get("live_last") is not None:
                    state["live"] = int(st["live_last"])
                if st.get("residual_last") is not None:
                    state["residual"] = int(st["residual_last"])
        elif kind == "flow_snapshot":
            if "imbalance" in r:
                imbalance = float(r["imbalance"])
        elif kind == "step_latency":
            dropped += int(r.get("dropped", 0))
        elif kind == "state_health":
            state = state or {"nan": 0, "oob": 0,
                              "live": None, "residual": None}
            state["nan"] += int(r.get("nan_pos", 0))
            state["nan"] += int(r.get("nan_vel", 0))
            state["oob"] += int(r.get("oob", 0))
            state["live"] = int(r.get("live", 0))
            state["residual"] = int(r.get("residual", 0))

    engines: dict = {}
    for r in query_lib.filter_rows(rows, kind="redistribute"):
        eng = r.get("engine", "unknown")
        engines[eng] = engines.get(eng, 0) + 1

    alerts = [
        {
            "rule": r.get("rule"),
            "severity": r.get("severity"),
            "reason": r.get("reason"),
            "time": r.get("time"),
        }
        for r in query_lib.filter_rows(rows, kind="alert,alert_raised")
    ]
    incidents = [
        {
            "trigger": r.get("trigger", r.get("rule")),
            "dir": r.get("dir"),
            "time": r.get("time"),
        }
        for r in query_lib.filter_rows(rows, kind="incident")
    ]

    pop = backlog = None
    for r in query_lib.filter_rows(rows, kind="migrate_step,store_window"):
        if r.get("kind") == "store_window":
            m = r.get("migrate", {})
            pop = m.get("population_last", pop)
            backlog = m.get("backlog_last", backlog)
        else:
            pop = r.get("population", pop)
            backlog = r.get("backlog", backlog)

    return {
        "source": store_dir,
        "writer": man.get("writer"),
        "updated": man.get("updated"),
        "events_total": sum(counts.values()),
        "counts": counts,
        "segments": len(man.get("segments", [])),
        "retired": man.get("retired", {}).get("segments", 0),
        "store_bytes": sum(s["bytes"] for s in man.get("segments", []))
        + (man.get("active") or {}).get("bytes", 0),
        "step_rate": rate,
        "p50": p50,
        "p99": p99,
        "latency_samples": h.count,
        "fast_path": (fp_taken / fp_total) if fp_total else None,
        "engines": engines,
        "imbalance": imbalance,
        "dropped": dropped,
        "population": pop,
        "backlog": backlog,
        "state": state,
        "health": None,
        "alerts": alerts[-5:],
        "incidents": incidents[-5:],
    }


# ------------------------------------------------------- URL collector


def _fetch(url: str, timeout: float = 5.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode("utf-8", "replace")


def parse_openmetrics(text: str) -> dict:
    """Minimal OpenMetrics sample parse: ``{name: {labels_str: value}}``
    (labels_str is the raw ``k="v",...`` inside the braces, ``""`` for
    bare samples). Enough for the dashboard's panel math."""
    out: dict = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        try:
            head, value = ln.rsplit(" ", 1)
            if "{" in head:
                name, rest = head.split("{", 1)
                labels = rest.rstrip("}")
            else:
                name, labels = head, ""
            out.setdefault(name, {})[labels] = float(value)
        except ValueError:
            continue
    return out


def _histogram_quantile(samples: dict, name: str, q: float):
    """Upper-bound quantile from cumulative ``le`` bucket samples —
    the same estimate ``metrics.Histogram.quantile`` computes."""
    import math

    buckets = []
    for labels, v in samples.get(f"{name}_bucket", {}).items():
        for part in labels.split(","):
            if part.startswith('le="'):
                edge = part[4:-1]
                buckets.append(
                    (math.inf if edge == "+Inf" else float(edge), v)
                )
    if not buckets:
        return None, 0
    buckets.sort()
    count = buckets[-1][1]
    if count <= 0:
        return None, 0
    target = max(1, math.ceil(q * count))
    for edge, cum in buckets:
        if cum >= target:
            return (None if math.isinf(edge) else edge), int(count)
    return None, int(count)


def collect_url(base: str) -> dict:
    """One dashboard snapshot from a ``tools.metrics_serve`` endpoint."""
    base = base.rstrip("/")
    fam = parse_openmetrics(_fetch(f"{base}/metrics"))

    def total(name):
        series = fam.get(name, {})
        return sum(series.values()) if series else None

    counts = {}
    for labels, v in fam.get("grid_journal_events_total", {}).items():
        for part in labels.split(","):
            if part.startswith('kind="'):
                counts[part[6:-1]] = int(v)
    p50, n50 = _histogram_quantile(fam, "grid_step_latency_seconds", 0.5)
    p99, n = _histogram_quantile(fam, "grid_step_latency_seconds", 0.99)
    if n == 0:  # library loops journal step_time, not step_latency
        p50, _ = _histogram_quantile(fam, "grid_step_time_seconds", 0.5)
        p99, n = _histogram_quantile(fam, "grid_step_time_seconds", 0.99)
    fp = fam.get("grid_fast_path_steps_total", {})
    fp_taken = sum(v for k, v in fp.items() if 'taken="1"' in k)
    fp_all = sum(fp.values())
    imb = fam.get("grid_flow_imbalance", {}).get("")
    engines = {}
    for labels, v in fam.get("grid_exchange_wire_bytes_total", {}).items():
        for part in labels.split(","):
            if part.startswith('engine="'):
                engines[part[8:-1]] = int(v)

    state = None
    nan_fam = fam.get("grid_state_nan_total", {})
    oob_fam = fam.get("grid_state_oob_total", {})
    live_g = fam.get("grid_state_live_rows", {}).get("")
    res_g = fam.get("grid_state_residual", {}).get("")
    if nan_fam or oob_fam or live_g is not None:
        state = {
            "nan": int(sum(nan_fam.values())),
            "oob": int(sum(oob_fam.values())),
            "live": None if live_g is None else int(live_g),
            "residual": None if res_g is None else int(res_g),
        }

    health = None
    try:
        health = json.loads(_fetch(f"{base}/healthz"))
    except (urllib.error.URLError, ValueError, OSError):
        pass
    alerts = []
    try:
        doc = json.loads(
            _fetch(f"{base}/query?kind=alert,alert_raised&limit=5")
        )
        alerts = [
            {
                "rule": r.get("rule"),
                "severity": r.get("severity"),
                "reason": r.get("reason"),
                "time": r.get("time"),
            }
            for r in doc.get("events", [])
        ]
    except (urllib.error.URLError, ValueError, OSError):
        pass  # older server without /query: panel stays empty
    incidents = []
    try:
        doc = json.loads(_fetch(f"{base}/incidents"))
        incidents = [
            {"trigger": b.get("trigger"), "dir": b.get("dir"),
             "time": b.get("time")}
            for b in doc.get("incidents", [])
        ]
    except (urllib.error.URLError, ValueError, OSError):
        pass

    return {
        "source": base,
        "writer": None,
        "updated": time.time(),
        "events_total": sum(counts.values()),
        "counts": counts,
        "segments": None,
        "retired": None,
        "store_bytes": None,
        "step_rate": None,
        "p50": p50,
        "p99": p99,
        "latency_samples": n,
        "fast_path": (fp_taken / fp_all) if fp_all else None,
        "engines": engines,
        "imbalance": imb,
        "dropped": None,
        "population": fam.get("grid_population_rows", {}).get(""),
        "backlog": fam.get("grid_backlog_rows", {}).get(""),
        "state": state,
        "health": health,
        "alerts": alerts[-5:],
        "incidents": incidents[-5:],
    }


# -------------------------------------------------------------- render


def _fmt(v, unit="", scale=1.0, digits=3):
    if v is None:
        return "--"
    return f"{float(v) * scale:.{digits}g}{unit}"


def _fmt_bytes(v):
    if v is None:
        return "--"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if v < 1024 or unit == "GiB":
            return f"{v:.1f}{unit}" if unit != "B" else f"{int(v)}B"
        v /= 1024.0
    return f"{v:.1f}GiB"


def render(d: dict, width: int = 72) -> str:
    """Plain-text dashboard screen (the same text ``--once`` prints)."""
    bar = "─" * width
    lines = [
        f"grid-top · {d['source']}",
        f"  updated {time.strftime('%H:%M:%S', time.localtime(d['updated']))}"
        + (
            f" · writer {d['writer']['host']}:{d['writer']['pid']}"
            if d.get("writer")
            else ""
        ),
        bar,
        "  steps".ljust(14)
        + f"rate {_fmt(d['step_rate'], '/s')}".ljust(18)
        + f"p50 {_fmt(d['p50'], 's')}".ljust(16)
        + f"p99 {_fmt(d['p99'], 's')}".ljust(16)
        + f"n={d['latency_samples']}",
        "  routing".ljust(14)
        + f"fast-path {_fmt(d['fast_path'], '', 100, 3)}%".ljust(22)
        + "engines "
        + (
            " ".join(f"{k}:{v}" for k, v in sorted(d["engines"].items()))
            or "--"
        ),
        "  flow".ljust(14)
        + f"imbalance {_fmt(d['imbalance'])}".ljust(22)
        + f"pop {_fmt(d['population'], digits=6)}".ljust(16)
        + f"backlog {_fmt(d['backlog'])}".ljust(16)
        + f"dropped {_fmt(d['dropped'])}",
    ]
    state = d.get("state")
    if state is not None:
        clean = not state["nan"] and not state["oob"] and not state["residual"]
        lines.append(
            "  state".ljust(14)
            + f"live {_fmt(state['live'], digits=6)}".ljust(18)
            + f"nan {state['nan']}".ljust(12)
            + f"oob {state['oob']}".ljust(12)
            + f"residual {_fmt(state['residual'])}"
            + ("" if clean else "  ** CORRUPT **")
        )
    if d.get("segments") is not None:
        lines.append(
            "  store".ljust(14)
            + f"events {d['events_total']}".ljust(18)
            + f"segments {d['segments']} (+{d['retired']} retired)".ljust(26)
            + f"disk {_fmt_bytes(d['store_bytes'])}"
        )
    else:
        lines.append("  journal".ljust(14) + f"events {d['events_total']}")
    health = d.get("health")
    if health is not None:
        status = health.get("status", "?")
        findings = health.get("findings", [])
        lines.append(
            "  health".ljust(14)
            + status
            + (
                "  " + "; ".join(
                    f"{f.get('rule')}: {f.get('reason')}" for f in findings
                )[: width - 20]
                if findings
                else ""
            )
        )
    lines.append(bar)
    lines.append("  recent alerts")
    if d["alerts"]:
        for a in d["alerts"]:
            when = (
                time.strftime("%H:%M:%S", time.localtime(a["time"]))
                if a.get("time")
                else "--:--:--"
            )
            lines.append(
                f"    {when}  {a.get('severity') or '-'}"
                f"  {a.get('rule')}  {str(a.get('reason') or '')[:40]}"
            )
    else:
        lines.append("    (none)")
    lines.append("  recent incidents")
    if d["incidents"]:
        for i in d["incidents"]:
            when = (
                time.strftime("%H:%M:%S", time.localtime(i["time"]))
                if i.get("time")
                else "--:--:--"
            )
            lines.append(
                f"    {when}  {i.get('trigger')}  {i.get('dir') or ''}"
            )
    else:
        lines.append("    (none)")
    top_kinds = sorted(
        d["counts"].items(), key=lambda kv: -kv[1]
    )[:6]
    lines.append(bar)
    lines.append(
        "  events  "
        + "  ".join(f"{k}:{v}" for k, v in top_kinds)
    )
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Live terminal dashboard over a journal store or a "
        "metrics_serve endpoint."
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--store", metavar="DIR",
                     help="journal-store root (telemetry/store.py)")
    src.add_argument("--url", metavar="URL",
                     help="metrics_serve base URL (http://host:port)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh period in seconds (live mode)")
    p.add_argument("--once", action="store_true",
                   help="print one plain snapshot and exit (CI mode)")
    p.add_argument("--iterations", type=int, default=0, metavar="N",
                   help="stop after N refreshes (0 = run until Ctrl-C)")
    args = p.parse_args(argv)

    def collect():
        if args.store:
            return collect_store(args.store)
        return collect_url(args.url)

    if args.once:
        try:
            sys.stdout.write(render(collect()))
        except Exception as e:  # CI mode: readable failure, rc 1
            print(f"grid-top: cannot read source: {e}", file=sys.stderr)
            return 1
        return 0

    n = 0
    try:
        while True:
            try:
                screen = render(collect())
                sys.stdout.write(_CLEAR + screen)
            except Exception as e:
                sys.stdout.write(
                    _CLEAR + f"grid-top: source unreadable: {e}\n"
                    "  (retrying)\n"
                )
            sys.stdout.flush()
            n += 1
            if args.iterations and n >= args.iterations:
                break
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
