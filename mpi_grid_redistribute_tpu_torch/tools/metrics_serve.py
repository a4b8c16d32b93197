"""Serve the port's metrics plane over HTTP (the twin of the JAX
package's ``scripts/metrics_serve.py``): a stdlib ``http.server`` front
end over :mod:`..telemetry.metrics`, :mod:`..telemetry.aggregate`,
:mod:`..telemetry.store` and :mod:`..telemetry.query`.

* ``GET /metrics``: OpenMetrics text, rebuilt from the journal source on
  EVERY scrape: counters are the recorder's exact all-time counts,
  gauges and histograms cover the retained window. No device work: the
  journal is host memory (or files).
* ``GET /healthz``: the JSON verdict of a ``HealthMonitor`` run
  read-only over the same journal (``evaluate(record=False)``); HTTP 200
  on OK/WARN, 503 on ALERT.
* ``GET /incidents`` (with ``--incident-dir``): the flight-recorder
  bundles under the directory (each entry its ``index.json``).
* ``GET /query``: the query plane (:mod:`..telemetry.query`): filter by
  ``kind``/``step_min``/``step_max``/``trace``/``host``/``pid``/
  ``since``/``until``/``ctx.<field>``, shape with ``agg=<op>`` windowed
  series or ``by=<key>`` grouped counts. Bad parameters are HTTP 400.
* ``GET /events``: a cursor-resumable event stream over the same source
  (the cursor is the ``host:pid:seq`` triple); ``limit`` bounds the page
  and ``timeout_s`` long-polls until new events arrive.

Journal sources, one of:

* ``--journal FILE`` (repeatable): JSONL shard(s) written by
  ``StepRecorder.to_jsonl``, merged with ``aggregate.merge_journals``
  (``--align wall|start``) and re-read when any shard changes (cached on
  ``(path, mtime, size)``);
* ``--store DIR``: a durable journal store (``MANIFEST.json`` +
  segments), re-read when the manifest changes; counters stay the
  manifest's exact all-time counts after retention and compaction;
* ``--demo``: a small in-process redistribute loop in a background
  thread, on the card (``--device cpu`` runs it on the CPU).

    python -m mpi_grid_redistribute_tpu_torch.tools.metrics_serve \\
        --store DIR --incident-dir INC --port 9100
    python -m mpi_grid_redistribute_tpu_torch.tools.metrics_serve \\
        --demo --once
"""

from __future__ import annotations

# gridlint: service-path

import argparse
import http.server
import json
import os
import signal
import sys
import threading
import time

OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)


def _shard_key(paths):
    """Cache key over the shard files: ``(path, mtime_ns, size)`` per
    shard. Any append, truncation, replacement or late-appearing shard
    changes the key; a quiescent journal keeps it stable."""
    key = []
    for p in paths:
        try:
            st = os.stat(p)
            key.append((p, st.st_mtime_ns, st.st_size))
        except OSError:
            key.append((p, None, None))
    return tuple(key)


def journal_snapshotter(paths, align):
    """``(snapshot, shutdown)`` over JSONL shard files: re-reads and
    re-merges when any shard changed since the last scrape (keyed on
    ``(path, mtime, size)``), so scrapes track a journal that is still
    growing without re-parsing an unchanged one on every poll. Nothing
    to stop — ``shutdown`` is a no-op."""
    from mpi_grid_redistribute_tpu_torch.telemetry import aggregate

    lock = threading.Lock()
    cache = {"key": None, "rec": None}

    def snapshot():
        # stat outside the lock (cheap, no shared state), compare under
        # it; parse outside the lock on a miss so a slow merge does not
        # serialize concurrent scrapes, then double-check before storing
        key = _shard_key(paths)
        with lock:
            if cache["key"] == key and cache["rec"] is not None:
                return cache["rec"]
        merged = aggregate.merge_journals(paths, align=align)
        rec = merged.to_recorder(pod_steps=len(merged.shards) > 1)
        with lock:
            cache["key"] = key
            cache["rec"] = rec
        return rec

    def shutdown():
        return None

    return snapshot, shutdown


def store_snapshotter(store_dir):
    """``(snapshot, query_snapshot, shutdown)`` over a durable
    ``telemetry.store`` root. ``snapshot`` returns a replayed
    ``StepRecorder`` with its all-time counters pinned to the
    manifest's exact totals (what ``/metrics`` and ``/healthz``
    consume); ``query_snapshot`` returns the ``StoreReader`` itself so
    ``/query`` and ``/events`` see compacted ``store_window`` rows
    first-class (quantiles over summaries stay exact). Both are cached
    keyed on the manifest's ``(mtime_ns, size)`` — the store's writer
    publishes the manifest atomically, so a changed key is a complete
    new store state, never a torn one."""
    from mpi_grid_redistribute_tpu_torch.telemetry import store as store_lib

    manifest_path = os.path.join(store_dir, "MANIFEST.json")
    lock = threading.Lock()
    cache = {"key": None, "reader": None, "rec": None}

    def _key():
        try:
            st = os.stat(manifest_path)
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None

    def _refresh():
        key = _key()
        with lock:
            if cache["key"] == key and cache["reader"] is not None:
                return cache["reader"], cache["rec"]
        reader = store_lib.StoreReader(store_dir)
        rec = reader.to_recorder()
        with lock:
            cache["key"] = key
            cache["reader"] = reader
            cache["rec"] = rec
        return reader, rec

    def snapshot():
        return _refresh()[1]

    def query_snapshot():
        return _refresh()[0]

    def shutdown():
        return None

    return snapshot, query_snapshot, shutdown


def demo_snapshotter(steps: int = 200, device=None):
    """``(snapshot, shutdown)`` over a small redistribute loop run in a
    background thread; scrapes snapshot its recorder live. Runs the
    torch backend on ``device`` (``None``: the GPU, raising here, before
    the thread starts, when there is none). ``shutdown`` sets the stop
    event and joins the drive thread, so every exit path (``--once``,
    Ctrl-C, SIGTERM, server teardown) leaves no thread behind."""
    import numpy as np

    from mpi_grid_redistribute_tpu_torch import api
    from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid

    rd = api.GridRedistribute(
        Domain(0.0, 1.0, periodic=True), ProcessGrid((2, 2, 2)),
        backend="torch", device=device,
    )
    rng = np.random.default_rng(0)
    stop = threading.Event()

    def drive():  # racecheck: recorder-writer
        # the drive thread is the recorder's single writer; the HTTP
        # handlers only snapshot events()/counts()
        n = 4096
        pos = rng.random((n, 3), dtype=np.float32)
        vel = 0.1 * (rng.random((n, 3), dtype=np.float32) - 0.5)
        for _ in range(steps):
            if stop.is_set():
                return
            t0 = time.perf_counter()
            rd.redistribute(pos, vel)
            rd.monitor.note_step_time(time.perf_counter() - t0)
            rd.monitor.evaluate()
            pos = (pos + 0.05 * vel) % 1.0
        stop.set()

    t = threading.Thread(target=drive, daemon=True)
    t.start()

    def snapshot():
        return rd.telemetry

    def shutdown():
        stop.set()
        t.join(timeout=10)

    return snapshot, shutdown


def make_handler(snapshot, incident_dir=None, query_source=None):
    """An HTTPRequestHandler bound to a journal snapshot factory;
    ``incident_dir`` additionally serves the flight-recorder bundle
    listing on ``/incidents`` (pure file reads — no journal state).
    ``query_source`` overrides the source ``/query``/``/events`` read
    (the store mode passes the ``StoreReader`` here so compacted
    summary rows stay visible); defaults to ``snapshot``."""
    import urllib.parse

    from mpi_grid_redistribute_tpu_torch.telemetry import health as health_lib
    from mpi_grid_redistribute_tpu_torch.telemetry import (
        incident as incident_lib,
    )
    from mpi_grid_redistribute_tpu_torch.telemetry import metrics as metrics_lib
    from mpi_grid_redistribute_tpu_torch.telemetry import query as query_lib

    events_source = query_source if query_source is not None else snapshot

    class Handler(http.server.BaseHTTPRequestHandler):
        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code, doc):
            body = (json.dumps(doc, sort_keys=True) + "\n").encode("utf-8")
            self._send(code, "application/json; charset=utf-8", body)

        def _params(self):
            qs = urllib.parse.urlsplit(self.path).query
            # last value wins, matching the flat-string grammar
            return {
                k: v[-1]
                for k, v in urllib.parse.parse_qs(
                    qs, keep_blank_values=True
                ).items()
            }

        def do_GET(self):  # noqa: N802 (http.server API)
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                rec = snapshot()
                text = metrics_lib.from_journal(rec).render_openmetrics()
                self._send(
                    200, OPENMETRICS_CONTENT_TYPE, text.encode("utf-8")
                )
            elif path == "/healthz":
                rec = snapshot()
                monitor = health_lib.HealthMonitor(rec)
                verdict = monitor.evaluate(record=False)
                body = (json.dumps(verdict, sort_keys=True) + "\n").encode(
                    "utf-8"
                )
                code = 503 if verdict["status"] == "ALERT" else 200
                self._send(code, "application/json; charset=utf-8", body)
            elif path == "/incidents" and incident_dir is not None:
                listing = incident_lib.list_bundles(incident_dir)
                body = (
                    json.dumps(
                        {"dir": incident_dir, "incidents": listing},
                        sort_keys=True,
                    )
                    + "\n"
                ).encode("utf-8")
                self._send(200, "application/json; charset=utf-8", body)
            elif path == "/query":
                try:
                    reply = query_lib.run_query(
                        events_source(), self._params()
                    )
                except query_lib.QueryError as e:
                    self._send_json(400, {"error": str(e)})
                    return
                self._send_json(200, reply)
            elif path == "/events":
                params = self._params()
                try:
                    cursor = params.get("cursor") or None
                    limit = int(params.get("limit", "256"))
                    timeout_s = float(params.get("timeout_s", "0"))
                    kind = params.get("kind") or None
                    deadline = time.monotonic() + min(timeout_s, 60.0)
                    while True:
                        rows = query_lib.rows_of(events_source())
                        if kind:
                            rows = query_lib.filter_rows(rows, kind=kind)
                        page = query_lib.events_page(
                            rows, cursor=cursor, limit=limit
                        )
                        if page["events"] or time.monotonic() >= deadline:
                            break
                        # long-poll: re-snapshot until new events land
                        # or the (capped) timeout expires
                        time.sleep(0.2)
                except (query_lib.QueryError, ValueError) as e:
                    self._send_json(400, {"error": str(e)})
                    return
                self._send_json(200, page)
            else:
                self._send(
                    404,
                    "text/plain; charset=utf-8",
                    b"try /metrics, /healthz, /incidents, /query or "
                    b"/events\n",
                )

        def log_message(self, fmt, *args):
            print("  " + fmt % args, file=sys.stderr)

    return Handler


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="mpi_grid_redistribute_tpu_torch.tools.metrics_serve",
        description="Serve /metrics (OpenMetrics) + /healthz over a "
        "telemetry journal."
    )
    p.add_argument(
        "--journal",
        action="append",
        default=[],
        metavar="FILE",
        help="JSONL journal shard (repeat for a pod merge); re-read on "
        "every scrape",
    )
    p.add_argument(
        "--align",
        choices=("wall", "start"),
        default="wall",
        help="multi-shard clock alignment (see aggregate.merge_journals)",
    )
    p.add_argument(
        "--store",
        metavar="DIR",
        help="durable journal-store root (telemetry/store.py); re-read "
        "when its MANIFEST.json changes",
    )
    p.add_argument(
        "--demo",
        action="store_true",
        help="serve a live in-process drift-loop journal",
    )
    p.add_argument(
        "--device", default=None,
        help="the --demo loop's device (default: the GPU, raising without "
             "one); 'cpu' runs the kernels' plain versions on the CPU",
    )
    p.add_argument(
        "--incident-dir",
        metavar="DIR",
        help="flight-recorder bundle root; enables GET /incidents "
        "(see telemetry/incident.py)",
    )
    p.add_argument("--port", type=int, default=9100,
                   help="0 = ephemeral (bound port is printed)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument(
        "--once",
        action="store_true",
        help="print one /metrics scrape + the /healthz verdict to "
        "stdout and exit (no server)",
    )
    args = p.parse_args(argv)

    sources = sum(
        (bool(args.journal), bool(args.store), bool(args.demo))
    )
    if sources == 0:
        p.error("need --journal FILE (repeatable), --store DIR or --demo")
    if sources > 1:
        p.error("--journal, --store and --demo are mutually exclusive")

    from mpi_grid_redistribute_tpu_torch.telemetry import health as health_lib
    from mpi_grid_redistribute_tpu_torch.telemetry import metrics as metrics_lib

    query_source = None
    if args.journal:
        snapshot, shutdown = journal_snapshotter(args.journal, args.align)
    elif args.store:
        snapshot, query_source, shutdown = store_snapshotter(args.store)
    else:
        snapshot, shutdown = demo_snapshotter(device=args.device)

    if args.once:
        try:
            rec = snapshot()
            sys.stdout.write(
                metrics_lib.from_journal(rec).render_openmetrics()
            )
            verdict = health_lib.HealthMonitor(rec).evaluate(record=False)
            print("healthz: " + json.dumps(verdict, sort_keys=True))
        finally:
            # --once must not leave the demo drive thread running behind
            # the printed scrape
            shutdown()
        return 0

    server = http.server.ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(
            snapshot,
            incident_dir=args.incident_dir,
            query_source=query_source,
        ),
    )
    host, port = server.server_address[:2]
    extra = " and /incidents" if args.incident_dir else ""
    print(f"serving http://{host}:{port}/metrics, /healthz, /query, "
          f"/events{extra} (Ctrl-C to stop)", flush=True)

    def _on_sigterm(signum, frame):
        # route SIGTERM through the KeyboardInterrupt path below so the
        # server closes and the snapshotter's stop event fires — a
        # killed scrape server must not strand its drive thread
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("stopped")
    finally:
        server.server_close()
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
