"""Telemetry query plane: filter / window / group over any journal (the
port's copy of the JAX package's ``telemetry/query.py``, the same grammar
and results).

One API over every event surface the stack produces — a live
:class:`~.recorder.StepRecorder`, a :class:`~.aggregate.MergedJournal`
pod view, a :class:`~.store.StoreReader` over durable segments, a JSONL
shard path, or any iterable of decoded rows. ``rows_of`` normalises
them all to envelope-ordered dict rows; the layers compose:

    rows   = rows_of(source)
    rows   = filter_rows(rows, kind="step_latency", step_min=1000)
    series = window_aggregate(rows, op="p99", window_s=5.0)
    groups = group_rows(rows, by="trace")

``run_query`` is the HTTP-facing entry: it takes the flat string
parameter dict ``GET /query`` parses (the grammar of the reference's
``telemetry/SCHEMA.md``) and returns a JSON-able result. ``events_page``
backs the cursor-resumable ``GET /events`` stream — the cursor is the
``host:pid:seq`` envelope triple, the exact total order
``aggregate.merge_journals`` sorts by, so a client that reconnects
resumes without loss or duplication.

Compacted stores stay first-class: ``store_window`` summary rows carry
histogram sketches on ``metrics.STEP_TIME_EDGES``, and the quantile ops
merge those sketches with raw ``step_latency`` samples in the same
:class:`~.metrics.Histogram`, so a p99 over a half-compacted range is
the p99 — not an approximation of one.

Host code only: the standard library and :mod:`.metrics` (and
:mod:`.store` for its sketches); neither torch nor numpy.
"""

# gridlint: scrape-path

from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Optional, Tuple

from mpi_grid_redistribute_tpu_torch.telemetry import metrics as metrics_lib

#: Envelope keys every normalised row carries (when the source had
#: them); everything else is event payload.
ENVELOPE = ("seq", "time", "kind", "host", "pid", "t_aligned")

#: ``op=`` values ``window_aggregate`` understands.
AGG_OPS = (
    "count",
    "rate",
    "sum",
    "mean",
    "min",
    "max",
    "p50",
    "p90",
    "p99",
    "ema",
)

#: ``by=`` values ``group_rows`` understands.
GROUP_KEYS = ("kind", "trace", "host", "pid", "vrank")


class QueryError(ValueError):
    """Malformed query parameters (bad op, bad number, unknown key).
    Maps to HTTP 400 on the ``/query`` endpoint."""


# --------------------------------------------------------------- rows


def _row_time(row: dict) -> float:
    t = row.get("t_aligned", row.get("time"))
    return float(t) if t is not None else 0.0


def _row_order(row: dict) -> Tuple[float, str, int, int]:
    # the merge_journals total order: aligned wall, then shard identity,
    # then the shard-local monotone seq
    return (
        _row_time(row),
        str(row.get("host", "")),
        int(row.get("pid", 0)),
        int(row.get("seq", 0)),
    )


def rows_of(source) -> List[dict]:
    """Normalise any journal source to a sorted list of decoded rows.

    Accepts a ``StepRecorder`` (events get the recorder's host/pid
    tags), a ``MergedJournal``, a ``StoreReader``, a JSONL path or open
    file, or an iterable of already-decoded dicts. Rows come back in
    ``(time, host, pid, seq)`` envelope order."""
    rows: List[dict]
    if hasattr(source, "events") and hasattr(source, "counts"):
        raw = source.events()
        rows = []
        tags = {}
        if hasattr(source, "host") and hasattr(source, "pid"):
            tags = {"host": source.host, "pid": source.pid}
        for e in raw:
            if isinstance(e, dict):
                rows.append(dict(e))
            else:  # recorder Event namedtuples
                rows.append(json.loads(e.to_json(tags)))
    elif isinstance(source, (str, bytes)) or hasattr(source, "read"):
        f = open(source, encoding="utf-8") if isinstance(
            source, (str, bytes)
        ) else source
        try:
            rows = [
                json.loads(ln)
                for ln in f
                if ln.strip()
            ]
        finally:
            if f is not source:
                f.close()
    else:
        rows = [dict(r) for r in source]
    rows.sort(key=_row_order)
    return rows


# ------------------------------------------------------------ filters


def _step_of(row: dict) -> Optional[int]:
    s = row.get("step", row.get("ctx_step"))
    if s is None and row.get("kind") == "store_window":
        s = row.get("step_min")
    return int(s) if s is not None else None


def filter_rows(
    rows: Iterable[dict],
    kind: Optional[str] = None,
    step_min: Optional[int] = None,
    step_max: Optional[int] = None,
    trace: Optional[str] = None,
    host: Optional[str] = None,
    pid: Optional[int] = None,
    since: Optional[float] = None,
    until: Optional[float] = None,
    ctx: Optional[Dict[str, str]] = None,
) -> List[dict]:
    """Filter by envelope and context fields. ``kind`` accepts a
    comma-separated set. Step bounds match the event's ``step`` payload
    or its ``ctx_step`` envelope (and a ``store_window``'s step span);
    rows with neither pass only when no step bound is set. ``ctx``
    matches arbitrary ``ctx_*`` fields by string equality."""
    kinds = set(kind.split(",")) if kind else None
    out = []
    for r in rows:
        if kinds is not None and r.get("kind") not in kinds:
            continue
        if host is not None and str(r.get("host")) != str(host):
            continue
        if pid is not None and int(r.get("pid", -1)) != int(pid):
            continue
        if trace is not None and str(r.get("ctx_trace")) != str(trace):
            continue
        if step_min is not None or step_max is not None:
            s = _step_of(r)
            s_hi = r.get("step_max", s) if r.get("kind") == "store_window" else s
            if s is None:
                continue
            if step_min is not None and (
                s_hi if s_hi is not None else s
            ) < step_min:
                continue
            if step_max is not None and s > step_max:
                continue
        t = _row_time(r)
        if since is not None and t < since:
            continue
        if until is not None and t > until:
            continue
        if ctx:
            ok = all(
                str(r.get(f"ctx_{k}", r.get(k))) == str(v)
                for k, v in ctx.items()
            )
            if not ok:
                continue
        out.append(r)
    return out


# ----------------------------------------------------------- group-by


def group_rows(rows: Iterable[dict], by: str) -> Dict[str, List[dict]]:
    """Partition rows by ``kind``/``trace``/``host``/``pid``/``vrank``.

    ``vrank`` explodes per-rank vector payloads (``sent_per_rank`` etc.
    on ``migrate_step`` rows) into one synthetic row per rank carrying
    ``vrank`` and the scalar slice — the per-rank drill-down the flow
    plane's imbalance attribution wants."""
    if by not in GROUP_KEYS:
        raise QueryError(f"unknown group key {by!r}; one of {GROUP_KEYS}")
    out: Dict[str, List[dict]] = {}
    if by == "vrank":
        for r in rows:
            vectors = {
                k: v
                for k, v in r.items()
                if k.endswith("_per_rank") and isinstance(v, (list, tuple))
            }
            if not vectors:
                continue
            n = max(len(v) for v in vectors.values())
            for rank in range(n):
                slice_row = {
                    k: v for k, v in r.items() if k not in vectors
                }
                slice_row["vrank"] = rank
                for k, v in vectors.items():
                    if rank < len(v):
                        slice_row[k[: -len("_per_rank")]] = v[rank]
                out.setdefault(str(rank), []).append(slice_row)
        return out
    key = {"trace": "ctx_trace"}.get(by, by)
    for r in rows:
        out.setdefault(str(r.get(key)), []).append(r)
    return out


# -------------------------------------------------------- aggregation


def _window_values(row: dict, field: str) -> List[float]:
    """Scalar samples a row contributes to a windowed aggregate over
    ``field``. ``store_window`` rows contribute their per-window
    totals/means for count-like fields (exactness preserved)."""
    if row.get("kind") == "store_window":
        if field == "seconds":
            return []  # quantile ops merge the sketch instead
        if field == "dropped":
            return [float(row.get("dropped", {}).get("total", 0))]
        v = row.get(field)
        return [float(v)] if isinstance(v, (int, float)) else []
    v = row.get(field)
    return [float(v)] if isinstance(v, (int, float)) else []


def _row_weight(row: dict) -> int:
    """How many source events a row stands for (summary rows compress
    many) — what ``count``/``rate`` windows sum."""
    if row.get("kind") == "store_window":
        return int(row.get("events", 1))
    return 1


def window_aggregate(
    rows: Iterable[dict],
    op: str = "count",
    field: str = "seconds",
    window_s: float = 10.0,
    ema_alpha: float = 0.3,
) -> List[dict]:
    """Bucket rows into fixed wall-clock windows and reduce each.

    Returns ``[{"t": window_start, "n": events, "value": reduced}]``
    sorted by time. Quantile ops (``p50``/``p90``/``p99``) build a
    ``metrics.Histogram`` on ``STEP_TIME_EDGES`` per window, merging
    ``store_window`` latency sketches with raw samples — the same
    bucketed upper-bound estimate ``/metrics`` readers compute. ``ema``
    smooths per-window means with ``ema_alpha``. ``rate`` is events per
    second (summary rows weighted by the events they compress)."""
    if op not in AGG_OPS:
        raise QueryError(f"unknown op {op!r}; one of {AGG_OPS}")
    if window_s <= 0:
        raise QueryError(f"window_s must be > 0, got {window_s}")
    rows = sorted(rows, key=_row_order)
    if not rows:
        return []
    t0 = _row_time(rows[0])
    buckets: Dict[int, List[dict]] = {}
    for r in rows:
        buckets.setdefault(int((_row_time(r) - t0) // window_s), []).append(r)
    out = []
    prev_ema: Optional[float] = None
    for i in sorted(buckets):
        group = buckets[i]
        n = sum(_row_weight(r) for r in group)
        value: Optional[float]
        if op in ("p50", "p90", "p99"):
            # exact-bucket quantile: raw samples observed, compacted
            # sketches merged — identical edges, identical answer
            from mpi_grid_redistribute_tpu_torch.telemetry import (
                store as store_lib,
            )

            h = metrics_lib.Histogram((), metrics_lib.STEP_TIME_EDGES)
            sketches = []
            for r in group:
                if r.get("kind") == "store_window":
                    key = "step_time" if field == "step_time" else "latency"
                    sketches.append(r.get(key))
                else:
                    for v in _window_values(r, field):
                        h.observe(v)
            merged = store_lib.sketch_to_histogram(sketches)
            for j, cnt in enumerate(merged._bucket_counts):
                h._bucket_counts[j] += cnt
            h._sum += merged._sum
            h._count += merged._count
            q = {"p50": 0.5, "p90": 0.9, "p99": 0.99}[op]
            value = h.quantile(q) if h.count else None
            if value is not None and math.isinf(value):
                value = None
            n = h.count if h.count else n
        else:
            vals: List[float] = []
            for r in group:
                vals.extend(_window_values(r, field))
            if op == "count":
                value = float(n)
            elif op == "rate":
                value = n / window_s
            elif op == "sum":
                value = sum(vals) if vals else 0.0
            elif op == "mean":
                value = sum(vals) / len(vals) if vals else None
            elif op == "min":
                value = min(vals) if vals else None
            elif op == "max":
                value = max(vals) if vals else None
            else:  # ema
                mean = sum(vals) / len(vals) if vals else None
                if mean is None:
                    value = prev_ema
                elif prev_ema is None:
                    value = prev_ema = mean
                else:
                    value = prev_ema = (
                        ema_alpha * mean + (1.0 - ema_alpha) * prev_ema
                    )
        out.append({"t": t0 + i * window_s, "n": n, "value": value})
    return out


# ------------------------------------------------------------ cursors


def cursor_of(row: dict) -> str:
    """Opaque-but-stable resume token: the ``host:pid:seq`` envelope
    triple — the same total order the pod merge sorts by."""
    return f"{row.get('host', '')}:{row.get('pid', 0)}:{row.get('seq', 0)}"


def parse_cursor(cursor: str) -> Tuple[str, int, int]:
    try:
        host, pid, seq = cursor.rsplit(":", 2)
        return host, int(pid), int(seq)
    except ValueError as e:
        raise QueryError(f"bad cursor {cursor!r}: {e}") from e


def after_cursor(rows: List[dict], cursor: Optional[str]) -> List[dict]:
    """Rows strictly after ``cursor`` in envelope order. An exact match
    resumes positionally; a cursor whose exact row has been evicted or
    compacted resumes at the first row of the same ``host:pid`` shard
    with a larger ``seq`` (no duplicates, bounded loss — the shard's
    monotone seq makes this safe); an unknown shard replays all rows."""
    if not cursor:
        return list(rows)
    host, pid, seq = parse_cursor(cursor)
    for i, r in enumerate(rows):
        if (
            str(r.get("host", "")) == host
            and int(r.get("pid", 0)) == pid
            and int(r.get("seq", 0)) == seq
        ):
            return rows[i + 1:]
    # exact row gone: positional fallback within the shard's seq order
    for i, r in enumerate(rows):
        if (
            str(r.get("host", "")) == host
            and int(r.get("pid", 0)) == pid
            and int(r.get("seq", 0)) > seq
        ):
            return rows[i:]
    known = any(
        str(r.get("host", "")) == host and int(r.get("pid", 0)) == pid
        for r in rows
    )
    return [] if known else list(rows)


def events_page(
    rows: List[dict],
    cursor: Optional[str] = None,
    limit: int = 256,
) -> dict:
    """One ``GET /events`` page: up to ``limit`` rows after ``cursor``
    plus the cursor to resume from. ``cursor`` in the reply always
    advances (it echoes the input when no rows are ready), so a client
    can long-poll in a loop with no state beyond the last reply."""
    if limit < 1:
        raise QueryError(f"limit must be >= 1, got {limit}")
    pending = after_cursor(rows, cursor)
    page = pending[:limit]
    next_cursor = cursor_of(page[-1]) if page else (cursor or "")
    return {
        "events": page,
        "cursor": next_cursor,
        "remaining": len(pending) - len(page),
    }


# ------------------------------------------------------- HTTP grammar

_INT_PARAMS = ("step_min", "step_max", "pid", "limit")
_FLOAT_PARAMS = ("since", "until", "window_s", "ema_alpha")


def run_query(source, params: Dict[str, str]) -> dict:
    """Execute the flat-string parameter grammar ``GET /query`` parses
    (the reference's ``telemetry/SCHEMA.md``, "Query parameter
    grammar") and return a JSON-able reply.

    Filters: ``kind``, ``step_min``/``step_max``, ``trace``, ``host``,
    ``pid``, ``since``/``until``, ``ctx.<field>=<value>``. Shapes:
    ``agg=<op>`` (+ ``field``, ``window_s``, ``ema_alpha``) for a
    windowed series, ``by=<key>`` for grouped counts, neither for the
    matching rows (capped by ``limit``, newest kept)."""
    params = dict(params)
    ctx = {
        k[len("ctx."):]: params.pop(k)
        for k in list(params)
        if k.startswith("ctx.")
    }
    parsed: Dict[str, object] = {}
    for k, v in params.items():
        if k in _INT_PARAMS:
            try:
                parsed[k] = int(v)
            except ValueError as e:
                raise QueryError(f"bad integer for {k}: {v!r}") from e
        elif k in _FLOAT_PARAMS:
            try:
                parsed[k] = float(v)
            except ValueError as e:
                raise QueryError(f"bad number for {k}: {v!r}") from e
        elif k in ("kind", "trace", "host", "agg", "by", "field", "cursor"):
            parsed[k] = v
        else:
            raise QueryError(f"unknown query parameter {k!r}")
    rows = filter_rows(
        rows_of(source),
        kind=parsed.get("kind"),
        step_min=parsed.get("step_min"),
        step_max=parsed.get("step_max"),
        trace=parsed.get("trace"),
        host=parsed.get("host"),
        pid=parsed.get("pid"),
        since=parsed.get("since"),
        until=parsed.get("until"),
        ctx=ctx or None,
    )
    reply: Dict[str, object] = {"matched": len(rows)}
    if "agg" in parsed:
        reply["series"] = window_aggregate(
            rows,
            op=str(parsed["agg"]),
            field=str(parsed.get("field", "seconds")),
            window_s=float(parsed.get("window_s", 10.0)),
            ema_alpha=float(parsed.get("ema_alpha", 0.3)),
        )
    elif "by" in parsed:
        groups = group_rows(rows, by=str(parsed["by"]))
        reply["groups"] = {k: len(v) for k, v in sorted(groups.items())}
    else:
        limit = int(parsed.get("limit", 256))
        if limit < 1:
            raise QueryError(f"limit must be >= 1, got {limit}")
        reply["events"] = rows[-limit:]
    return reply
