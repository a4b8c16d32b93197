"""Durable telemetry history: segmented on-disk journal store (the port's
copy of the JAX package's ``telemetry/store.py``: the same segments,
manifest and summary rows, byte for byte).

The :class:`~.recorder.StepRecorder` ring is deliberately bounded — old
events evict, journal shards die with the process, and the only thing
that survives a long run is the all-time per-kind counters. This module
is the layer that makes the journal *durable*: a
:class:`JournalStore` is a recorder **sink** — the service driver
drains the ring into it at chunk/health boundaries (never inside the
chunk; the same rule every other host hook keeps), and the store turns those drains into an append-only sequence
of on-disk **segments** with a checksummed manifest:

* **Segments** — JSONL files (the exact ``StepRecorder.to_jsonl`` line
  format, ``host``/``pid``-tagged) rotated on event count or byte size.
  Closed segments are immutable and carry a sha256 in the manifest.
* **Manifest** — one ``MANIFEST.json`` per store, published with the
  ``utils/checkpoint.py`` staged-rename idiom (write to a
  ``.tmp-<pid>`` sibling, fsync, atomic ``os.rename``): a reader either
  sees the previous complete manifest or the new complete one, never a
  torn mix. It carries the recorder's **exact all-time counts**, now
  durable: the counts survive ring eviction, segment retention AND
  process death.
* **Retention** — oldest closed segments are deleted when the store
  exceeds its byte budget or a segment ages out; their per-kind counts
  are folded into a ``retired`` tally so the count ledger stays exact.
* **Compaction** — closed raw segments are downsampled into summary
  segments: the per-step flood (``step_latency`` / ``step_time`` /
  ``migrate_step`` / ``fast_path`` / ``redistribute`` /
  ``flow_snapshot`` / ``state_health``) collapses into one
  ``store_window`` row per window carrying *exact* per-kind counts,
  step-latency/step-time histogram sketches on the metrics plane's own
  pow2 edges (``metrics.STEP_TIME_EDGES`` — so a quantile computed
  from a compacted store equals the one ``/metrics`` serves),
  dropped/mover totals, flow-imbalance samples and state-health
  corrupt-row totals, while every non-step event (alerts, incidents,
  snapshots, restores, faults, …) is preserved **verbatim**. A
  million-step run keeps bounded disk and exact all-time counts.

Every drain journals a ``store_drain`` event into the recorder it
drains — recorded *before* the snapshot is taken, so the drained
segment describes itself.

:class:`StoreReader` is the read side: ``events()`` yields the decoded
rows of every retained segment in order and ``counts()`` returns the
manifest's exact all-time totals, so a reader plugs straight into
``metrics.from_journal`` / ``query.rows_of`` / ``merge_journals``.

Host code only: the standard library and :mod:`.metrics`. It imports
neither torch nor numpy, so a drain never touches the device.
"""

# gridlint: scrape-path

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Dict, List, Optional

from mpi_grid_redistribute_tpu_torch.telemetry import metrics as metrics_lib

_MANIFEST = "MANIFEST.json"
_TMP_TAG = ".tmp-"
_SEG_PREFIX = "seg_"
_RAW_SUFFIX = ".jsonl"
_SUMMARY_SUFFIX = ".summary.jsonl"

#: Per-step event kinds compaction downsamples into ``store_window``
#: rows. Everything else (alerts, incidents, snapshots, restores,
#: faults, restarts, …) is operator-facing and preserved verbatim.
COMPACT_KINDS = frozenset(
    (
        "step_latency",
        "step_time",
        "migrate_step",
        "fast_path",
        "redistribute",
        "flow_snapshot",
        "state_health",
    )
)

#: Flow-imbalance samples kept per summary window (first/last plus the
#: extremes — enough to redraw the imbalance envelope per window).
_IMBALANCE_SAMPLES = 8


class StoreCorruptError(RuntimeError):
    """A store failed integrity checks: torn segment, checksum
    mismatch, or an unreadable manifest. ``member`` names the offending
    file (``MANIFEST.json`` when the manifest itself is bad)."""

    def __init__(self, root: str, member: str, detail: str):
        self.root = root
        self.member = member
        self.detail = detail
        super().__init__(
            f"corrupt journal store {root!r} ({member}): {detail}"
        )


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _merge_counts(into: Dict[str, int], add: Dict[str, int]) -> None:
    for k, n in add.items():
        into[k] = into.get(k, 0) + int(n)


def _sketch() -> dict:
    """Empty histogram sketch on the metrics plane's step-time edges:
    one slot per finite edge plus the +Inf overflow slot — the same
    layout ``metrics.Histogram`` keeps, so bucket counts merge 1:1."""
    return {
        "buckets": [0] * (len(metrics_lib.STEP_TIME_EDGES) + 1),
        "sum": 0.0,
        "count": 0,
    }


def _sketch_observe(sk: dict, value: float) -> None:
    v = float(value)
    sk["sum"] += v
    sk["count"] += 1
    for i, edge in enumerate(metrics_lib.STEP_TIME_EDGES):
        if v <= edge:
            sk["buckets"][i] += 1
            return
    sk["buckets"][-1] += 1


def sketch_to_histogram(sketches) -> metrics_lib.Histogram:
    """Merge ``store_window`` latency/step-time sketches into one
    ``metrics.Histogram`` on ``STEP_TIME_EDGES`` — the exact histogram
    a live recorder fed the same samples would have built, so
    ``quantile()`` answers match ``/metrics`` bucket-for-bucket."""
    h = metrics_lib.Histogram((), metrics_lib.STEP_TIME_EDGES)
    for sk in sketches:
        if not sk or not sk.get("count"):
            continue
        for i, n in enumerate(sk["buckets"]):
            h._bucket_counts[i] += int(n)
        h._sum += float(sk["sum"])
        h._count += int(sk["count"])
    return h


class JournalStore:
    """Write side: an append-only segmented store, drained from a live
    :class:`~.recorder.StepRecorder`.

    One store root has ONE writer (the service driver's loop thread);
    a restarted driver re-opens the same root and resumes
    from the manifest's drain watermark, so supervisor restarts never
    duplicate events. Readers (:class:`StoreReader`, the ``metrics_serve``
    tool) only ever see atomically-published manifests.
    """

    def __init__(
        self,
        root: str,
        segment_events: int = 4096,
        segment_bytes: int = 4 << 20,
        retain_bytes: int = 64 << 20,
        retain_age_s: float = 0.0,
        compact_after: int = 2,
        compact_window: int = 256,
    ):
        if segment_events < 1:
            raise ValueError(
                f"segment_events must be >= 1, got {segment_events}"
            )
        if compact_window < 1:
            raise ValueError(
                f"compact_window must be >= 1, got {compact_window}"
            )
        self.root = str(root)
        self.segment_events = int(segment_events)
        self.segment_bytes = int(segment_bytes)
        self.retain_bytes = int(retain_bytes)
        self.retain_age_s = float(retain_age_s)
        self.compact_after = int(compact_after)
        self.compact_window = int(compact_window)
        os.makedirs(self.root, exist_ok=True)
        man = self._load_manifest()
        if man is None:
            man = {
                "version": 1,
                "created": time.time(),
                "updated": time.time(),
                "writer": None,
                "drained_seq": 0,
                "drains": 0,
                # exact all-time per-kind counts: the recorder's own
                # counter snapshot at the latest drain
                "counts": {},
                # per-kind events the ring evicted BETWEEN drains (never
                # persisted; the gap between counts and segment sums)
                "missed": {},
                # per-kind counts folded out of retention-deleted
                # segments (the events are gone, the ledger is not)
                "retired": {"segments": 0, "bytes": 0, "counts": {}},
                "segments": [],
                "active": None,
                "config": {
                    "segment_events": self.segment_events,
                    "segment_bytes": self.segment_bytes,
                    "retain_bytes": self.retain_bytes,
                    "retain_age_s": self.retain_age_s,
                    "compact_after": self.compact_after,
                    "compact_window": self.compact_window,
                },
            }
        self._man = man

    # ------------------------------------------------------- manifest

    def _load_manifest(self) -> Optional[dict]:
        path = os.path.join(self.root, _MANIFEST)
        if not os.path.exists(path):
            return None
        try:
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise StoreCorruptError(self.root, _MANIFEST, str(e)) from e

    def _publish_manifest(self) -> None:
        # the checkpoint.py staged-rename idiom, file-shaped: stage in a
        # .tmp-<pid> sibling, fsync, then one atomic os.rename — a
        # reader sees the previous complete manifest or this one, never
        # a torn mix
        self._man["updated"] = time.time()
        path = os.path.join(self.root, _MANIFEST)
        tmp = f"{path}{_TMP_TAG}{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self._man, f, indent=1, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)

    # ---------------------------------------------------------- drain

    def drain(self, recorder) -> int:
        """Append every retained event newer than the drain watermark;
        publish the manifest. Returns the number of events persisted.

        The drain journals itself FIRST (``store_drain``, before the
        snapshot is taken), so the persisted window includes its own
        drain event and the manifest's count snapshot equals the live
        recorder's counts at the drain instant — the property the
        counts-exactness test pins end to end. Events the ring evicted
        between drains are impossible to persist; their per-kind counts
        land in the manifest's ``missed`` ledger instead of vanishing.
        """
        man = self._man
        active = self._ensure_active(recorder)
        recorder.record(
            "store_drain",
            segment=active["name"],
            after_seq=int(man["drained_seq"]),
        )
        # snapshot order matters: events first, then counts — counts
        # taken after can only be >= what the window shows, so the
        # missed ledger never under-counts (clamped at 0 per kind)
        events = recorder.events()
        counts = recorder.counts()
        # All-time counts are monotone for any recorder that has been
        # draining into this store; a per-kind regression proves a NEW
        # recorder incarnation whose seq space restarts below the
        # watermark — its events would be silently skipped and then
        # booked as missed. Refuse loudly instead of losing data.
        regressed = {
            k: (int(man["counts"][k]), int(counts.get(k, 0)))
            for k in man["counts"]
            if int(counts.get(k, 0)) < int(man["counts"][k])
        }
        if regressed:
            raise ValueError(
                "store drain: recorder all-time counts regressed vs the "
                f"manifest at {self.root} ({regressed}; manifest, "
                "recorder) — this recorder is a different incarnation "
                "from the store's writer. Resume with the original "
                "recorder (or one rebuilt via StoreReader.to_recorder), "
                "or start a fresh store directory."
            )
        tags = {"host": recorder.host, "pid": recorder.pid}
        watermark = int(man["drained_seq"])
        new = [e for e in events if e.seq > watermark]
        if new:
            seg_path = os.path.join(self.root, active["name"])
            with open(seg_path, "a", encoding="utf-8") as f:
                for e in new:
                    f.write(e.to_json(tags) + "\n")
                f.flush()
                os.fsync(f.fileno())
            active["events"] += len(new)
            active["bytes"] = os.path.getsize(seg_path)
            active["seq_min"] = (
                min(active["seq_min"], new[0].seq)
                if active["seq_min"] is not None
                else new[0].seq
            )
            active["seq_max"] = new[-1].seq
            active["time_min"] = (
                min(active["time_min"], new[0].time)
                if active["time_min"] is not None
                else new[0].time
            )
            active["time_max"] = new[-1].time
            for e in new:
                active["counts"][e.kind] = (
                    active["counts"].get(e.kind, 0) + 1
                )
            man["drained_seq"] = new[-1].seq
        # missed ledger: counts delta not covered by persisted events
        prev = man["counts"]
        stored: Dict[str, int] = {}
        for e in new:
            stored[e.kind] = stored.get(e.kind, 0) + 1
        for kind, total in counts.items():
            gap = (
                int(total) - int(prev.get(kind, 0)) - stored.get(kind, 0)
            )
            if gap > 0:
                man["missed"][kind] = man["missed"].get(kind, 0) + gap
        man["counts"] = dict(counts)
        man["writer"] = {"host": recorder.host, "pid": recorder.pid}
        man["drains"] = int(man.get("drains", 0)) + 1
        if (
            active["events"] >= self.segment_events
            or active["bytes"] >= self.segment_bytes
        ):
            self._rotate()
        self._publish_manifest()
        self.compact()
        self.retention()
        return len(new)

    def _ensure_active(self, recorder) -> dict:
        man = self._man
        if man["active"] is None:
            idx = len(man["segments"]) + man["retired"]["segments"]
            # segment numbering never reuses a retired slot: names stay
            # globally ordered across the store's whole life
            existing = [
                int(s["name"][len(_SEG_PREFIX):][:8])
                for s in man["segments"]
            ]
            if existing:
                idx = max(idx, max(existing) + 1)
            man["active"] = {
                "name": f"{_SEG_PREFIX}{idx:08d}{_RAW_SUFFIX}",
                "events": 0,
                "bytes": 0,
                "seq_min": None,
                "seq_max": None,
                "time_min": None,
                "time_max": None,
                "counts": {},
            }
        return man["active"]

    def _rotate(self) -> None:
        """Close the active segment: checksum it and move it to the
        closed list. The sha256 is computed over the final bytes —
        immutable from here on (:meth:`StoreReader.verify` re-checks it)."""
        man = self._man
        active = man["active"]
        if active is None or active["events"] == 0:
            man["active"] = None
            return
        path = os.path.join(self.root, active["name"])
        entry = dict(active)
        entry["kind"] = "raw"
        entry["sha256"] = _sha256_file(path)
        entry["closed"] = time.time()
        man["segments"].append(entry)
        man["active"] = None

    # ----------------------------------------------------- compaction

    def compact(self, keep_raw: Optional[int] = None) -> int:
        """Downsample closed raw segments into summary segments,
        keeping the newest ``keep_raw`` (default ``compact_after``) raw.
        Returns the number of segments compacted.

        Each summary preserves non-step events verbatim and collapses
        the per-step kinds into ``store_window`` rows (exact per-kind
        counts, latency/step-time sketches on ``STEP_TIME_EDGES``,
        dropped/mover totals, flow-imbalance samples). The summary is
        fully written and checksummed, the manifest republished, and
        only then is the raw file removed — a crash between the two
        leaves a harmless orphan, never a hole.
        """
        keep = self.compact_after if keep_raw is None else int(keep_raw)
        man = self._man
        raw = [s for s in man["segments"] if s["kind"] == "raw"]
        todo = raw[: max(0, len(raw) - keep)]
        done = 0
        for entry in todo:
            summary = self._compact_segment(entry)
            i = man["segments"].index(entry)
            man["segments"][i] = summary
            self._publish_manifest()
            os.remove(os.path.join(self.root, entry["name"]))
            done += 1
        return done

    def _compact_segment(self, entry: dict) -> dict:
        src = os.path.join(self.root, entry["name"])
        rows: List[dict] = []
        with open(src, encoding="utf-8") as f:
            for ln in f:
                ln = ln.strip()
                if ln:
                    rows.append(json.loads(ln))
        out_name = entry["name"][: -len(_RAW_SUFFIX)] + _SUMMARY_SUFFIX
        out_path = os.path.join(self.root, out_name)
        windows = 0
        counts: Dict[str, int] = {}
        with open(out_path, "w", encoding="utf-8") as f:
            window: List[dict] = []
            for r in rows:
                counts[r["kind"]] = counts.get(r["kind"], 0) + 1
                if r["kind"] in COMPACT_KINDS:
                    window.append(r)
                    if len(window) >= self.compact_window:
                        f.write(self._window_row(window) + "\n")
                        windows += 1
                        window = []
                else:
                    # verbatim: alerts, incidents, snapshots, restores,
                    # faults, restarts, store_drain, … keep every byte
                    f.write(json.dumps(r, sort_keys=True) + "\n")
            if window:
                f.write(self._window_row(window) + "\n")
                windows += 1
            f.flush()
            os.fsync(f.fileno())
        summary = {
            "name": out_name,
            "kind": "summary",
            "source": entry["name"],
            "source_sha256": entry["sha256"],
            "events": entry["events"],
            "bytes": os.path.getsize(out_path),
            "seq_min": entry["seq_min"],
            "seq_max": entry["seq_max"],
            "time_min": entry["time_min"],
            "time_max": entry["time_max"],
            "counts": counts,
            "windows": windows,
            "sha256": _sha256_file(out_path),
            "closed": entry.get("closed"),
            "compacted": time.time(),
        }
        return summary

    @staticmethod
    def _window_row(window: List[dict]) -> str:
        """One ``store_window`` summary row for a run of per-step
        events: exact per-kind counts, histogram sketches on the
        metrics plane's edges, totals, and flow-imbalance samples
        (the reference's ``telemetry/SCHEMA.md``)."""
        counts: Dict[str, int] = {}
        latency = _sketch()
        step_time = _sketch()
        dropped_total = 0
        dropped_max = 0
        fp_taken = 0
        fp_total = 0
        movers_max = 0
        migrate = {"sent": 0, "received": 0, "dropped_recv": 0}
        backlog_last = None
        population_last = None
        state = {"nan_pos": 0, "nan_vel": 0, "oob": 0}
        state_live_last = None
        state_residual_last = None
        saw_state = False
        step_min = None
        step_max = None
        imbalance: List[List[float]] = []
        for r in window:
            kind = r["kind"]
            counts[kind] = counts.get(kind, 0) + 1
            step = r.get("step")
            if step is not None:
                step_min = step if step_min is None else min(step_min, step)
                step_max = step if step_max is None else max(step_max, step)
            if kind == "step_latency":
                if "seconds" in r:
                    _sketch_observe(latency, r["seconds"])
                d = int(r.get("dropped", 0))
                dropped_total += d
                dropped_max = max(dropped_max, d)
            elif kind == "step_time":
                if "seconds" in r:
                    _sketch_observe(step_time, r["seconds"])
            elif kind == "fast_path":
                fp_total += 1
                fp_taken += int(r.get("taken", 0))
                movers_max = max(movers_max, int(r.get("movers", 0)))
            elif kind == "migrate_step":
                for key in migrate:
                    migrate[key] += int(r.get(key, 0))
                if "backlog" in r:
                    backlog_last = int(r["backlog"])
                if "population" in r:
                    population_last = int(r["population"])
            elif kind == "flow_snapshot":
                if "imbalance" in r:
                    imbalance.append(
                        [float(r.get("time", 0.0)), float(r["imbalance"])]
                    )
            elif kind == "state_health":
                saw_state = True
                for key in state:
                    state[key] += int(r.get(key, 0))
                if "live" in r:
                    state_live_last = int(r["live"])
                if "residual" in r:
                    state_residual_last = int(r["residual"])
        if len(imbalance) > _IMBALANCE_SAMPLES:
            # keep first/last and the extremes: enough to redraw the
            # per-window imbalance envelope without the full series
            by_val = sorted(imbalance[1:-1], key=lambda s: s[1])
            keep = (
                [imbalance[0]]
                + by_val[: (_IMBALANCE_SAMPLES - 2) // 2]
                + by_val[-((_IMBALANCE_SAMPLES - 2) // 2):]
                + [imbalance[-1]]
            )
            imbalance = sorted(keep, key=lambda s: s[0])
        doc = {
            "kind": "store_window",
            "seq": window[0].get("seq"),
            "seq_max": window[-1].get("seq"),
            "time": window[0].get("time"),
            "time_max": window[-1].get("time"),
            "host": window[0].get("host"),
            "pid": window[0].get("pid"),
            "events": len(window),
            "counts": counts,
            "latency": latency,
            "step_time": step_time,
            "dropped": {"total": dropped_total, "max": dropped_max},
            "fast_path": {
                "taken": fp_taken,
                "total": fp_total,
                "movers_max": movers_max,
            },
            "migrate": dict(
                migrate,
                backlog_last=backlog_last,
                population_last=population_last,
            ),
            "imbalance": imbalance,
        }
        if saw_state:
            # corrupt-row totals are exact across compaction; the
            # latest ledger gauges ride along so grid_state_live_rows /
            # grid_state_residual survive the raw rows' deletion
            doc["state"] = dict(
                state,
                live_last=state_live_last,
                residual_last=state_residual_last,
            )
        if step_min is not None:
            doc["step_min"] = step_min
            doc["step_max"] = step_max
        return json.dumps(doc, sort_keys=True)

    # ------------------------------------------------------ retention

    def retention(self) -> int:
        """Delete oldest closed segments over the byte budget (or past
        ``retain_age_s``); fold their counts into the ``retired``
        ledger. Returns segments deleted. The manifest's all-time
        ``counts`` are a recorder snapshot, so exactness is unaffected
        — retention trades *detail* for disk, never totals."""
        man = self._man
        deleted = 0
        now = time.time()
        while man["segments"]:
            total = sum(s["bytes"] for s in man["segments"])
            oldest = man["segments"][0]
            over_bytes = total > self.retain_bytes
            over_age = (
                self.retain_age_s > 0
                and oldest.get("time_max") is not None
                and now - oldest["time_max"] > self.retain_age_s
            )
            if not (over_bytes or over_age):
                break
            man["segments"].pop(0)
            man["retired"]["segments"] += 1
            man["retired"]["bytes"] += oldest["bytes"]
            _merge_counts(man["retired"]["counts"], oldest["counts"])
            self._publish_manifest()
            path = os.path.join(self.root, oldest["name"])
            if os.path.exists(path):
                os.remove(path)
            deleted += 1
        return deleted

    # ---------------------------------------------------------- close

    def close(self, recorder=None) -> None:
        """Orderly shutdown: final drain (when given the recorder),
        close the active segment, compact, enforce retention, publish."""
        if recorder is not None:
            self.drain(recorder)
        self._rotate()
        self._publish_manifest()
        self.compact()
        self.retention()

    # -------------------------------------------------------- queries

    @property
    def manifest(self) -> dict:
        return self._man

    def reader(self) -> "StoreReader":
        return StoreReader(self.root)


class StoreReader:
    """Read side: decoded event rows + exact all-time counts.

    Duck-compatible with the journal sources ``metrics.from_journal``
    and ``query.rows_of`` accept (``events()`` + ``counts()``), so the
    whole single-process observability stack runs over a store on disk
    the same way it runs over a live ring."""

    def __init__(self, root: str, verify: bool = False):
        self.root = str(root)
        path = os.path.join(self.root, _MANIFEST)
        try:
            with open(path, encoding="utf-8") as f:
                self._man = json.load(f)
        except (OSError, ValueError) as e:
            raise StoreCorruptError(self.root, _MANIFEST, str(e)) from e
        for key in ("counts", "segments"):
            if key not in self._man:
                raise StoreCorruptError(
                    self.root, _MANIFEST, f"missing manifest key {key!r}"
                )
        if verify:
            self.verify()

    @property
    def manifest(self) -> dict:
        return self._man

    def verify(self) -> None:
        """Checksum every closed segment against the manifest; raise
        :class:`StoreCorruptError` naming the first bad one."""
        for seg in self._man["segments"]:
            path = os.path.join(self.root, seg["name"])
            if not os.path.exists(path):
                raise StoreCorruptError(
                    self.root, seg["name"], "segment file missing"
                )
            got = _sha256_file(path)
            if got != seg["sha256"]:
                raise StoreCorruptError(
                    self.root,
                    seg["name"],
                    f"sha256 mismatch: manifest {seg['sha256'][:12]}…, "
                    f"file {got[:12]}…",
                )

    def _segment_files(self) -> List[str]:
        names = [s["name"] for s in self._man["segments"]]
        active = self._man.get("active")
        if active is not None:
            names.append(active["name"])
        return names

    def events(self, kind: Optional[str] = None) -> List[dict]:
        """Every retained row (verbatim events AND ``store_window``
        summaries), decoded, in store order; optionally filtered by
        kind. Rows keep their full envelope (``seq``/``time``/``host``/
        ``pid``)."""
        rows: List[dict] = []
        for name in self._segment_files():
            path = os.path.join(self.root, name)
            if not os.path.exists(path):
                continue
            with open(path, encoding="utf-8") as f:
                for ln in f:
                    ln = ln.strip()
                    if not ln:
                        continue
                    try:
                        d = json.loads(ln)
                    except ValueError as e:
                        raise StoreCorruptError(
                            self.root, name, f"bad JSONL line: {e}"
                        ) from e
                    if kind is None or d.get("kind") == kind:
                        rows.append(d)
        return rows

    def counts(self) -> Dict[str, int]:
        """Exact all-time per-kind counts — the recorder's own counter
        snapshot at the last drain. Survives ring eviction, segment
        retention and compaction (the store's reason to exist)."""
        return dict(self._man["counts"])

    def latency_histogram(self) -> metrics_lib.Histogram:
        """One merged step-latency histogram over the whole retained
        store: raw ``step_latency`` rows observed directly, compacted
        windows merged sketch-for-sketch — both on ``STEP_TIME_EDGES``,
        so the answer equals a live histogram fed the same samples."""
        h = metrics_lib.Histogram((), metrics_lib.STEP_TIME_EDGES)
        sketches = []
        for r in self.events():
            if r.get("kind") == "step_latency" and "seconds" in r:
                h.observe(float(r["seconds"]))
            elif r.get("kind") == "store_window":
                sketches.append(r.get("latency"))
        merged = sketch_to_histogram(sketches)
        for i, n in enumerate(merged._bucket_counts):
            h._bucket_counts[i] += n
        h._sum += merged._sum
        h._count += merged._count
        return h

    def to_recorder(self, capacity: Optional[int] = None):
        """Replay the retained rows into a fresh ``StepRecorder`` (host
        tag ``"store"``) and pin its all-time counters to the
        manifest's exact totals, so ``HealthMonitor`` / ``from_journal``
        over the replay see the same counts the live run had. The
        replay is single-threaded construction — the counter overwrite
        happens before the recorder is shared anywhere."""
        from mpi_grid_redistribute_tpu_torch.telemetry import (
            recorder as recorder_lib,
        )

        rows = [r for r in self.events() if r.get("kind") != "store_window"]
        cap = capacity if capacity is not None else max(4096, 2 * len(rows))
        rec = recorder_lib.StepRecorder(capacity=cap, host="store", pid=0)
        for r in rows:
            d = {
                k: v
                for k, v in r.items()
                if k not in ("seq", "time", "kind")
            }
            rec.record_at(r["kind"], r.get("time"), **d)
        with rec._lock:
            rec._counts.clear()
            rec._counts.update(
                {k: int(v) for k, v in self._man["counts"].items()}
            )
        return rec


def is_store(root: str) -> bool:
    """True when ``root`` looks like a journal store (has a manifest)."""
    return os.path.isfile(os.path.join(root, _MANIFEST))


def list_stores(root: str) -> List[str]:
    """Store roots anywhere under ``root`` (including ``root`` itself),
    sorted by manifest mtime, newest first (a run index). Descent stops at each store found (segments
    are never themselves stores), so run layouts like
    ``runs/<run>/store`` index at any nesting depth."""
    out = []
    for dirpath, dirnames, _ in os.walk(root):
        if is_store(dirpath):
            out.append(dirpath)
            dirnames[:] = []
        else:
            dirnames.sort()
    out.sort(
        key=lambda p: os.stat(os.path.join(p, _MANIFEST)).st_mtime_ns,
        reverse=True,
    )
    return out


def wipe(root: str) -> None:
    """Remove a store directory (tests / demo teardown)."""
    shutil.rmtree(root, ignore_errors=True)
