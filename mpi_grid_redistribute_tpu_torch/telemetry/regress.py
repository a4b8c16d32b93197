"""Bench regression guard: min-of-k timing protocol + history comparison
(the port's copy of the JAX package's ``telemetry/regress.py``: the same
guarded metrics, labels and report lines, over the port's captures).

* :func:`min_of_k`: the timing protocol. k independent estimates from an
  already-built measurement, keep the min (noise on a quiet machine is
  one-sided: interference only ever ADDS time) and report the spread
  ``(max - min)/min``, so a capture carries its own noise floor.
* :func:`check_capture`: the hard gate. Compare a capture against a
  history and fail when a guarded metric is more than ``threshold``
  worse than the BEST historical value (best, not latest: a drift of
  sub-threshold regressions must not ratchet the reference down).
* :func:`classify_capture`: the noise-aware layer. Each delta is labeled
  ``OK`` / ``WOBBLE`` / ``WARN`` / ``REGRESSION`` against a per-metric
  noise floor from the captures' own ``timing_spread``; only
  REGRESSION fails the gate.
* :func:`env_fingerprint`: the machine a capture ran on (python, numpy,
  torch and its CUDA, the device and its count, the card's name and
  power limit from ``nvidia-smi``, the host CPU). The classifier notes
  fingerprint drift against the best capture, because "the machine
  changed" is the most common non-regression explanation for a WARN.

CLI (``python -m mpi_grid_redistribute_tpu_torch.tools.bench_check``)::

    python -m mpi_grid_redistribute_tpu_torch.tools.bench_check \\
        --history 'captures/*.json' [--current CAPTURE.json] \\
        [--threshold 0.10] [--legacy]

``--history`` is required: the repo's committed ``BENCH_r*.json`` are
TPU captures of the reference, and a card's capture is never held
against them. A history whose captures come from another stack (their
``env`` has no ``torch`` key, or none at all) is refused (exit 2).
With no ``--current`` the newest history capture is checked against
the rest.

This module imports neither torch nor numpy at module level
(:func:`env_fingerprint` probes them when called).
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import platform as _platform
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# Metrics the gate watches: name -> direction. "higher" fails when the
# current value drops below best*(1-threshold); "lower" (times and wire
# bytes) fails when it rises above best*(1+threshold). A metric missing
# from either side is skipped, so a new one arms once it has history.
GUARDED_METRICS: Dict[str, str] = {
    "value": "higher",        # particles/sec/chip: the headline
    "ms_per_step": "lower",
    "exchange_bytes_per_sec": "higher",
    # achieved fraction of the exchange domain's roof
    "exchange_bw_util": "higher",
    # the full-reshuffle stress capture's utilization (config 7)
    "stress_bw_util": "higher",
    # the service soak's throughput with snapshots on (config 8)
    "soak_pps": "higher",
    # scheduled canonical-exchange wire bytes per step
    "exchange_wire_bytes_per_step": "lower",
    # the two-level schedule's cross-pod and intra-pod wire (config 4)
    "exchange_dcn_bytes_per_step": "lower",
    "exchange_ici_bytes_per_step": "lower",
    # the closed rebalance loop's steady ms/step under drift (config 4)
    "rebalance_drift_ms": "lower",
    # the chunked and pipelined service step's throughput (config 10)
    "service_pps": "higher",
    "pipeline_pps": "higher",
    # probed / unprobed step time at the head chunk, 1.0 = free
    "probe_cost_factor": "lower",
}

# nested fallbacks: a metric missing at the top level of the parsed
# bench line is pulled from a nested dict instead
_NESTED_KEYS: Dict[str, Tuple[str, str]] = {
    "exchange_bw_util": ("report", "bw_util"),
    "exchange_bytes_per_sec": ("report", "exchange_bytes_per_sec"),
    "stress_bw_util": ("stress", "bw_util"),
    "soak_pps": ("soak", "value"),
    "exchange_wire_bytes_per_step": ("report", "wire_bytes_per_step"),
    "exchange_dcn_bytes_per_step": ("report", "dcn_bytes_per_step"),
    "exchange_ici_bytes_per_step": ("report", "ici_bytes_per_step"),
    "rebalance_drift_ms": ("rebalance", "steady_ms_per_step"),
    "service_pps": ("service", "value"),
    "pipeline_pps": ("service", "pipeline_pps"),
    "probe_cost_factor": ("service", "probe_cost_factor"),
}


def min_of_k(sample: Callable[[], float], k: int = 5) -> Dict[str, float]:
    """Run ``sample()`` k times; return min + spread statistics.

    ``sample`` must return one timing estimate (seconds or any monotone
    cost) from an ALREADY-BUILT measurement (kernels compiled, caches
    warm), so the k calls measure run-to-run noise, not build noise.
    Returns
    ``{min, max, mean, spread, k, values}``; ``spread`` is
    ``(max-min)/min`` (0 when min is 0)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    values = [float(sample()) for _ in range(k)]
    lo, hi = min(values), max(values)
    return {
        "min": lo,
        "max": hi,
        "mean": sum(values) / k,
        "spread": (hi - lo) / lo if lo > 0 else 0.0,
        "k": k,
        "values": values,
    }


def extract_metrics(capture: dict) -> Optional[Dict[str, float]]:
    """Pull the guarded metrics out of one capture.

    Accepts either a raw bench JSON line (the dict the headline prints)
    or a wrapper ``{n, cmd, rc, tail, parsed}``.
    Returns None when the capture carries no bench line (e.g. a failed
    run with ``parsed: null``) — callers skip those."""
    parsed = capture.get("parsed", capture)
    if not isinstance(parsed, dict) or "value" not in parsed:
        return None
    out = {}
    for name in GUARDED_METRICS:
        v = parsed.get(name)
        if v is None and name in _NESTED_KEYS:
            outer, inner = _NESTED_KEYS[name]
            nested = parsed.get(outer)
            if isinstance(nested, dict):
                v = nested.get(inner)
        if isinstance(v, (int, float)):
            out[name] = float(v)
    return out


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def check_capture(
    current: dict,
    history: Sequence[dict],
    threshold: float = 0.10,
) -> Tuple[bool, List[str]]:
    """Gate one capture against history; returns (ok, report_lines).

    ``current`` and each history entry may be raw bench lines or
    wrappers. For every guarded metric present in BOTH the
    current capture and at least one history capture, compare against the
    best historical value; a relative change worse than ``threshold`` in
    the metric's bad direction fails the gate. Metrics missing from
    either side are reported as skipped, never failed — a new metric
    must be able to land before it has history."""
    lines: List[str] = []
    cur = extract_metrics(current)
    if cur is None:
        return False, ["FAIL: current capture has no parsed bench metrics"]
    hists = [m for m in (extract_metrics(h) for h in history) if m]
    if not hists:
        return False, ["FAIL: no usable history captures"]
    ok = True
    for name, direction in GUARDED_METRICS.items():
        vals = [h[name] for h in hists if name in h]
        if name not in cur or not vals:
            lines.append(f"skip  {name}: no {'current' if name not in cur else 'history'} value")
            continue
        best = max(vals) if direction == "higher" else min(vals)
        now = cur[name]
        if best == 0:
            lines.append(f"skip  {name}: zero best in history")
            continue
        # signed relative change, positive = worse
        delta = (best - now) / best if direction == "higher" else (now - best) / best
        verdict = "FAIL" if delta > threshold else ("ok  " if delta <= 0 else "warn")
        if delta > threshold:
            ok = False
        # Δ is printed with negative = worse regardless of direction
        lines.append(
            f"{verdict}  {name}: current {now:.6g} vs best {best:.6g} "
            f"(Δ {-delta*100:+.1f}%, threshold {threshold*100:.0f}%, "
            f"n_history={len(vals)})"
        )
    return ok, lines


# ---------------------------------------------------------------------------
# Noise-aware classification.

# Spread substituted for captures that carry no timing_spread: the one
# measured wobble of the reference's history (an 8.6% headline move on
# byte-identical exchange work), so such captures are assumed ~8% noisy.
DEFAULT_SPREAD = 0.08
# Safety margin on the spread-derived floor: spread is (max-min)/min of
# k samples, an underestimate of the true run-to-run envelope for
# small k.
SPREAD_MARGIN = 1.25
# A delta is REGRESSION only beyond max(threshold, this factor × noise):
# clearly outside anything the captures' own variance can explain.
REGRESSION_FACTOR = 2.0

# classification labels, worst first
REGRESSION, WARN, WOBBLE, OK = "REGRESSION", "WARN", "WOBBLE", "OK"
_SEVERITY = {REGRESSION: 3, WARN: 2, WOBBLE: 1, OK: 0}

# fingerprint keys whose drift invalidates naive cross-capture deltas
_FP_COMPARE_KEYS = ("torch", "cuda", "device", "device_count")


def _cpu_model() -> str:
    """The host CPU's model from ``/proc/cpuinfo`` (its vendor and family
    where a virtual machine hides the model), else the architecture."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip().lower(), value.strip())
    except OSError:
        pass
    fields = {k: v for k, v in fields.items() if v and v != "unknown"}
    for key in ("model name", "cpu model", "hardware"):
        if key in fields:
            return fields[key]
    parts = [fields.get(k) for k in ("vendor_id", "cpu family", "model")]
    if any(parts):
        return " ".join(f"{k} {v}" for k, v in zip(
            ("vendor", "family", "model"), parts) if v)
    return _platform.machine()


@functools.lru_cache(maxsize=1)
def _smi_name_power_limit() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card (one query
    a process: the limit does not change under a run)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def env_fingerprint(device=None) -> Dict[str, object]:
    """The machine a capture ran on, for cross-capture comparisons:
    python, numpy, torch and its CUDA, the device (``device``; None = the
    GPU when there is one, else the CPU) and the card count, the card's
    name and power limit (``nvidia-smi``), the host CPU and its cores.

    numpy and torch are probed only if importable (this module stays
    importable without them); device queries are best-effort."""
    fp: Dict[str, object] = {
        "python": _platform.python_version(),
        "platform": sys.platform,
        "host_cpu": _cpu_model(),
        "host_cores": os.cpu_count(),
    }
    try:
        import numpy

        fp["numpy"] = numpy.__version__
    except ImportError:  # pragma: no cover
        pass
    try:
        import torch

        fp["torch"] = torch.__version__
        fp["cuda"] = torch.version.cuda
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        dev = torch.device(device)
        on_card = dev.type == "cuda"
        fp["device"] = (torch.cuda.get_device_name(dev) if on_card
                        else "cpu")
        fp["device_count"] = torch.cuda.device_count() if on_card else 0
        fp["gpu_name_power_limit"] = (_smi_name_power_limit() if on_card
                                      else None)
    except Exception:  # torch absent or no device: still usable
        pass
    return fp


def _spread_of(capture: dict) -> Optional[float]:
    """The capture's own recorded min-of-k spread, if it has one."""
    parsed = capture.get("parsed", capture)
    if not isinstance(parsed, dict):
        return None
    v = parsed.get("timing_spread")
    return float(v) if isinstance(v, (int, float)) else None


def _env_of(capture: dict) -> Optional[dict]:
    parsed = capture.get("parsed", capture)
    if not isinstance(parsed, dict):
        return None
    env = parsed.get("env")
    return env if isinstance(env, dict) else None


def _progprofile_of(capture: dict) -> Optional[str]:
    """The static wire-model hash the capture was taken under, or None
    (the port's captures carry none yet)."""
    parsed = capture.get("parsed", capture)
    if not isinstance(parsed, dict):
        return None
    h = parsed.get("progprofile_hash")
    return h if isinstance(h, str) else None


def noise_floor(
    current_spread: Optional[float],
    best_spread: Optional[float],
) -> Tuple[float, bool]:
    """Per-metric noise floor from the two captures being compared.

    ``SPREAD_MARGIN × max(spread_current, spread_best)``, substituting
    :data:`DEFAULT_SPREAD` for captures without a recorded spread.
    Returns ``(floor, defaulted)`` — ``defaulted`` is True
    when either side used the substitute (the report says so, because a
    defaulted floor is an assumption, not a measurement)."""
    defaulted = current_spread is None or best_spread is None
    cur = DEFAULT_SPREAD if current_spread is None else float(current_spread)
    best = DEFAULT_SPREAD if best_spread is None else float(best_spread)
    return SPREAD_MARGIN * max(cur, best), defaulted


def classify_delta(
    delta: float, noise: float, threshold: float = 0.10
) -> str:
    """Label one signed relative delta (positive = worse).

    ``OK`` — at or better than best; ``WOBBLE`` — worse but within the
    noise floor (run-to-run variance explains it); ``REGRESSION`` —
    beyond ``max(threshold, REGRESSION_FACTOR × noise)`` (variance
    cannot explain it); ``WARN`` — the gap between (suspicious, rerun
    before trusting either way)."""
    if delta <= 0:
        return OK
    if delta <= noise:
        return WOBBLE
    if delta > max(threshold, REGRESSION_FACTOR * noise):
        return REGRESSION
    return WARN


def classify_capture(
    current: dict,
    history: Sequence[dict],
    threshold: float = 0.10,
) -> Tuple[bool, List[str], Dict[str, str]]:
    """Noise-aware gate: returns ``(ok, report_lines, labels)``.

    Same best-of-history comparison as :func:`check_capture`, but each
    guarded metric is labeled via :func:`classify_delta` with a noise
    floor from the current and best captures' recorded spreads
    (:func:`noise_floor`). ``ok`` is False only on REGRESSION — WOBBLE
    and WARN report loudly but do not fail the gate, so wall-clock
    wobble cannot block an unrelated commit while a real 2×
    slowdown still does. ``labels`` maps metric name → label for the
    metrics actually compared."""
    lines: List[str] = []
    labels: Dict[str, str] = {}
    cur = extract_metrics(current)
    if cur is None:
        return (
            False,
            ["REGRESSION  current capture has no parsed bench metrics"],
            {},
        )
    entries = [
        (m, _spread_of(h), _env_of(h), _progprofile_of(h))
        for h, m in ((h, extract_metrics(h)) for h in history)
        if m
    ]
    if not entries:
        return False, ["REGRESSION  no usable history captures"], {}
    cur_spread = _spread_of(current)
    cur_env = _env_of(current)
    cur_pph = _progprofile_of(current)
    ok = True
    best_env: Optional[dict] = None
    best_pph: Optional[str] = None
    for name, direction in GUARDED_METRICS.items():
        vals = [
            (m[name], spread, env, pph)
            for m, spread, env, pph in entries
            if name in m
        ]
        if name not in cur or not vals:
            which = "current" if name not in cur else "history"
            lines.append(f"skip        {name}: no {which} value")
            continue
        pick = max if direction == "higher" else min
        best, b_spread, b_env, b_pph = pick(vals, key=lambda v: v[0])
        if best == 0:
            lines.append(f"skip        {name}: zero best in history")
            continue
        if name == "value":
            best_env = b_env
            best_pph = b_pph
        delta = (
            (best - cur[name]) / best
            if direction == "higher"
            else (cur[name] - best) / best
        )
        noise, defaulted = noise_floor(cur_spread, b_spread)
        label = classify_delta(delta, noise, threshold)
        labels[name] = label
        if label == REGRESSION:
            ok = False
        bound = max(threshold, REGRESSION_FACTOR * noise)
        lines.append(
            f"{label:<10}  {name}: current {cur[name]:.6g} vs best "
            f"{best:.6g} (Δ {-delta*100:+.1f}%, noise floor "
            f"{noise*100:.1f}%{' [default spread]' if defaulted else ''},"
            f" regress bound {bound*100:.1f}%, n_history={len(vals)})"
        )
    if cur_env is not None and best_env is not None:
        drift = [
            k
            for k in _FP_COMPARE_KEYS
            if cur_env.get(k) != best_env.get(k)
        ]
        if drift:
            lines.append(
                "note        env fingerprint drifted vs best capture: "
                + ", ".join(
                    f"{k} {best_env.get(k)!r}→{cur_env.get(k)!r}"
                    for k in drift
                )
            )
    elif cur_env is not None:
        lines.append(
            "note        best capture has no env fingerprint (predates"
            " it); deltas assume a comparable machine"
        )
    if (
        cur_pph is not None
        and best_pph is not None
        and cur_pph != best_pph
    ):
        lines.append(
            "note        static wire model changed between captures "
            f"(progprofile hash {best_pph!r}→{cur_pph!r}); a perf "
            "delta here may be the intentional wire/footprint change, "
            "not a regression"
        )
    return ok, lines, labels


def _stack_of(capture: dict) -> Optional[str]:
    """Which package a capture came from: ``"torch"`` (the port's env
    fingerprint), ``"jax"`` (the reference's), or None (no fingerprint)."""
    env = _env_of(capture)
    if env is None:
        return None
    if "torch" in env:
        return "torch"
    return "jax" if "jax" in env else None


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="mpi_grid_redistribute_tpu_torch.tools.bench_check",
        description="Bench regression guard: compare a capture of the "
        "port against a history of the port's captures (>threshold "
        "regressions fail).",
    )
    p.add_argument(
        "--current",
        help="capture to check (bench JSON line or a wrapper with "
        "'parsed'); default: the newest history file, checked against "
        "the rest",
    )
    p.add_argument(
        "--history",
        required=True,
        help="glob of the port's earlier captures (required: the "
        "committed BENCH_r*.json are TPU captures of the reference)",
    )
    p.add_argument("--threshold", type=float, default=0.10)
    p.add_argument(
        "--legacy",
        action="store_true",
        help="use the pre-classifier binary gate (any >threshold delta "
        "fails) instead of the WOBBLE/WARN/REGRESSION classifier",
    )
    args = p.parse_args(argv)

    paths = sorted(glob.glob(args.history))
    if not paths:
        print(f"bench-check FAIL: no history matches {args.history!r}")
        return 2
    if args.current:
        current = _load(args.current)
        hist_paths = paths
    else:
        # self-test mode: newest (sorted order) vs the rest
        current = _load(paths[-1])
        hist_paths = paths[:-1]
        if not hist_paths:
            print("bench-check ok: single capture, nothing to compare")
            return 0
        print(f"checking {paths[-1]} against {len(hist_paths)} earlier captures")
    history = [_load(pth) for pth in hist_paths]
    if _stack_of(current) != "torch":
        print("bench-check FAIL: the current capture has no port "
              "fingerprint (env.torch)")
        return 2
    foreign = [pth for pth, h in zip(hist_paths, history)
               if _stack_of(h) != "torch"]
    if foreign:
        # a TPU capture (or one with no fingerprint) is another machine
        # and another program: never a baseline for the card's numbers
        print(
            f"bench-check FAIL: mixed fingerprints: {len(foreign)} history "
            "capture(s) are not the port's: " + ", ".join(foreign[:5])
        )
        return 2
    if args.legacy:
        ok, lines = check_capture(current, history, args.threshold)
        verdict = "ok" if ok else "FAIL"
    else:
        ok, lines, labels = classify_capture(
            current, history, args.threshold
        )
        worst = max(
            (label for label in labels.values()),
            key=lambda s: _SEVERITY[s],
            default=OK,
        )
        verdict = "FAIL (REGRESSION)" if not ok else (
            "ok" if worst == OK else f"ok ({worst})"
        )
    for ln in lines:
        print("  " + ln)
    print(f"bench-check {verdict}")
    return 0 if ok else 1
