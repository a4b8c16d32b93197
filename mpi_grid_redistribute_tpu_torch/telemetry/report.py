"""The metrics surface: one merged dict per exchange workload (the port's
copy of the JAX package's ``telemetry/report.py``, the same keys).

:func:`exchange_report` merges the stats summary, exchange bytes a step
(total and moved off the diagonal), achieved GB/s, ``bw_util`` against
the domain's roof (:func:`..utils.profiling.exchange_peak_bytes_per_sec`:
HBM3 on one card, NVLink 4 across cards) and the recorder's event
counts. ``GridRedistribute.report()`` and the bench drivers emit it. It
reads the stats off the device once.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch.telemetry import flow as flow_lib
from mpi_grid_redistribute_tpu_torch.utils import profiling, stats as stats_lib


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def _on_host(stats):
    """``stats`` (a stats NamedTuple) with every leaf a NumPy array,
    read off the device in one transfer."""
    d = stats._asdict()
    return type(stats)(**dict(zip(d, stats_lib.host_arrays(list(d.values())))))


def row_bytes_of(positions, *fields) -> int:
    """Payload bytes one particle row carries across the exchange.

    Sums position components plus every field's trailing elements, each
    at its own itemsize — valid for both engine layouts, since planar
    ``[K, n]`` and row-major ``[n, K]`` move the same logical row, only
    tiled differently. Accepts NumPy arrays and tensors."""
    total = 0
    for a in (positions, *fields):
        per_row = int(np.prod(a.shape[1:])) if len(a.shape) > 1 else 1
        total += per_row * _itemsize(a.dtype)
    return total


def _moved_bytes_per_step(stats, row_bytes: int) -> float:
    """Mean OFF-DIAGONAL bytes/step: rows that changed ranks.

    ``RedistributeStats.send_counts`` ``[..., R, R]`` includes the
    diagonal (rows a rank keeps); those never cross the inter-card wire,
    so the NVLink utilization divides moved bytes only. ``MigrateStats.sent``
    already counts movers exclusively."""
    if hasattr(stats, "sent"):
        return profiling.exchange_bytes_per_step(stats, row_bytes)
    send = np.asarray(stats.send_counts)
    send = send.reshape(-1, send.shape[-2], send.shape[-1])
    moved = send.sum(axis=(1, 2)) - np.einsum("sii->s", send)
    return float(moved.mean()) * row_bytes


def exchange_report(
    stats,
    row_bytes: int,
    *,
    step_seconds: Optional[float] = None,
    domain: str = "hbm",
    n_chips: int = 1,
    recorder=None,
    engine_wire_cols: Optional[int] = None,
    dense_wire_cols: Optional[int] = None,
    wire_shards: Optional[int] = None,
) -> Dict[str, object]:
    """Merged metrics dict for one exchange workload.

    Args:
      stats: a ``RedistributeStats`` or ``MigrateStats`` pytree (single
        call or step-stacked) — the kind is detected and summarized with
        the matching :mod:`..utils.stats` summary.
      row_bytes: payload bytes per row (:func:`row_bytes_of`).
      step_seconds: honest per-step seconds — pass a length-differenced
        measurement (:func:`..utils.profiling.time_per_step_samples`);
        without it the byte totals are reported but the rate/utilization
        fields are ``None`` (a wall-clock guess would overstate dispatch
        overhead as wire time, so none is silently substituted).
      domain: ``"hbm"`` (single-card vrank exchange) or ``"nvlink"``
        (all-to-all across cards) — selects the roof AND which byte
        count utilization divides: HBM moves every gathered/scattered
        row, the NVLink wire only the moved (off-diagonal) ones.
      n_chips: cards sharing the aggregate byte rate.
      recorder: optional :class:`..telemetry.recorder.StepRecorder`; its
        all-time per-kind counts land under ``"events"``.
      engine_wire_cols / dense_wire_cols / wire_shards: the scheduled
        wire model of the dispatched canonical engine — per-shard pool
        columns the exchange collective actually moves, the dense
        ``R * capacity`` columns it replaced, and the shard count.
        When given, ``wire_bytes_per_step`` reports the SCHEDULED bytes
        on the wire (pool width x row bytes x shards; fallback steps
        folded in at the dense width) — distinct from
        ``moved_bytes_per_step``, which counts occupied rows only. The
        count-driven engines shrink the former toward the latter.

    The dict is JSON-serializable (plain floats/ints/strs/dicts).
    """
    stats = _on_host(stats)
    is_migrate = hasattr(stats, "sent")
    summary = (
        stats_lib.summarize_migrate(stats)
        if is_migrate
        else stats_lib.summarize_redistribute(stats)
    )
    total_bps = profiling.exchange_bytes_per_step(stats, row_bytes)
    moved_bps = _moved_bytes_per_step(stats, row_bytes)
    wire_bytes = moved_bps if domain == "nvlink" else total_bps
    out: Dict[str, object] = {
        "kind": "migrate" if is_migrate else "redistribute",
        "stats": summary,
        "row_bytes": int(row_bytes),
        "exchange_bytes_per_step": total_bps,
        "moved_bytes_per_step": moved_bps,
        "exchange_domain": domain,
        "n_chips": int(n_chips),
        "step_seconds": step_seconds,
        "exchange_bytes_per_sec": None,
        "exchange_gb_per_sec": None,
        "bw_util": None,
    }
    if step_seconds is not None and step_seconds > 0:
        bps = wire_bytes / step_seconds
        out["exchange_bytes_per_sec"] = bps
        out["exchange_gb_per_sec"] = bps / 1e9
        out["bw_util"] = profiling.exchange_bw_util(bps, domain, n_chips)
    # per-link refinement (telemetry.flow): mean per-step flow matrix ->
    # hottest pairs with per-link moved bytes and bw_util against ONE
    # link's roof. Aggregate-only stats (a hand-built MigrateStats with
    # flow=None) simply omit the section.
    try:
        mean_matrix = flow_lib.flow_matrix_of(stats).mean(axis=0)
    except (ValueError, TypeError):
        mean_matrix = None
    if mean_matrix is not None:
        out["links"] = flow_lib.link_report(
            mean_matrix, row_bytes, step_seconds=step_seconds, domain=domain
        )
    # sparse fast-path hit rate: present whenever the stats
    # came from a sparse-capable loop (fast_path leaf is a [S, R] 1/0
    # guard trace; dense-only loops carry None and omit the field).
    fp = getattr(stats, "fast_path", None)
    if fp is not None:
        fp = np.asarray(fp).reshape(-1, np.asarray(fp).shape[-1])
        taken = int(np.count_nonzero(fp.any(axis=1)))
        out["fast_path_steps"] = taken
        out["fast_path_hit_rate"] = taken / fp.shape[0] if fp.shape[0] else None
    # software-pipelined branch trace: `pipeline` is a
    # [..., R] 1/0 trace on the pipelined resident engine's stats (1 =
    # that step's exchange armed for overlapped consumption); every
    # other engine carries None and omits the pair. Mirrors fast_path_*
    # so operators can see how often the pipelined branch actually ran.
    pl = getattr(stats, "pipeline", None)
    if pl is not None:
        pl = np.asarray(pl).reshape(-1, np.asarray(pl).shape[-1])
        hit = int(np.count_nonzero(pl.any(axis=1)))
        out["pipeline_steps"] = hit
        out["pipeline_hit_rate"] = hit / pl.shape[0] if pl.shape[0] else None
    # count-driven fallback trace: `fallback` is a [..., R] 1/0
    # guard trace on sparse/neighbor canonical stats (1 = that step took
    # the dense in-graph fallback); dense engines carry None and omit
    # the section. Any rank falling back means ALL did (the pmin guard).
    fb_rate = 0.0
    fb = getattr(stats, "fallback", None)
    if fb is not None:
        fb = np.asarray(fb).reshape(-1, np.asarray(fb).shape[-1])
        fell = int(np.count_nonzero(fb.any(axis=1)))
        out["fallback_steps"] = fell
        out["fallback_rate"] = fell / fb.shape[0] if fb.shape[0] else None
        fb_rate = fell / fb.shape[0] if fb.shape[0] else 0.0
    # scheduled wire-cost model: what the exchange collective
    # puts on the wire regardless of occupancy; fallback steps billed at
    # the dense width they actually ran at
    if engine_wire_cols is not None and wire_shards is not None:
        cols = float(engine_wire_cols)
        if dense_wire_cols is not None:
            dense_bps = float(dense_wire_cols) * row_bytes * int(wire_shards)
            out["dense_wire_bytes_per_step"] = dense_bps
            cols = cols * (1.0 - fb_rate) + float(dense_wire_cols) * fb_rate
        out["wire_bytes_per_step"] = cols * row_bytes * int(wire_shards)
    if recorder is not None:
        out["events"] = recorder.counts()
        out["events_evicted"] = recorder.evicted
    return out


def format_report(report: Dict[str, object]) -> str:
    """One human line from an :func:`exchange_report` dict."""
    bw = report.get("bw_util")
    gbs = report.get("exchange_gb_per_sec")
    rate = (
        "rate: pass step_seconds"
        if gbs is None
        else f"{gbs:.2f} GB/s ({bw*100:.2f}% of {report['exchange_domain']})"
    )
    ev = report.get("events") or {}
    grows = ev.get("capacity_grow", 0) + ev.get("halo_grow", 0)
    return (
        f"{report['kind']}: {report['exchange_bytes_per_step']/1e6:.2f} "
        f"MB/step ({report['moved_bytes_per_step']/1e6:.2f} moved), "
        f"{rate}, grows={grows}"
    )
