"""Structured summaries of the per-step stats (the JAX package's
``utils/stats.py``): totals, load imbalance and the loss counters an
operator watches. The stats are NamedTuples of tensors
(:class:`..parallel.migrate.MigrateStats`,
:class:`..parallel.exchange.RedistributeStats`), optionally step-stacked;
each summary reads them to NumPy once and returns the reference's keys
and values."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _host(stats) -> dict:
    """Every leaf of ``stats`` as a NumPy array (``None`` kept), read off
    the device once."""
    return {
        f: None if v is None
        else v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
        else np.asarray(v)
        for f, v in stats._asdict().items()
    }


def _imbalance(per_rank: np.ndarray) -> float:
    """max/mean load ratio (1.0 = perfectly balanced); 0 if empty."""
    m = per_rank.mean()
    return float(per_rank.max() / m) if m > 0 else 0.0


def summarize_redistribute(stats) -> Dict[str, float]:
    """Summary dict from a ``RedistributeStats`` (optionally step-stacked)."""
    s = _host(stats)
    send, recv = s["send_counts"], s["recv_counts"]
    send2 = send.reshape(-1, send.shape[-2], send.shape[-1])
    recv2 = recv.reshape(-1, recv.shape[-2], recv.shape[-1])
    moved = send2.sum(axis=(1, 2)) - np.einsum("sii->s", send2)
    total = float(send2.sum(axis=(1, 2)).mean())
    return {
        "steps": send2.shape[0],
        "total_rows": total,
        "moved_rows": float(moved.mean()),
        # the share of rows that changed ranks (off-diagonal / total)
        "moved_fraction": float(moved.mean()) / max(total, 1.0),
        "recv_imbalance": _imbalance(recv2.sum(axis=2).mean(axis=0)),
        "dropped_send": int(s["dropped_send"].sum()),
        "dropped_recv": int(s["dropped_recv"].sum()),
        # the smallest per-pair capacity that would have sent everything
        "needed_capacity": int(s["needed_capacity"].max()),
    }


def summarize_migrate(stats) -> Dict[str, float]:
    """Summary dict from a ``MigrateStats`` (optionally step-stacked)."""
    s = _host(stats)
    sent = s["sent"].reshape(-1, s["sent"].shape[-1])
    pop = s["population"].reshape(sent.shape)
    return {
        "steps": sent.shape[0],
        "population": float(pop.sum(axis=1).mean()),
        "sent_per_step": float(sent.sum(axis=1).mean()),
        "migration_fraction": float(
            sent.sum(axis=1).mean() / max(pop.sum(axis=1).mean(), 1.0)
        ),
        "population_imbalance": _imbalance(pop.mean(axis=0)),
        "backlog": int(s["backlog"].sum()),
        "dropped_recv": int(s["dropped_recv"].sum()),
    }


def check_no_loss(stats) -> None:
    """Raise if any surfaced *loss* counter is nonzero. ``backlog`` is not
    loss: backlogged migrants stay resident and retry (a backlog that
    never drains is a liveness concern: :func:`detect_stall`)."""
    s = _host(stats)
    problems = [
        f"{name}={int(s[name].sum())}"
        for name in ("dropped_send", "dropped_recv")
        if s.get(name) is not None and int(s[name].sum())
    ]
    if problems:
        raise RuntimeError(
            "particle loss detected: " + ", ".join(problems)
            + " — raise capacity / out_capacity / slab headroom"
        )


def detect_stall(stats, window: int = 8) -> Dict[str, float]:
    """Flag a migration stall in step-stacked ``MigrateStats`` (leaves
    ``[S, V]``): ``stalled`` (1.0/0.0) when the final ``window`` steps all
    have the SAME nonzero total backlog, ``never_drains`` when the backlog
    never reaches zero over the window (catches an oscillating livelock
    too), plus ``backlog_final`` and the window's ``backlog_min``/
    ``backlog_max``."""
    backlog = _host(stats)["backlog"]
    per_step = backlog.reshape(backlog.shape[0], -1).sum(axis=1)
    win = per_step[-min(window, len(per_step)):]
    full = len(win) >= window
    stalled = bool(full and win.min() == win.max() > 0)
    never_drains = bool(full and win.min() > 0)
    return {
        "stalled": float(stalled),
        "never_drains": float(never_drains),
        "backlog_final": int(per_step[-1]),
        "backlog_min": int(win.min()),
        "backlog_max": int(win.max()),
    }
