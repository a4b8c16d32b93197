"""State-health probes of the service chunk (port of the JAX package's
``ops/statehealth.py``): a per-step summary of the particle state, folded
into the chunk's per-step outputs, so corruption shows within one chunk.

Tiers (``telemetry.probes.ProbeConfig``): ``off`` never calls this
module (the chunk runs exactly the unprobed ops); ``counters`` gives
int32 scalars ``live``, ``nan_pos``, ``nan_vel``, ``oob`` and
``residual``; ``moments`` adds ``pos_min``/``pos_max`` (float32
``[ndim]`` over live rows) and ``vel_m2`` (float32, the sum of v·v over
live rows).

Semantics (the reference's): row ``i`` of shard ``r`` is live iff ``i <
count[r]``; a NaN or ±Inf component counts its row once toward
``nan_pos``/``nan_vel``; ``oob`` counts live rows with a position
component outside ``[lo, hi)`` (a NaN compares false both ways, so it is
never also out of bounds); ``residual = live + cum_dropped -
initial_live`` in int32, where ``cum_dropped`` is the rows the exchange
destroyed so far (``dropped_send + dropped_recv`` for the canonical
engines, ``dropped_recv`` alone for the pipelined one, whose
``dropped_send`` is backlog still resident).

Everything is tensor ops on the state's device: nothing is read back to
the host.
"""

from __future__ import annotations

import torch

_I32 = torch.int32


def _bad(x: torch.Tensor) -> torch.Tensor:
    """NaN or ±Inf, elementwise."""
    return ~torch.isfinite(x)


def live_mask(n_rows: int, nranks: int, count: torch.Tensor) -> torch.Tensor:
    """Prefix-valid live mask ``[n_rows]`` of ``[R * cap, ...]`` state."""
    cap = n_rows // nranks
    per = (torch.arange(cap, dtype=_I32, device=count.device)[None, :]
           < count[:, None])
    return per.reshape(-1)


def summarize_masked(pos, vel, mask, live, initial_live, cum_dropped, lo,
                     hi, tier):
    """Summary of ``[N, ndim]`` state under a boolean live ``mask`` and an
    exact ``live`` scalar; ``tier`` is ``"counters"`` or ``"moments"``
    (the caller skips ``"off"``). The three row counters come from one
    pass: each component contributes a 3-bit word (bit 0 position
    corrupt, bit 1 position out of bounds, bit 2 velocity corrupt), or-ed
    over the row's components and bit-summed over live rows."""
    if tier not in ("counters", "moments"):
        raise ValueError(f"unknown probe tier {tier!r}")
    code = (
        _bad(pos).to(_I32)
        | (((pos < lo) | (pos >= hi)).to(_I32) << 1)
        | (_bad(vel).to(_I32) << 2)
    )
    row = code[:, 0]
    for d in range(1, code.shape[1]):
        row = row | code[:, d]
    row = torch.where(mask, row, torch.zeros_like(row))
    dev = pos.device

    def i32(x):
        return torch.as_tensor(x, device=dev).to(_I32)

    live = i32(live)
    summary = {
        "live": live,
        "nan_pos": (row & 1).sum(dtype=_I32),
        "nan_vel": (row >> 2).sum(dtype=_I32),
        "oob": ((row >> 1) & 1).sum(dtype=_I32),
        "residual": live + i32(cum_dropped) - i32(initial_live),
    }
    if tier == "moments":
        m = mask[:, None]
        posf = pos.to(torch.float32)
        inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
        summary["pos_min"] = torch.where(m, posf, inf).amin(dim=0)
        summary["pos_max"] = torch.where(m, posf, -inf).amax(dim=0)
        velf = vel.to(torch.float32)
        summary["vel_m2"] = torch.where(
            m, velf * velf, torch.zeros((), dtype=torch.float32, device=dev)
        ).sum()
    return summary


def summarize(pos, vel, count, initial_live, cum_dropped, lo, hi, tier):
    """Summary of prefix-valid ``[R * cap, ndim]`` state (the sequential
    chunk's entry); ``count`` is the ``[R]`` int32 live rows a shard."""
    mask = live_mask(pos.shape[0], count.shape[0], count)
    return summarize_masked(pos, vel, mask, count.sum(dtype=_I32),
                            initial_live, cum_dropped, lo, hi, tier)


def step_dropped(stats, pipelined: bool) -> torch.Tensor:
    """Rows the exchange destroyed this step (int32 scalar), the ledger's
    increment: ``dropped_recv`` for the pipelined engine (its
    ``dropped_send`` is resident backlog), plus ``dropped_send`` for the
    canonical engines (both truncate rows out of existence)."""
    dr = stats.dropped_recv.sum(dtype=_I32)
    if pipelined:
        return dr
    return dr + stats.dropped_send.sum(dtype=_I32)
