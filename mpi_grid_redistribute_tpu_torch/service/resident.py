"""The chunked service step (port of the JAX package's
``service/resident.py``): ``chunk`` steps of drift -> redistribute issued
back to back on the device, with the per-step observables the journal
needs collected on the device as the chunk's ``ys``: the full
:class:`~..parallel.exchange.RedistributeStats` of every step and the
per-step shard ``count``.

The engine is the one :meth:`~..api.GridRedistribute.engine_fn`
resolves, the program ``redistribute()`` runs, and the drift is
:func:`~..models.nbody.service_drift`, so any chunk length reproduces the
eager per-step loop bit for bit. Overflow needs no check inside the
chunk: a chunk whose ``ys`` show dropped rows is discarded by its caller,
which grows the capacities from the stacked ``needed_capacity`` /
``count + dropped_recv`` and re-runs it from its entry tensors (the
grow-and-rerun contract of ``redistribute(on_overflow="grow")``, at chunk
boundaries).

THE CHUNK READS NOTHING BACK TO THE HOST: no ``.item()``, ``.cpu()``,
``bool(tensor)`` or ``int(tensor)`` in it, so the host issues every step's
work without waiting for the device (the port's form of the reference's
"no host callback" check; ``tests/test_torch_resident.py`` makes those
reads raise, and on the card ``torch.cuda.set_sync_debug_mode("error")``
holds it). The reference's ``lax.scan`` is a Python loop here.

Its pipelined sibling, :func:`..service.pipeline.make_pipelined_chunk_fn`
(same signature and return), overlaps step k's exchange with step k+1's
binning where the topology allows and falls back to this function
otherwise.
"""

from __future__ import annotations

import torch

from mpi_grid_redistribute_tpu_torch.models import nbody
from mpi_grid_redistribute_tpu_torch.ops import statehealth
from mpi_grid_redistribute_tpu_torch.telemetry import context as context_lib
from mpi_grid_redistribute_tpu_torch.telemetry.phases import traced_span


class ResidentLayoutError(ValueError):
    """The engine's output layout cannot carry a chunk: the receive
    capacity is not ``n_local``, so step k+1's input would not have step
    k's shape. A caller falls back to the eager per-step loop. Under an
    active step context (``telemetry/context.py``) the message names its
    trace id."""


def stack_ys(steps):
    """Stack a list of per-step ``ys`` (dicts of tensors, stats
    NamedTuples and nested dicts) along a new leading step axis; ``None``
    leaves stay ``None``."""
    first = steps[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(steps)
    if isinstance(first, dict):
        return {k: stack_ys([s[k] for s in steps]) for k in first}
    return type(first)(*(stack_ys([s[i] for s in steps])
                         for i in range(len(first))))


def make_chunk_fn(rd, dt, chunk, positions, *fields, unroll=8, probes=None):
    """Build the macro-step of ``chunk`` service steps.

    Args:
      rd: a torch-backend :class:`~..api.GridRedistribute`; its
        :meth:`engine_fn` supplies the engine (current capacities, edges
        and mover block).
      dt: the drift timestep.
      chunk: steps a macro-step.
      positions, *fields: template tensors fixing shapes and dtypes (a
        driver passes its live ``(pos, vel, ids)``).
      unroll: the reference's ``lax.scan`` unroll, validated and clamped
        to ``[1, chunk]`` as there; it selects nothing here (a Python
        loop issues the steps one after another, and there is no scan
        to unroll).
      probes: optional :class:`~..telemetry.probes.ProbeConfig`. Armed,
        each step also folds a state-health summary
        (``ops/statehealth.py``) into ``ys["probe"]``, the ledger's
        dropped-row total riding as one int32 scalar; ``None`` or tier
        ``off`` runs exactly the unprobed ops.

    Returns ``(macro, cap, out_cap)`` where ``macro(pos, vel, ids, count)
    -> ((pos, vel, ids, count), ys)`` and ``ys = {"stats":
    RedistributeStats[chunk, ...], "count": int32[chunk, R]}`` (plus
    ``"probe"`` when armed). Across the ranks of a mesh each rank passes
    its own shard and count, and a probe summarizes that shard.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    fn, cap, out_cap = rd.engine_fn(positions, *fields)
    n_local = positions.shape[0] // (1 if rd.mesh is not None else rd.nranks)
    if out_cap != n_local:
        trace = context_lib.current_trace()
        at = f" [trace {trace}]" if trace else ""
        raise ResidentLayoutError(
            f"out_capacity {out_cap} != n_local {n_local}: the scan "
            f"carry needs a shape-invariant state layout{at}"
        )
    dt = float(dt)
    unroll = min(max(1, int(unroll)), chunk)
    armed = probes is not None and probes.armed

    # gridlint: resident-path
    def macro(pos, vel, ids, count):
        if armed:
            cum = torch.zeros((), dtype=torch.int32, device=count.device)
            live0 = count.sum(dtype=torch.int32)
        steps = []
        for _ in range(chunk):
            with traced_span("svc:drift"):
                pos = nbody.service_drift(pos, vel, dt)
            with traced_span("svc:exchange"):
                pos, count, (vel, ids), stats = fn(pos, count, vel, ids)
            ys = {"stats": stats, "count": count}
            if armed:
                with traced_span("svc:probe"):
                    cum = cum + statehealth.step_dropped(stats,
                                                         pipelined=False)
                    ys["probe"] = statehealth.summarize(
                        pos, vel, count, live0, cum, probes.lo, probes.hi,
                        probes.tier)
            steps.append(ys)
        return (pos, vel, ids, count), stack_ys(steps)

    return macro, cap, out_cap


def final_stats(stacked):
    """The last step's :class:`RedistributeStats` of a chunk's stacked
    ys: what the eager loop would hold at the same boundary."""
    return type(stacked)(
        *(None if leaf is None else leaf[-1] for leaf in stacked)
    )
