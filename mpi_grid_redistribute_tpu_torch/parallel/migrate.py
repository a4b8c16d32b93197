"""Resident-slot migration (port of the JAX package's
``parallel/migrate.py``: the vrank engine, with its dense planar step and
mover-sparse fast path on one device and its receiver-granted exchange
across devices, and the flat engine of one rank a process).

State is a PLANAR matrix ``[K, V * n]``: position rows, payload rows and
the alive row last. The canonical transport is int32 (float fields
travel bitcast, so every bit pattern survives); the legacy float32 layout
(alive row 1.0/0.0) is accepted too, as in the reference. Vrank ``v``
("virtual rank": one subdomain of the grid, all of them side by side on
one device) owns columns ``[v * n, (v + 1) * n)``. One dense step:

  1. destination key per column (given by the fused drift-bin kernel, or
     binned here: the canonical vrank grid, or under a load-balanced
     ``cells``/``assignment`` decomposition the cell id and one table
     gather);
  2. one packed sort groups leavers by destination; counts by search;
  3. receiver-granted flow control on ``[V, V]`` tables: pairwise swaps
     (self-financing), a greedy share of free slots, a monotone fixpoint
     over the slots each receiver's own departures vacate, and the cycle
     rescue for rotation cycles between full vranks;
  4. vacated-slot and arrival plans, one column gather of the arrivals;
  5. ONE landing scatter writes arrivals and hole markers for every
     vrank (the overlay kernel by default; see :func:`_land_scatter`);
  6. the free-slot stack update.

With ``mover_cap`` the step first selects the leavers into a ``[V, B]``
mover block (two-level selection, no full sort) and computes the same
grant tables; when the guard holds (selection exact, nothing clipped,
arrivals within ``B``) a fast branch lands only the movers' columns and
never touches a stayer. Otherwise the dense step runs, inside a
``mig:fallback`` span. Both give the same bits.

The two-phase form (:func:`vrank_exchange_two_phase_fn`) splits a vrank
step into ``issue`` (key -> plan, reading no payload) and ``land`` (one
scatter), so the pipelined service chunk can land step k after it has
drifted and binned step k+1; the flat engine's ``fn.issue`` /
``fn.complete`` split it the same way.

Ungranted leavers stay resident and retry (``backlog``); nothing is ever
dropped. Slot order is not the MPI canonical order; the reference defines
correctness as set-equality per vrank, and this port reproduces the
reference's bits exactly.

Differences from the reference, none visible in any output: the
unclipped vacated-plan shortcut (a ``lax.cond`` there) always takes the general
plan, whose entries agree wherever they are read; the plan lookups are
integer search + gather instead of the reference's float einsum
workaround. The sparse engine's guard (the reference's ``lax.cond``) is
read on the host once per step (:data:`HOST_SYNCS`); the dense step never
syncs.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple, Sequence

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch._device import OnDevice
from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops import binning, overlay, scatter
from mpi_grid_redistribute_tpu_torch.ops.pack import gather_plan_cols, pack_cols
from mpi_grid_redistribute_tpu_torch.parallel import collectives as col
from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib
from mpi_grid_redistribute_tpu_torch.telemetry.phases import (
    host_read, span, traced_span,
)

_I32 = torch.int32

# host reads of device values, by cause (the mover-sparse engine's guard
# is the only one on the migrate path); telemetry.phases.host_read counts
# each and labels its wait "sync:sparse_guard"
HOST_SYNCS = {"sparse_guard": 0}

SCATTER_IMPLS = ("overlay", "xla", "rows")


def _resolve_scatter_impl(scatter_impl) -> str:
    """The landing-scatter route, resolved once when the engine is built:
    ``None`` reads env ``MPI_GRID_LAND_SCATTER`` (``overlay``, ``xla`` or
    ``rows``; the legacy ``MPI_GRID_PALLAS_SCATTER=1`` means ``rows``),
    then defaults to ``"overlay"``; ``True`` means ``"rows"``, ``False``
    ``"xla"``; an unknown name raises ``ValueError``. Every route runs on
    every device (on the CPU each kernel runs its plain version)."""
    if scatter_impl is None:
        env = os.environ.get("MPI_GRID_LAND_SCATTER")
        if env is None and os.environ.get("MPI_GRID_PALLAS_SCATTER") == "1":
            env = "rows"
        impl = env or "overlay"
    elif scatter_impl is True:
        impl = "rows"
    elif scatter_impl is False:
        impl = "xla"
    else:
        impl = str(scatter_impl)
    if impl not in SCATTER_IMPLS:
        raise ValueError(f"unknown landing-scatter impl {impl!r}")
    return impl


def _land_scatter(flat, targets, cols, impl: str = "overlay",
                  plain: bool = False):
    """The landing column scatter ``flat[:, targets] = cols`` on planar
    ``[K, m]`` state, in place, targets outside ``[0, m)`` dropped.

    ``impl``: ``"overlay"`` is kernel 2; ``"rows"`` is kernel 6 on the
    row-major transpose (``scatter_rows(flat.T, targets, cols.T).T``, two
    transposes paid, float32 state only, as in the reference); ``"xla"``
    is one PyTorch indexed assignment (the counterpart of the XLA scatter
    the reference runs outside any kernel). ``plain`` runs the kernels'
    plain versions.

    UNIQUENESS INVARIANT (the kernels' contract): every in-range target
    this module passes is unique by construction — per vrank, targets are
    vacated slots (disjoint prefixes of a sort permutation, or the mover
    block) plus popped free-stack entries (distinct hole ids, disjoint
    from the live vacated slots), globalized onto disjoint column blocks;
    every other entry is the drop sentinel ``m``."""
    if impl == "overlay":
        if plain:
            return overlay.overlay_scatter_planar_plain(flat, targets, cols)
        return overlay.overlay_scatter_planar(flat, targets, cols)
    if impl == "rows":
        if flat.dtype != torch.float32:
            raise TypeError(
                "scatter_impl='rows' (MPI_GRID_LAND_SCATTER=rows) is "
                "float32-only and incompatible with the int32 bit-exact "
                "transport the migrate engines now carry; use 'overlay' "
                "or 'xla'"
            )
        fn = scatter.scatter_rows_plain if plain else scatter.scatter_rows
        rows = fn(flat.T.contiguous(), targets, cols.T.contiguous())
        flat.copy_(rows.T)
        return flat
    m = flat.shape[1]
    ok = (targets >= 0) & (targets < m)
    words = flat.view(_I32) if flat.dtype == torch.float32 else flat
    cw = cols.view(_I32) if cols.dtype == torch.float32 else cols
    words[:, targets[ok].long()] = cw[:, ok]
    return flat


class MigrateStats(NamedTuple):
    """Per-step migration observability, one entry per vrank ``[V]``
    (stacked ``[S, V]`` by the loop). ``backlog`` counts leavers held back
    by the grants (they stay resident and retry); ``dropped_recv`` is a
    safety counter, structurally zero since sends are receiver-granted.
    ``flow`` is the ``[V, V]`` granted-send table (``[i, j]`` = rows vrank
    ``i`` sent to ``j``). ``fast_path`` is the mover-sparse engine's
    branch, ``[V]`` int32 (1 = the fast branch ran, 0 = the guard sent the
    step to the dense engine), and ``None`` when the engine was built
    without ``mover_cap``."""

    sent: torch.Tensor
    received: torch.Tensor
    population: torch.Tensor
    backlog: torch.Tensor
    dropped_recv: torch.Tensor
    flow: torch.Tensor = None
    fast_path: torch.Tensor = None


class InflightExchange(NamedTuple):
    """What the issue half of a split flat-engine step hands its complete
    half: the planar ``[K, n_src * C]`` arrival pool (after the wire),
    the granted ``recv_counts``/``send_counts``, the send pool's resident
    columns ``gather_idx`` (the sender's vacated slots) and ``backlog``,
    the leavers the grants held back (they stay resident)."""

    recv: torch.Tensor
    recv_counts: torch.Tensor
    send_counts: torch.Tensor
    gather_idx: torch.Tensor
    backlog: torch.Tensor


class MigrateState(NamedTuple):
    """Loop-carried state: ``fused`` planar int32 ``[K, V * n]`` (or the
    legacy float32 layout, alive row 1.0/0.0); ``free_stack`` ``[V, n]``
    holds each vrank's hole columns (local ids, only the first
    ``n_free[v]`` entries live); ``n_free`` ``[V]``. A step updates
    ``fused`` and ``free_stack`` in place."""

    fused: torch.Tensor
    free_stack: torch.Tensor
    n_free: torch.Tensor


def fuse_fields(arrays: Sequence[torch.Tensor], alive: torch.Tensor):
    """Pack ``[n, ...]`` 32-bit fields + the alive mask into one PLANAR
    ``[K, n]`` int32 matrix (float fields bitcast with
    ``Tensor.view(torch.int32)``; the alive mask becomes the last row,
    1/0). Returns ``(fused, specs)`` for :func:`unfuse_fields`."""
    n = arrays[0].shape[0]
    parts, specs = [], []
    for a in arrays:
        if a.element_size() != 4:
            raise TypeError(
                f"fused migration payload requires 32-bit dtypes, got "
                f"{a.dtype}; cast or split the field"
            )
        flat = a.reshape(n, -1)
        if flat.dtype != _I32:
            flat = flat.view(_I32)
        parts.append(flat.T)
        specs.append((tuple(a.shape[1:]), a.dtype))
    parts.append(alive.to(_I32)[None, :])
    return torch.cat(parts, dim=0), tuple(specs)


def unfuse_fields(fused: torch.Tensor, specs):
    """Inverse of :func:`fuse_fields`: ``((arrays...), alive)``. Accepts
    the int32 transport or the legacy float32 layout."""
    out = []
    row = 0
    n = fused.shape[1]
    for shape, dtype in specs:
        k = 1
        for s in shape:
            k *= s
        flat = fused[row : row + k, :].T.contiguous()
        if dtype != flat.dtype:
            flat = flat.view(dtype)
        out.append(flat.reshape((n,) + tuple(shape)))
        row += k
    return tuple(out), fused[-1, :] > 0


def init_state(fused: torch.Tensor, vranks: int = 1,
               batched: bool = None) -> MigrateState:
    """Build the free-slot stack from the alive row: per vrank, the dead
    columns in ascending order (a stable argsort), then the live ones.
    ``batched`` (default ``vranks > 1``) gives the ``[V, n]`` / ``[V]``
    shapes the vrank engine expects even at ``V = 1``."""
    if batched is None:
        batched = vranks > 1
    alive = fused[-1, :] > 0
    if batched:
        alive = alive.reshape(vranks, -1)
    stack = torch.argsort(alive.to(_I32), dim=-1, stable=True).to(_I32)
    n_free = (~alive).sum(dim=-1, dtype=_I32)
    return MigrateState(fused, stack, n_free)


def _segment_of(k: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """For output positions ``k`` (any shape, k >= 0), the segment ``d``
    with ``cum[d] <= k < cum[d+1]`` under exclusive cumulative counts
    ``cum`` ([n_segs+1], cum[0] = 0); ``k >= cum[-1]`` gives n_segs and
    empty segments resolve past their run of duplicates."""
    return torch.searchsorted(cum[1:].contiguous(), k, right=True).to(_I32)


def _greedy_alloc(desired: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """Allocate ``desired[s, w]`` units across sources ``s`` per column
    ``w``, greedily in source order, never exceeding ``cap[w]`` in total
    (lower source index wins under pressure)."""
    cum = torch.cumsum(desired, dim=0, dtype=_I32)
    prev = cum - desired
    capb = cap[None, :]
    return (torch.minimum(cum, capb) - torch.minimum(prev, capb)).clamp_min(0)


def _cycle_rescue(pending, sends_zero, ok=None):
    """Force one self-financed row along each stalled rotation cycle.

    ``pending`` ``[S, S]`` (>0 where source s still wants to send to d
    after the grants), ``sends_zero`` ``[S]`` (source granted nothing),
    ``ok`` optional ``[S]`` guard (a cycle is forced only if all its
    members are ok). Cycles of the functional graph v -> first pending
    destination of v are found by log-squared boolean closure. Returns
    ``[S, S]`` int32 in {0, 1}."""
    S = pending.shape[0]
    pos = pending > 0
    has = pos.any(dim=1) & sends_zero
    succ = torch.argmax(pos.to(_I32), dim=1)  # first pending destination
    eye = torch.eye(S, dtype=torch.float32, device=pending.device)
    A = torch.where(has[:, None], eye[succ], torch.zeros_like(eye))
    clo = A + eye
    for _ in range(max(1, (max(S, 2) - 1).bit_length())):
        clo = torch.clamp(clo @ clo, max=1.0)
    # v is on a cycle iff a path v -> succ(v) ->* v exists
    on_cycle = (A * clo.T).sum(dim=1) > 0
    if ok is not None:
        # mutual reachability = the member set of v's cycle; drop cycles
        # with any member that is not ok
        mutual = (clo * clo.T) > 0
        cycle_bad = (mutual & ~ok[None, :]).any(dim=1)
        on_cycle = on_cycle & ~cycle_bad
    return (A * on_cycle[:, None]).to(_I32)


def _stack_push_pop(free_stack, n_free, n_pop, n_push, vacated, n_in):
    """Batched free-stack update after landing (``[V, n]`` stack, ``[V]``
    counts, ``[V, P]`` vacated plan): pops lower the head; the net-excess
    vacated slots ``vacated[v, n_in : n_in + n_push]`` are pushed through
    a read-modify-write of one contiguous window per vrank (the same
    window the reference updates, so every stack entry, live or not,
    matches its bits), in place: only the ``[V, min(P, n)]`` window is
    written. Returns ``(free_stack, n_free)``."""
    n = free_stack.shape[1]
    P = vacated.shape[1]
    W = min(P, n)
    new_n_free = n_free - n_pop + n_push
    win_start = n_free.clamp(0, max(n - W, 0))
    w_idx = torch.arange(W, dtype=_I32, device=free_stack.device)[None, :]
    win_idx = (win_start[:, None] + w_idx).long()
    window = torch.gather(free_stack, 1, win_idx)
    rel = (n_free - win_start)[:, None]  # stack head inside the window
    src = (n_in[:, None] - rel + w_idx).clamp(0, P - 1)
    pushes = torch.gather(vacated, 1, src.long())
    use = (w_idx >= rel) & (w_idx < rel + n_push[:, None])
    window = torch.where(use, pushes, window)
    return free_stack.scatter_(1, win_idx, window), new_n_free


def _plan_rows_batched(seg_starts, seg_counts, order, length: int,
                       seg_rows=None, row_stride: int = None):
    """Expand per-segment (start in sorted space, count) pairs into row
    plans: entry ``[v, j]`` is the resident column of the ``j``-th planned
    row of plan row ``v`` (segments in order, the first ``count`` rows of
    each). Entries ``j >= total`` are clipped junk; callers mask them.

    ``seg_starts``/``seg_counts`` ``[V, S]``, ``order`` ``[V, n]``;
    returns ``(plan [V, length], totals [V])``. ``seg_rows`` ``[S]`` maps
    segment ``s`` to the row of ``order`` it reads (arrival plans); the
    entries are then GLOBALIZED to ``seg_row * row_stride + column``
    (``row_stride`` defaults to ``n``). The segment lookup is an integer
    binary search plus gathers (the reference telescopes it through a
    float einsum as a TPU workaround; the values are equal)."""
    V, S = seg_counts.shape
    n = order.shape[-1]
    stride = n if row_stride is None else row_stride
    dev = order.device
    cum = torch.cat(
        [
            torch.zeros((V, 1), dtype=_I32, device=dev),
            torch.cumsum(seg_counts, dim=1, dtype=_I32),
        ],
        dim=1,
    )  # [V, S+1]
    j = torch.arange(length, dtype=_I32, device=dev)
    seg = torch.searchsorted(
        cum[:, 1:].contiguous(), j.expand(V, -1).contiguous(), right=True
    ).clamp_max(S - 1)  # [V, length], int64
    starts_g = torch.gather(seg_starts.to(_I32), 1, seg)
    cum_g = torch.gather(cum, 1, seg)
    pos = (starts_g + (j[None, :] - cum_g)).clamp(0, n - 1)
    if seg_rows is not None:
        row_g = seg_rows.to(_I32)[seg]
    else:
        row_g = torch.arange(V, dtype=_I32, device=dev)[:, None]
    vac = order.reshape(-1)[(row_g * n + pos).reshape(-1).long()].reshape(
        V, length
    )
    if seg_rows is not None:
        vac = row_g * stride + vac
    return vac, cum[:, -1]


def _grant_tables(counts, starts, n_free, M: int):
    """The receiver-granted ``[V_src, V_dst]`` send table of one device,
    from the leavers' per-destination ``counts`` and segment ``starts``
    (``[V, V]``), each vrank's free slots ``n_free`` and the per-step
    budget ``M``: a per-source prefix truncation to ``M``, pairwise swaps
    (self-financing) trimmed to the ``[M]`` arrival plan, then a monotone
    fixpoint over the free slots plus the slots each receiver's own
    departures vacate. Returns ``(allowed, pending)``: the grants, and
    the rows each pair still wants after them (what the cycle rescue
    reads). The dense step and the sparse engine share it, so under the
    sparse guard both grant the same table. Its ``mig:grant`` span holds
    the fixpoint's ``V`` host iterations."""
    with span("mig:grant"):
        V = counts.shape[0]
        dev = counts.device
        rel_start = starts - starts[:, :1]
        rel_end = rel_start + counts
        eff = (
            torch.clamp_max(rel_end, M) - torch.clamp_max(rel_start, M)
        ).clamp_min(0)
        swap = torch.minimum(eff, eff.T)
        swap = _greedy_alloc(swap, torch.full((V,), M, dtype=_I32,
                                              device=dev))
        swap = torch.minimum(swap, swap.T)
        res_eff = eff - swap
        res = torch.zeros_like(eff)
        recv_room = M - swap.sum(dim=0, dtype=_I32)
        for _ in range(V):
            cap_res = torch.minimum(
                recv_room, n_free + res.sum(dim=1, dtype=_I32)
            )
            res = _greedy_alloc(res_eff, cap_res.clamp_min(0))
        return swap + res, res_eff - res


def _land(flat, free_stack, n_free, vacated, arr_cols, n_sent, n_in,
          impl: str, plain: bool, stop_after: int = None):
    """Land every vrank's arrivals with ONE scatter and update the free
    stack. ``vacated`` ``[V, P]`` is the vacated-slot plan (the leavers in
    send order), ``arr_cols`` ``[K, V, P]`` the gathered arrival columns.
    Per vrank, arrival ``k`` fills vacated slot ``k`` while both last,
    then popped holes; vacated slots past the arrivals get zero columns
    (holes, alive row 0) and are pushed on the stack. Returns ``(flat,
    free_stack, n_free)``, all updated in place where they can be.
    ``stop_after`` 6 returns after the landing plan, 7 after the scatter
    (the knockout phases of the dense step)."""
    V, n = free_stack.shape
    K = flat.shape[0]
    P = vacated.shape[1]
    dev = flat.device
    my_v = torch.arange(V, dtype=_I32, device=dev)
    k_idx = torch.arange(P, dtype=_I32, device=dev)[None, :]
    ns = n_sent[:, None]
    ni = n_in[:, None]
    n_pop = torch.minimum((n_in - n_sent).clamp_min(0), n_free)
    # pops walk the stack head downward: nf-1, nf-2, ... (a clamped
    # gather; entries outside the pop range are never read)
    pop_idx = (n_free[:, None] - 1 - (k_idx - ns)).clamp(0, n - 1)
    pops = torch.gather(free_stack, 1, pop_idx.long())
    sentinel = torch.full_like(vacated, n)
    targets = torch.where(
        k_idx < torch.minimum(ni, ns),
        vacated,
        torch.where(
            (k_idx >= ns) & (k_idx < ns + n_pop[:, None]),
            pops,
            torch.where((k_idx >= ni) & (k_idx < ns), vacated, sentinel),
        ),
    )  # [V, P] local targets, sentinel n
    gtargets = torch.where(
        targets >= n, torch.full_like(targets, V * n),
        my_v[:, None] * n + targets,
    )
    cols = torch.where(
        (k_idx < ni)[None], arr_cols, torch.zeros_like(arr_cols)
    )
    if stop_after == 6:
        return flat, free_stack, n_free
    flat = _land_scatter(
        flat, gtargets.reshape(-1), cols.reshape(K, V * P), impl, plain
    )
    if stop_after == 7:
        return flat, free_stack, n_free
    n_push = (n_sent - n_in).clamp_min(0)
    free_stack, n_free = _stack_push_pop(
        free_stack, n_free, n_pop, n_push, vacated, n_in
    )
    return flat, free_stack, n_free


# gridlint: fastpath-engine
def _fast_step(flat, free_stack, n_free, block_rows, loc_starts, allowed,
               n_sent, n_in, plain: bool):
    """The mover-sparse fast branch, run when the guard holds: the mover
    block ``[V, B]`` IS the vacated-slot plan (under the guard the dense
    plan is the leaver prefix of the sorted order, which the block
    reproduces bit for bit), arrivals gather ``B`` columns per vrank and
    one landing writes them; stayer columns are never read or written.
    Returns ``(MigrateState, MigrateStats)`` without ``fast_path``."""
    with traced_span("mig:fast"):
        return _fast_step_body(flat, free_stack, n_free, block_rows,
                               loc_starts, allowed, n_sent, n_in, plain)


def _fast_step_body(flat, free_stack, n_free, block_rows, loc_starts,
                    allowed, n_sent, n_in, plain: bool):
    V, n = free_stack.shape
    B = block_rows.shape[1]
    dev = flat.device
    with span("mig:pack"):
        arr_src, _ = _plan_rows_batched(
            loc_starts.T, allowed.T, block_rows, B,
            seg_rows=torch.arange(V, dtype=_I32, device=dev), row_stride=n,
        )  # [V_dst, B] global source columns
        arr_cols = gather_plan_cols(flat, arr_src)  # [K, V, B]
    with span("mig:unpack"):
        # kernel 2, where the reference takes its XLA scatter: the TPU
        # overlay is O(n * plan), but kernel 2 writes each update straight
        # to its column, O(plan) — the same flat[:, targets] = cols with
        # unique targets
        flat, free_stack, new_free = _land(
            flat, free_stack, n_free, block_rows, arr_cols, n_sent, n_in,
            "overlay", plain,
        )
    zeros = torch.zeros((V,), dtype=_I32, device=dev)
    stats = MigrateStats(
        sent=n_sent,
        received=n_in,
        # the stack invariant population == n - n_free: an O(V) read
        # where the dense step reduces the alive row
        population=(n - new_free).to(_I32),
        backlog=zeros,
        dropped_recv=zeros.clone(),
        flow=allowed,
    )
    return MigrateState(flat, free_stack, new_free), stats


def balanced_assignment(cell_loads, n_ranks: int) -> tuple:
    """Static cell -> rank map equalizing per-rank load (host-side LPT,
    "longest processing time first"): cells heaviest first (a stable
    order, so ties keep cell order), each to the first least-loaded rank.
    ``cell_loads`` is the per-cell ownership histogram (``[n_cells]``
    row-major). Returns a tuple of int for :func:`shard_migrate_vranks_fn`'s
    ``assignment`` (paired with the cell grid as ``cells``); the largest
    bin is at most 4/3 of the optimum, so slabs can be sized near the
    mean load rather than the hottest cell's."""
    loads = np.asarray(cell_loads, dtype=np.int64)
    if loads.ndim != 1 or loads.size < n_ranks:
        raise ValueError(
            f"need >= {n_ranks} cells, got shape {loads.shape}"
        )
    order = np.argsort(-loads, kind="stable")
    bins = np.zeros((n_ranks,), np.int64)
    assign = np.zeros(loads.shape, np.int32)
    for c in order:
        r = int(np.argmin(bins))
        assign[c] = r
        bins[r] += loads[c]
    return tuple(int(x) for x in assign)


def _land_remote(flat, free_stack, n_free, pool, recv_counts, C: int):
    """Land each vrank's arrivals from other devices into popped holes:
    ``pool [V, K, S * C]`` holds ``C`` slots a global source, the first
    ``recv_counts[v, s]`` of source ``s`` real. Arrival ``k`` takes the
    stack entry ``n_free - 1 - k``; arrivals past the free slots drop and
    are counted (they cannot happen under the grants). One masked indexed
    assignment, as the reference's XLA scatter (not kernel 2, which lands
    the local arrivals); the mask reads one count on the host. Returns
    ``(flat, n_free, n_in, dropped)``."""
    V, n = free_stack.shape
    K = flat.shape[0]
    S = recv_counts.shape[1]
    P_rem = S * C
    dev = flat.device
    kr = torch.arange(P_rem, dtype=_I32, device=dev)
    cum = torch.cat([
        torch.zeros((V, 1), dtype=_I32, device=dev),
        torch.cumsum(recv_counts, dim=1, dtype=_I32),
    ], dim=1)  # [V, S + 1]
    n_in = cum[:, -1]
    src = torch.searchsorted(
        cum[:, 1:].contiguous(), kr.expand(V, -1).contiguous(), right=True
    ).clamp_max(S - 1)
    slot = (src.to(_I32) * C + (kr[None, :] - torch.gather(cum, 1, src))
            ).clamp(0, P_rem - 1)
    arrivals = torch.gather(pool, 2, slot[:, None, :].long().expand(
        V, K, P_rem))
    n_pop = torch.minimum(n_in, n_free)
    pop_i = (n_free[:, None] - 1 - kr[None, :]).clamp(0, n - 1)
    tgt = torch.where(kr[None, :] < n_pop[:, None],
                      torch.gather(free_stack, 1, pop_i.long()),
                      torch.full((), n, dtype=_I32, device=dev))
    my_v = torch.arange(V, dtype=_I32, device=dev)[:, None]
    gtgt = torch.where(tgt >= n, torch.full((), V * n, dtype=_I32,
                                            device=dev), my_v * n + tgt)
    cols = torch.where((kr[None, :] < n_in[:, None])[:, None, :], arrivals,
                       torch.zeros((), dtype=pool.dtype, device=dev))
    flat = _land_scatter(flat, gtgt.reshape(-1),
                         cols.permute(1, 0, 2).reshape(K, V * P_rem), "xla")
    return flat, n_free - n_pop, n_in, (n_in - n_pop).to(_I32)


def shard_migrate_vranks_fn(
    domain: Domain,
    dev_grid: ProcessGrid,
    vgrid: ProcessGrid,
    capacity: int,
    local_budget: int = None,
    scatter_impl=None,
    mover_cap: int = None,
    plain: bool = False,
    cells: ProcessGrid = None,
    assignment: tuple = None,
    mesh=None,
):
    """Migration over ``V = vgrid.nranks`` vranks a device, planar
    layout: ``fn(state, dest_key=None) -> (state, MigrateStats)`` with
    ``state.fused [K, V * n]`` (int32, or the legacy float32 layout),
    ``free_stack [V, n]``, ``n_free [V]``.

    The full grid is ``dev_grid.shape * vgrid.shape``. With one device
    every vrank lives here; with ``dev_grid.nranks > 1`` each device is a
    rank of ``mesh`` (default: :func:`~.mesh.make_mesh` of ``dev_grid``),
    one process each, and this function is that rank's part. Traffic
    between vranks of one device lands through the local plans; traffic
    to other devices is RECEIVER-GRANTED over the mesh (desired counts
    fly in one all-to-all, each destination vrank grants within its free
    slots, grants fly back) and rides one ``[Dev, V_src, V_dst, K, C]``
    all-to-all, ``capacity`` columns a (source vrank, destination vrank)
    pair; arrivals from other devices land in popped holes. The global
    cycle rescue (up to 128 ranks) gathers the pending matrix so rotation
    cycles spanning devices drain too. Stats are this device's ``[V]``
    rows (``flow`` ``[V, Dev * V]``, device-major global ranks).

    ``dest_key`` ``[V, n]`` (the destination's device-major global rank,
    sentinel ``Dev * V`` on stayers and holes) is what the fused drift-bin
    kernel emits on one device; without it the step bins the position
    rows itself with the same arithmetic. ``local_budget`` (default ``V *
    capacity``) bounds the rows a vrank sends or receives on its device
    per step; the landing scatter is sized to it. ``scatter_impl`` picks
    the dense landing route (:func:`_resolve_scatter_impl`, once, here).
    ``mover_cap`` builds the mover-sparse engine with a ``[V, mover_cap]``
    mover block (clamped to ``n``), on one device only: each step reads
    its guard on the host once (:data:`HOST_SYNCS`) and runs the fast
    branch or the dense step, and the stats carry ``fast_path``; where the
    selection cannot be built for the shape (or ``MPI_GRID_SELECT=flat``)
    every step runs dense with ``fast_path`` all 0. ``plain=True`` runs
    every kernel's plain PyTorch version even on the GPU (the reference
    run a kernel is held against).

    ``cells`` (the spatial cell grid, e.g. 4x4x4) with ``assignment`` (a
    tuple mapping each row-major cell id to a global rank ``dev * V + v``,
    typically :func:`balanced_assignment` of a measured histogram) is the
    load-balanced decomposition: each vrank owns a SET of cells, so the
    slabs can be sized near the mean load. Only the binning changes (the
    cell id, then one gather from the table); the grants and the landing
    work on rank ids as before. A ``dest_key`` passed in must then come
    from the same binning, never from the canonical vrank grid."""
    V = vgrid.nranks
    D = domain.ndim
    Dev = dev_grid.nranks
    C = capacity
    R_total = Dev * V
    if (cells is None) != (assignment is None):
        raise ValueError("cells and assignment must be passed together")
    if assignment is not None:
        if len(assignment) != cells.nranks:
            raise ValueError(
                f"assignment has {len(assignment)} entries for "
                f"{cells.nranks} cells"
            )
        bad = [g for g in assignment if not 0 <= g < R_total]
        if bad:
            raise ValueError(
                f"assignment targets outside [0, {R_total}): {bad[:4]}"
            )
    M = V * C if local_budget is None else int(local_budget)
    # static plan lengths: most rows a vrank can send / receive in a step
    P = M + ((Dev - 1) * V * C if Dev > 1 else 0)
    if Dev > 1 and R_total > 128:
        warnings.warn(
            f"global cycle_rescue disabled: {R_total} global ranks > 128 "
            f"(the all-gathered [R, R] boolean-closure cost grows as "
            f"R^2 log R). Per-device cycles still drain, but rotation "
            f"cycles SPANNING devices will backlog -- watch "
            f"utils.stats.detect_stall.",
            stacklevel=2,
        )
    impl = _resolve_scatter_impl(scatter_impl)
    mesh = mesh_lib.mesh_for(dev_grid, mesh) if Dev > 1 else None
    me_dev = 0 if mesh is None else mesh.rank
    loc0 = me_dev * V
    table = None  # the cell -> rank table, on the state's device
    if assignment is not None:
        table = OnDevice(np.asarray(assignment, np.int32))
    full_grid = ProcessGrid(
        tuple(d * v for d, v in zip(dev_grid.shape, vgrid.shape)),
        axis_names=dev_grid.axis_names,
    )

    def _remote_grants(counts, n_free):
        """The receiver-granted cross-device send table: ``(desired_rem,
        rem_sent [V, R_total], recv_rem [V_dst, R_total])``."""
        dev = counts.device
        g = torch.arange(R_total, dtype=_I32, device=dev)
        local = (g >= loc0) & (g < loc0 + V)
        desired = torch.where(local[None, :], 0, counts.clamp(max=C))
        # [V_src, Dev, V_dst] -> [Dev, V_src, V_dst]: chunk d to device d
        recv_desired = col.all_to_all(
            desired.reshape(V, Dev, V).permute(1, 0, 2), mesh
        ).permute(2, 0, 1).reshape(V, R_total)  # [V_dst, S_global]
        grants = _greedy_alloc(recv_desired.T, n_free.clamp_min(0)).T
        grants_back = col.all_to_all(
            grants.reshape(V, Dev, V).permute(1, 0, 2), mesh
        ).permute(2, 0, 1).reshape(V, R_total)  # [V_src, G_dst]
        # actual arrivals == my grants (each within its source's desire)
        return desired, torch.minimum(desired, grants_back), grants

    def _global_rescue(allowed, pending_loc, desired_rem, rem_sent,
                       recv_rem, sent_remote):
        """Force one row along every rotation cycle of the GLOBAL pending
        matrix (cycles spanning devices included): returns the updated
        ``(allowed, rem_sent, recv_rem)``."""
        dev = allowed.device
        pending_rows = desired_rem - rem_sent  # local columns are 0
        pending_rows[:, loc0:loc0 + V] = pending_loc
        sent_loc = allowed.sum(dim=1, dtype=_I32)
        recv_loc = allowed.sum(dim=0, dtype=_I32)

        def gat(x):
            return col.all_gather(x, mesh).reshape((R_total,)
                                                   + tuple(x.shape[1:]))

        pending_g = gat(pending_rows)
        sends_zero_g = gat(sent_loc + sent_remote) == 0
        sent_loc_g = gat(sent_loc)
        recv_loc_g = gat(recv_loc)
        rem_sent_g = gat(rem_sent)
        g_all = torch.arange(R_total, dtype=_I32, device=dev)
        succ = torch.argmax((pending_g > 0).to(_I32), dim=1)
        same_dev = torch.div(succ, V, rounding_mode="floor") == torch.div(
            g_all, V, rounding_mode="floor")
        # each member's guard on ITS forced edge: a local edge needs room
        # in both [M] plans, a remote one a free slot of its pair buffer
        ok = torch.where(
            same_dev,
            (sent_loc_g < M) & (recv_loc_g[succ] < M),
            rem_sent_g[g_all.long(), succ] < C,
        )
        F = _cycle_rescue(pending_g, sends_zero_g, ok)
        F_rows = F[loc0:loc0 + V]  # my vranks' forced sends
        local = (g_all >= loc0) & (g_all < loc0 + V)
        allowed = allowed + F_rows[:, loc0:loc0 + V]
        rem_sent = rem_sent + torch.where(local[None, :], 0, F_rows)
        F_cols = F[:, loc0:loc0 + V]  # forced arrivals, by global source
        recv_rem = recv_rem + torch.where(local[:, None], 0, F_cols).T
        return allowed, rem_sent, recv_rem

    def _remote_send(flat, order, bounds, rem_sent):
        """Pack the granted cross-device rows and exchange them: the
        ``[V_dst, K, Dev * V * C]`` arrival pools."""
        dev = flat.device
        K = flat.shape[0]
        n = flat.shape[1] // V
        my_v = torch.arange(V, dtype=_I32, device=dev)
        c_i = torch.arange(C, dtype=_I32, device=dev)
        valid = c_i[None, None, :] < rem_sent[:, :, None]  # [V, R_total, C]
        pos = (bounds[:, :R_total, None] + c_i).clamp(0, n - 1)
        row = order.reshape(-1)[
            (my_v[:, None] * n + pos.reshape(V, -1)).reshape(-1).long()
        ].reshape(V, R_total, C)
        gsrc = my_v[:, None, None] * n + row
        vals = torch.index_select(flat, 1, gsrc.reshape(-1).long()).reshape(
            K, V, Dev, V, C)
        send = torch.where(valid.reshape(V, Dev, V, C)[None], vals,
                           torch.zeros((), dtype=flat.dtype, device=dev))
        # [K, V_src, Dev, V_dst, C] -> [Dev, V_src, V_dst, K, C]
        recv = col.all_to_all(send.permute(2, 1, 3, 0, 4).contiguous(), mesh)
        return recv.permute(2, 3, 0, 1, 4).reshape(V, K, Dev * V * C)

    def _step(flat, free_stack, n_free, dest_key, stop_after=None):
        """One dense step, O(residents). ``stop_after`` (one device only)
        returns ``(state, None)`` after knockout phase 2 (the sort and
        counts), 3 (the grant tables and cycle rescue), 4 (the
        vacated-slot plan), 5 (the arrival gather), 6 (the landing plan)
        or 7 (the landing scatter); phase 8 is the whole step."""
        dev = flat.device

        def cut():
            return MigrateState(flat, free_stack, n_free), None

        K = flat.shape[0]
        n = flat.shape[1] // V
        my_v = torch.arange(V, dtype=_I32, device=dev)
        with span("mig:bin"):
            order, counts, bounds = binning.sorted_dest_counts_batched(
                dest_key, R_total
            )  # [V, n], [V, R_total], [V, R_total + 1]
        if stop_after == 2:
            return cut()
        leavers = counts.sum(dim=1, dtype=_I32)
        loc_counts = counts[:, loc0:loc0 + V]
        loc_starts = bounds[:, loc0:loc0 + V]
        zeros = torch.zeros((V,), dtype=_I32, device=dev)
        sent_remote = zeros
        n_free_local = n_free
        if Dev > 1:
            desired_rem, rem_sent, recv_rem = _remote_grants(counts, n_free)
            sent_remote = rem_sent.sum(dim=1, dtype=_I32)
            # free slots promised to remote arrivals are off the table for
            # local ones; the receiver's own remote sends vacate slots
            n_free_local = (n_free - recv_rem.sum(dim=1, dtype=_I32)
                            + sent_remote)
        allowed, pending = _grant_tables(loc_counts, loc_starts,
                                         n_free_local, M)
        if Dev == 1 or R_total > 128:
            # drain full-vrank rotation cycles on this device; a cycle is
            # forced only if every member stays within the [M] plans
            sends_zero = (allowed.sum(dim=1, dtype=_I32) + sent_remote) == 0
            ok = (allowed.sum(dim=1, dtype=_I32) < M) & (
                allowed.sum(dim=0, dtype=_I32) < M
            )
            allowed = allowed + _cycle_rescue(pending, sends_zero, ok)
        else:
            allowed, rem_sent, recv_rem = _global_rescue(
                allowed, pending, desired_rem, rem_sent, recv_rem,
                sent_remote)
            sent_remote = rem_sent.sum(dim=1, dtype=_I32)
        n_in = allowed.sum(dim=0, dtype=_I32)
        n_sent = allowed.sum(dim=1, dtype=_I32) + sent_remote
        if stop_after == 3:
            return cut()
        if Dev > 1:
            with span("mig:exchange"):
                pools = _remote_send(flat, order, bounds, rem_sent)
            # segments: the V local pairs, then every global rank
            vacated, _ = _plan_rows_batched(
                torch.cat([loc_starts, bounds[:, :R_total]], dim=1),
                torch.cat([allowed, rem_sent], dim=1), order, P)
        else:
            vacated, _ = _plan_rows_batched(loc_starts, allowed, order, P)
        if stop_after == 4:
            return cut()
        with span("mig:pack"):
            # dst w reads source s's sorted space at segment (s -> w)
            arr_src, _ = _plan_rows_batched(
                loc_starts.T, allowed.T, order, M, seg_rows=my_v,
            )  # [V_dst, M] global source columns
            arr_cols = gather_plan_cols(flat, arr_src)  # [K, V, M]
            if P > M:
                arr_cols = torch.cat([arr_cols, torch.zeros(
                    (K, V, P - M), dtype=arr_cols.dtype, device=dev)], dim=2)
        if stop_after == 5:
            return cut()
        with span("mig:unpack"):
            flat, free_stack, n_free = _land(
                flat, free_stack, n_free, vacated, arr_cols, n_sent, n_in,
                impl, plain, stop_after,
            )
            if stop_after in (6, 7):
                return cut()
            dropped_recv = zeros
            if Dev > 1:
                # arrivals from other devices pop holes, after the local
                # landing pushed the slots its departures vacated
                flat, n_free, n_in_rem, dropped_recv = _land_remote(
                    flat, free_stack, n_free, pools, recv_rem, C)
                n_in = n_in + n_in_rem

        population = (flat[-1, :].reshape(V, n) > 0).sum(dim=1, dtype=_I32)
        flow = allowed
        if Dev > 1:
            # my rows of the global flow matrix: remote grants with the
            # local block overlaid
            flow = rem_sent.clone()
            flow[:, loc0:loc0 + V] = allowed
        stats = MigrateStats(
            sent=n_sent,
            received=n_in,
            population=population,
            backlog=leavers - n_sent,
            dropped_recv=dropped_recv,
            flow=flow,
        )
        return MigrateState(flat, free_stack, n_free), stats

    def fn(state: MigrateState, dest_key: torch.Tensor = None,
           _stop_after: int = None):
        # _stop_after: the knockout cut (bench/knockout_stages.py) of the
        # dense step on one device; 1 returns before any step work
        flat, free_stack, n_free = state
        if _stop_after is not None and (Dev > 1 or mover_cap is not None):
            raise ValueError("_stop_after cuts the one-device dense step")
        if _stop_after == 1:
            return state, None
        dev = flat.device
        n = flat.shape[1] // V
        if dest_key is None:
            pos = flat[:D].view(torch.float32)
            alive = flat[-1] > 0
            if table is None and Dev > 1:
                dest_key = binning.dest_key_planar_ranks(
                    pos, alive, domain, dev_grid, vgrid, me_dev)
            else:
                dest_key = binning.dest_key_planar(
                    pos, alive, domain,
                    full_grid if table is None else cells, V, R_total,
                    assignment=None if table is None else table.get(dev)[0],
                    me_dev=me_dev,
                )
        B = None
        if mover_cap is not None and Dev == 1:
            B = max(1, min(int(mover_cap), n))
            chunk, cap = binning.sparse_select_params(n, B)
            if not binning.sparse_select_feasible(n, V, chunk=chunk, cap=cap):
                B = None
        if B is None:
            out, stats = _step(flat, free_stack, n_free, dest_key,
                               _stop_after)
            if mover_cap is not None:
                stats = stats._replace(
                    fast_path=torch.zeros((V,), dtype=_I32, device=dev)
                )
            return out, stats

        with span("mig:select"):
            block_rows, counts, bounds, ok_sel = binning.sorted_mover_block(
                dest_key, V, B, chunk=chunk, cap=cap
            )  # [V, B], [V, V], [V, V + 1]
        loc_starts = bounds[:, :V]
        allowed, _ = _grant_tables(counts, loc_starts, n_free, M)
        n_sent = allowed.sum(dim=1, dtype=_I32)
        n_in = allowed.sum(dim=0, dtype=_I32)
        # the guard: the block holds every leaver exactly; nothing was
        # clipped by budget, free slots or grants (allowed <= eff <=
        # counts, so equality means zero backlog and an idle cycle
        # rescue); the arrivals fit the [B] plan. The reference's
        # lax.cond has no sync-free eager form: read it once, run one
        # branch.
        guard = ok_sel & (allowed == counts).all() & (n_in <= B).all()
        # the one guard read a step (gridlint G002 sanctions it here)
        taken = host_read(HOST_SYNCS, "sparse_guard",  # gridlint: disable=G002
                          guard)
        if taken:
            out, stats = _fast_step(
                flat, free_stack, n_free, block_rows, loc_starts, allowed,
                n_sent, n_in, plain,
            )
        else:
            # the guard read false: the dense step, a span of its own so a
            # trace counts the fallbacks and labels their device time
            with span("mig:fallback"):
                out, stats = _step(flat, free_stack, n_free, dest_key)
        return out, stats._replace(
            fast_path=torch.full((V,), 1 if taken else 0, dtype=_I32,
                                 device=dev)
        )

    return fn


def _land_arrivals(fused, free_stack, n_free, recv, recv_counts, send_counts,
                   gather_idx, capacity: int, impl: str, plain: bool):
    """The flat engine's landing: arrivals into vacated slots, then popped
    holes. ``recv`` is the planar ``[K, n_src * C]`` arrival pool (the
    first ``recv_counts[s]`` of each source's ``C`` slots valid);
    ``send_counts``/``gather_idx`` describe this rank's own sends, whose
    slots are vacated. One landing scatter writes arrivals, hole markers
    and the alive row; the free-stack push is a blend over the same plan.
    Returns ``(fused, free_stack, n_free, n_in, dropped_recv)``."""
    n = fused.shape[1]
    C = capacity
    dev = fused.device
    n_dest = send_counts.shape[0]
    n_src = recv_counts.shape[0]
    P = max(n_src, n_dest) * C
    n_sent = send_counts.sum(dtype=_I32)
    n_in = recv_counts.sum(dtype=_I32)
    zero = torch.zeros((1,), dtype=_I32, device=dev)
    cum_send = torch.cat([zero, torch.cumsum(send_counts, 0, dtype=_I32)])
    cum_recv = torch.cat([zero, torch.cumsum(recv_counts, 0, dtype=_I32)])
    k = torch.arange(P, dtype=_I32, device=dev)
    d = _segment_of(k, cum_send).long()
    vacated = gather_idx[
        (d.to(_I32) * C + (k - cum_send[d])).clamp(0, n_dest * C - 1).long()
    ].to(_I32)  # first n_sent entries: vacated slot ids
    s = _segment_of(k, cum_recv).long()
    arrivals = recv[:, (s.to(_I32) * C + (k - cum_recv[s])).clamp(
        0, n_src * C - 1).long()]
    n_pop = (n_in - n_sent).clamp(min=0).minimum(n_free)
    dropped_recv = (n_in - n_sent - n_free).clamp(min=0).to(_I32)
    pop_idx = (n_free - 1 - (k - n_sent)).clamp(0, n - 1)
    sentinel = torch.full((), n, dtype=_I32, device=dev)
    target = torch.where(
        k < torch.minimum(n_in, n_sent),
        vacated,
        torch.where(
            (k >= n_sent) & (k < n_sent + n_pop),
            free_stack[pop_idx.long()],
            torch.where((k >= n_in) & (k < n_sent), vacated, sentinel),
        ),
    )
    cols = torch.where((k < n_in)[None, :], arrivals,
                       torch.zeros((), dtype=recv.dtype, device=dev))
    fused = _land_scatter(fused, target, cols, impl, plain)
    # push the net-excess departures (written as holes at vacated[n_in :
    # n_sent]); n_pop and n_push exclude each other
    n_push = (n_sent - n_in).clamp(min=0)
    base = n_free - n_pop
    s_idx = torch.arange(n, dtype=_I32, device=dev)
    push_vals = vacated[(n_in + s_idx - base).clamp(0, P - 1).long()]
    free_stack = torch.where((s_idx >= base) & (s_idx < base + n_push),
                             push_vals, free_stack)
    return fused, free_stack, base + n_push, n_in, dropped_recv


def shard_migrate_fused_fn(domain: Domain, grid: ProcessGrid, capacity: int,
                           mesh=None, plain: bool = False):
    """Migration with one rank a process (the flat engine), one rank's
    part: ``fn(state) -> (state, MigrateStats)`` on ``state.fused [K, n]``
    (position rows ``0:ndim``, alive row last), ``free_stack [n]`` and a
    scalar ``n_free`` (:func:`init_state` with ``batched=False``). Stats
    are this rank's ``[1]`` entries (``flow`` ``[1, R]``).

    Receiver-side flow control (lossless receive): desired counts (at most
    ``capacity`` a destination) fly in one all-to-all, each receiver
    grants pairwise swaps (self-financing) plus a greedy share of its free
    slots, the grants fly back, and only granted rows are packed and
    exchanged; the rest stay resident and retry (``backlog``). Up to 128
    ranks the cycle rescue gathers every rank's pending row and forces
    one row along each stalled rotation cycle. The landing route is
    :func:`_resolve_scatter_impl`'s default. ``mesh`` defaults to
    :func:`~.mesh.make_mesh` of ``grid``.

    ``fn.issue(state) -> InflightExchange`` and ``fn.complete(state,
    inflight) -> (state, stats)`` are its two halves, and ``fn(state)``
    is ``fn.complete(state, fn.issue(state))``."""
    R = grid.nranks
    C = capacity
    D = domain.ndim
    rescue = R <= 128
    if not rescue:
        warnings.warn(
            f"cycle_rescue disabled: {R} ranks > 128 (the all-gathered "
            f"[R, R] boolean-closure cost grows as R^2 log R). Full-shard "
            f"rotation cycles will backlog instead of draining -- watch "
            f"utils.stats.detect_stall.",
            stacklevel=2,
        )
    impl = _resolve_scatter_impl(None)
    mesh = mesh_lib.mesh_for(grid, mesh)
    me = mesh.rank
    one = ProcessGrid((1,) * grid.ndim, axis_names=grid.axis_names)

    def issue(state: MigrateState) -> InflightExchange:
        """The issue half: bin, grant, pack and the wire. The resident
        state is not touched (sent rows stay until the landing vacates
        them)."""
        fused, free_stack, n_free = state
        K = fused.shape[0]
        key = binning.dest_key_planar_ranks(
            fused[:D].view(torch.float32), fused[-1] > 0, domain, grid,
            one, me)  # [1, n]
        order, full_counts, bounds = binning.sorted_dest_counts_batched(
            key, R)
        order, full_counts, bounds = order[0], full_counts[0], bounds[0]
        desired = full_counts.clamp(max=C)
        recv_desired = col.all_to_all(desired, mesh)
        swap = torch.minimum(recv_desired, desired)
        resid = _greedy_alloc((recv_desired - swap)[:, None],
                              n_free.clamp(min=0).reshape(1))[:, 0]
        grants = swap + resid  # what I allow each source to send me
        send_counts = torch.minimum(desired,
                                    col.all_to_all(grants, mesh))
        recv_counts = grants  # each sender sends exactly what I granted
        if rescue:
            pend_all = col.all_gather(desired - send_counts, mesh)
            sent_tot = col.all_gather(send_counts.sum(dtype=_I32), mesh)
            F = _cycle_rescue(pend_all, sent_tot == 0)
            send_counts = send_counts + F[me]
            recv_counts = recv_counts + F[:, me]
        backlog = (full_counts - send_counts).sum(dtype=_I32)
        send, gather_idx = pack_cols(fused, order, bounds[:R], send_counts,
                                     R, C)
        recv = col.all_to_all(send, mesh, dim=1)  # [K, R * C]
        return InflightExchange(recv, recv_counts, send_counts, gather_idx,
                                backlog)

    def complete(state: MigrateState, inflight: InflightExchange):
        """The complete half: land the exchanged rows (the free-stack
        update rides the landing) and assemble the stats."""
        fused, free_stack, n_free = state
        fused, free_stack, n_free, n_in, dropped_recv = _land_arrivals(
            fused, free_stack, n_free, inflight.recv, inflight.recv_counts,
            inflight.send_counts, inflight.gather_idx, C, impl, plain,
        )
        stats = MigrateStats(
            sent=inflight.send_counts.sum(dtype=_I32).reshape(1),
            received=n_in.reshape(1),
            population=(fused[-1, :] > 0).sum(dtype=_I32).reshape(1),
            backlog=inflight.backlog.reshape(1),
            dropped_recv=dropped_recv.reshape(1),
            flow=inflight.send_counts[None],
        )
        return MigrateState(fused, free_stack, n_free), stats

    def fn(state: MigrateState):
        return complete(state, issue(state))

    # the halves are the engine and fn their composition; the two-phase
    # surface (exchange.start_exchange / finish_exchange) calls them
    fn.issue = issue
    fn.complete = complete
    return fn


class VrankPlan(NamedTuple):
    """One step's routing from :class:`VrankTwoPhase`'s ``issue``: the
    senders' vacated-slot plan, the receivers' arrival plan (GLOBAL
    columns of the ``[K, V * n]`` matrix), the granted and desired
    ``[V_src, V_dst]`` tables and the per-source ``backlog`` (leavers the
    grants held back). Plans are ``n`` wide, so the grant is the only
    clip: ``backlog == 0`` means every leaver was granted."""

    vacated: torch.Tensor  # [V, n] local vacated slots (first n_sent)
    n_sent: torch.Tensor  # [V]
    arr_plan: torch.Tensor  # [V, n] global arrival source columns
    n_in: torch.Tensor  # [V]
    allowed: torch.Tensor  # [V, V] granted sends [src, dst]
    desired: torch.Tensor  # [V, V] leaver counts before the grants
    backlog: torch.Tensor  # [V] leavers held back a source


class VrankTwoPhase(NamedTuple):
    """The two-phase exchange of V vranks on one device
    (:func:`vrank_exchange_two_phase_fn`): ``bin_key`` gives each
    column's destination key, ``issue`` a key's :class:`VrankPlan`,
    ``land`` lands a gathered arrival payload in one scatter with the
    free-stack update beside it. Step k's plan and payload can wait a
    whole step while step k+1 drifts and bins."""

    bin_key: object
    issue: object
    land: object
    vranks: int
    n_local: int


def vrank_exchange_two_phase_fn(
    domain: Domain, vgrid: ProcessGrid, n_local: int, ndim: int = None,
    cycle_rescue: bool = True, scatter_impl=None,
) -> VrankTwoPhase:
    """The vrank planar two-phase exchange on one device: the ``V =
    vgrid.nranks`` vranks are column blocks of ``[K, V * n]``, so the
    wire is a column gather and the two halves may be a step apart. The
    semantics are :func:`shard_migrate_fused_fn`'s (receiver-granted
    flow control, the cycle rescue, one landing scatter) at plan width
    ``n = n_local``: no plan clips, so ``backlog`` is exactly what the
    grants held back.

    The landing keeps :func:`_land_scatter`'s uniqueness invariant: per
    vrank the targets are vacated slots (disjoint prefixes of a sort
    permutation) and popped stack entries (distinct hole ids), on
    disjoint column blocks. Its scatter is ``scatter_impl``'s route
    (:func:`_resolve_scatter_impl`; kernel 2 on the card by default, at
    any row count: the augmented payload of the pipelined chunk has
    ``K = 9``)."""
    V = vgrid.nranks
    n = int(n_local)
    D = domain.ndim if ndim is None else ndim
    rescue = cycle_rescue and V <= 128
    impl = _resolve_scatter_impl(scatter_impl)

    def bin_key(fused: torch.Tensor) -> torch.Tensor:
        """``[K, V * n]`` int32 -> ``[V, n]`` destination-vrank key, the
        sentinel ``V`` on stayers and holes. Routing is
        :func:`~..ops.binning.rank_of_position_planar`, the canonical
        planar engines' own."""
        m = fused.shape[1]
        alive = fused[-1] > 0
        me = torch.arange(m, dtype=_I32, device=fused.device) // n
        dest = binning.rank_of_position_planar(
            fused[:D].view(torch.float32), domain, vgrid)
        return torch.where(alive & (dest != me), dest, V).reshape(V, n)

    def issue(key: torch.Tensor, n_free: torch.Tensor) -> VrankPlan:
        """Routing sort, receiver-granted flow control, the cycle rescue
        and both plans. It reads the key and the free counts only, never
        the payload."""
        dev = key.device
        order, counts, bounds = binning.sorted_dest_counts_batched(key, V)
        desired = counts  # [V_src, V_dst]
        swap = torch.minimum(desired, desired.T)
        allowed = swap + _greedy_alloc(desired - swap, n_free.clamp_min(0))
        if rescue:
            F = _cycle_rescue(desired - allowed,
                              allowed.sum(dim=1, dtype=_I32) == 0)
            allowed = allowed + F
        backlog = (desired - allowed).sum(dim=1, dtype=_I32)
        starts = bounds[:, :-1]
        vacated, n_sent = _plan_rows_batched(starts, allowed, order, n)
        arr_plan, n_in = _plan_rows_batched(
            starts.T, allowed.T, order, n,
            seg_rows=torch.arange(V, dtype=_I32, device=dev))
        return VrankPlan(vacated, n_sent, arr_plan, n_in, allowed, desired,
                         backlog)

    def land(fused, free_stack, n_free, arr, vacated, n_sent, n_in):
        """Land a gathered ``[K, V, n]`` arrival payload: ONE scatter
        writes payload, alive row and hole markers for every vrank (in
        place on ``fused``), and the free stack takes the pushes as one
        full-width blend. Any row count: the caller may land an augmented
        matrix (an extra key row). Returns ``(fused, free_stack, n_free,
        dropped [V])``."""
        Kx = fused.shape[0]
        dev = fused.device
        k_idx = torch.arange(n, dtype=_I32, device=dev)[None, :]
        ns = n_sent[:, None]
        ni = n_in[:, None]
        n_pop = torch.minimum((n_in - n_sent).clamp_min(0), n_free)
        dropped = (n_in - n_sent - n_free).clamp_min(0).to(_I32)
        pop_idx = (n_free[:, None] - 1 - (k_idx - ns)).clamp(0, n - 1)
        popped = torch.gather(free_stack, 1, pop_idx.long())
        target = torch.where(
            k_idx < torch.minimum(ni, ns),
            vacated,
            torch.where(
                (k_idx >= ns) & (k_idx < ns + n_pop[:, None]),
                popped,
                torch.where((k_idx >= ni) & (k_idx < ns), vacated, n),
            ),
        )  # [V, n] local targets, sentinel n
        v_off = torch.arange(V, dtype=_I32, device=dev)[:, None]
        gtarget = torch.where(target >= n, V * n, v_off * n + target)
        cols = torch.where((k_idx < ni)[None], arr, torch.zeros_like(arr))
        fused = _land_scatter(fused, gtarget.reshape(-1),
                              cols.reshape(Kx, V * n), impl)
        n_push = (n_sent - n_in).clamp_min(0)
        base = n_free - n_pop
        push_vals = torch.gather(
            vacated, 1, (ni + k_idx - base[:, None]).clamp(0, n - 1).long())
        free_stack = torch.where(
            (k_idx >= base[:, None]) & (k_idx < (base + n_push)[:, None]),
            push_vals, free_stack)
        return fused, free_stack, base + n_push, dropped

    return VrankTwoPhase(bin_key, issue, land, V, n)


def gather_migrate_stats(stats: MigrateStats, mesh) -> MigrateStats:
    """Every rank's stats rows stacked in rank order along the rank axis
    (the last axis of the ``[S, V]`` leaves, the second-last of ``flow``):
    the reference's global ``[S, R]`` stats, the same on every rank."""
    def g(t, axis):
        if t is None:
            return None
        parts = col.all_gather(t, mesh)  # [Dev, ...]
        return torch.cat(list(parts.unbind(0)), dim=axis)

    fields = MigrateStats._fields
    return MigrateStats(*(
        g(getattr(stats, f), -2 if f == "flow" else -1) for f in fields))


def shard_migrate_fn(domain: Domain, grid: ProcessGrid, capacity: int,
                     mesh=None, plain: bool = False):
    """Per-field wrapper over the flat engine, one rank's part: ``fn(pos
    [n, D], alive [n] bool, *fields) -> (pos, alive, *fields,
    MigrateStats)`` with the same shapes (rows where ``alive`` is False
    are holes; fields 32-bit, see :func:`fuse_fields`). Each call fuses,
    builds the free stack and unfuses; a loop carries a
    :class:`MigrateState` instead (``models.nbody.make_migrate_loop``)."""
    fused_fn = shard_migrate_fused_fn(domain, grid, capacity, mesh=mesh,
                                      plain=plain)

    def fn(pos, alive, *fields):
        fused, specs = fuse_fields((pos,) + tuple(fields), alive)
        state, stats = fused_fn(init_state(fused))
        out, alive_new = unfuse_fields(state.fused, specs)
        return (out[0], alive_new) + tuple(out[1:]) + (stats,)

    return fn
