"""The software-pipelined chunk (port of the JAX package's
``service/pipeline.py``).

:mod:`.resident` runs each step's bin -> pack -> exchange -> unpack in
order. :func:`make_pipelined_chunk_fn` carries step k's issued exchange
(its plan and gathered arrival payload) beside step k+1's entry state,
and in the steady state drifts and bins step k+1 BEFORE it lands step
k's arrivals: the landing writes the arrivals already drifted for step
k+1, with their next-step key riding the same scatter as one more row.
The engine is the vrank planar two-phase pair
(:func:`..parallel.migrate.vrank_exchange_two_phase_fn`, resolved by
:func:`..parallel.exchange.resolve_two_phase`): ``issue`` reads only the
key and the free-slot counts, ``land`` writes payload, alive row and key
row in one scatter (kernel 2 on the card, at ``K = 8`` for the final
landing and ``K = 9`` with the key row). Routing is the canonical planar
engines' :func:`..ops.binning.rank_of_position_planar` and the drift
:func:`..models.nbody.service_drift`, so a chunk with no drop and no
backlog has the sequential chunk's particles bit for bit.

Degrading: chunk < 2, a payload that is not planar-eligible, a ragged
receive capacity, several devices or several pods, each journaled as
``engine_resolved`` with its ``"pipeline: ..."`` reason, build the
sequential chunk of :mod:`.resident` instead.

One ordering, decided on the device: the reference picks the pipelined
or the sequential ordering of the same two kernels each step with a
``lax.cond`` on a device flag (every mover granted). An ``if`` on that
flag here would read the device every step. The two orderings give the
same bits (the landing commutes with the elementwise drift column by
column; a withheld mover stays resident and its key, binned from the
drifted state, is the one the sequential ordering bins after landing),
so this port always runs the pipelined one; ``stats.pipeline`` still
reports the flag, 0 on steps whose grants withheld movers.
``tests/test_torch_pipeline.py`` holds a chunk with such backlog steps
bit-equal to the reference's, whose ``cond`` takes the sequential
ordering there. Nothing in the chunk reads the device back.
"""

from __future__ import annotations

import torch

from mpi_grid_redistribute_tpu_torch import api
from mpi_grid_redistribute_tpu_torch.models import nbody
from mpi_grid_redistribute_tpu_torch.ops import binning, pack, statehealth
from mpi_grid_redistribute_tpu_torch.parallel import exchange, migrate
from mpi_grid_redistribute_tpu_torch.service import resident
from mpi_grid_redistribute_tpu_torch.telemetry.phases import traced_span

_I32 = torch.int32


def _drift_compatible(specs, ndim) -> bool:
    """The pipelined engine drifts inside the planar matrix (position
    rows, then velocity rows, both float32 bit patterns): the payload
    must be float32 positions followed by a float32 velocity field of
    the same width."""
    if specs is None or len(specs) < 2:
        return False
    return (
        specs[0][1] == torch.float32
        and specs[1][1] == torch.float32
        and specs[0][2] == ndim
        and specs[1][2] == ndim
    )


def make_pipelined_chunk_fn(rd, dt, chunk, positions, *fields, unroll=8,
                            probes=None, _stop_after=None):
    """Build the software-pipelined macro-step: the arguments and return
    of :func:`..service.resident.make_chunk_fn`, ``(macro, cap,
    out_cap)`` with ``macro(pos, vel, ids, count) -> ((pos, vel, ids,
    count), ys)``; the stats gain ``pipeline`` (``[chunk, R]`` int32, 1
    where every mover of the step was granted).

    When :func:`..parallel.exchange.resolve_two_phase` degrades, this
    returns :func:`..service.resident.make_chunk_fn`'s macro (its
    ``ResidentLayoutError`` on a ragged carry included) and the reason
    is journaled on ``rd.telemetry``; ``unroll`` is passed on there and
    not used here.

    What the caller sees on the armed path, as in the reference: the
    rows within a rank come out in resident-slot order, compacted once at
    the end (the sequential chunk re-packs every step), so the particle
    SET, the counts and the drop accounting are the sequential chunk's
    (:func:`..service.elastic.particle_set` is the equality); leavers the
    grants withhold are reported as ``dropped_send`` (they stay
    resident), so a caller discards and re-runs such a chunk as it would
    an overflowing one; with ``probes`` armed the NaN/bounds/moment scans
    read the state at each step's issue point (after its drift, before
    its exchange) and ``live``/``residual`` the exact post-step counts,
    the ledger counting ``dropped_recv`` only.

    ``_stop_after`` is the knockout cut (``bench/knockout_pipeline.py``),
    not a public knob: every steady-state step runs its phases in order,
    1 drift, 2 bin, 5 landing, 3 issue, 4 arrival gather (the reference
    knockout's numbers), stops after the one named and drops what it
    made, so the next step starts from the same state; ``None`` runs
    whole steps.
    """
    if _stop_after not in (None, 1, 2, 3, 5):
        raise ValueError(f"_stop_after must be 1, 2, 3, 5 or None, got "
                         f"{_stop_after}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    R = 1 if rd.mesh is not None else rd.nranks
    if positions.ndim != 2 or positions.shape[0] % R:
        raise ValueError(
            f"positions must be [R*n_local, ndim] over {R} ranks, "
            f"got {tuple(positions.shape)}"
        )
    n_local = positions.shape[0] // R
    cap, out_cap = rd._capacities(n_local)
    specs = api._planar_specs(positions, fields)
    # the fused planar carry moves rows as 32-bit words: the 4-byte
    # contract _planar_specs guarantees, asserted on this path too (G004)
    planar_ok = (
        specs is not None
        and all(s[1].itemsize == 4 for s in specs)
        and rd.edges is None
        and _drift_compatible(specs, rd.domain.ndim)
    )
    handle = exchange.resolve_two_phase(
        rd.engine,
        chunk=chunk,
        planar_ok=planar_ok,
        ragged=out_cap != n_local,
        vranks=rd.mesh is None,
        n_devices=1 if rd.mesh is None else rd.mesh.size,
        n_pods=rd.n_pods,
        build=lambda: migrate.vrank_exchange_two_phase_fn(
            rd.domain, rd.grid, n_local, ndim=rd.domain.ndim),
        recorder=rd.telemetry,
    )
    if not handle.armed:
        if _stop_after is not None:
            raise ValueError("_stop_after cuts the armed pipelined step")
        return resident.make_chunk_fn(rd, dt, chunk, positions, *fields,
                                      unroll=unroll, probes=probes)
    tp = handle.bundle
    V, n = tp.vranks, tp.n_local
    D = rd.domain.ndim
    KP = sum(s[2] for s in specs)  # payload rows; the alive row is last
    dt = float(dt)
    armed = probes is not None and probes.armed

    def _probe(T, count, live0, cum):
        p = T[:D].view(torch.float32).T
        v = T[D:2 * D].view(torch.float32).T
        return statehealth.summarize_masked(
            p, v, T[-1] > 0, count.sum(dtype=_I32), live0, cum,
            probes.lo, probes.hi, probes.tier)

    def _drift(fused):
        """Drift the position rows ``[0, D)`` by the velocity rows ``[D,
        2D)`` of a planar int32 matrix (``[K, m]`` or ``[K, V, n]``),
        :func:`~..models.nbody.service_drift`'s arithmetic elementwise."""
        p = fused[:D].view(torch.float32)
        v = fused[D:2 * D].view(torch.float32)
        p2 = nbody.service_drift(p, v, dt)
        return torch.cat([p2.view(_I32), fused[D:]], dim=0)

    def _step_ys(plan, n_free):
        """Every per-step observable follows from the plan and the free
        counts at issue time, so the ys stream is in step order though
        each landing trails its issue by one step."""
        n_pop = torch.minimum((plan.n_in - plan.n_sent).clamp_min(0), n_free)
        n_push = (plan.n_sent - plan.n_in).clamp_min(0)
        count = (n - (n_free - n_pop + n_push)).to(_I32)
        dropped_recv = (plan.n_in - plan.n_sent - n_free).clamp_min(0).to(
            _I32)
        stay = (n - n_free) - plan.desired.sum(dim=1, dtype=_I32)
        sc = plan.allowed + torch.diag(stay + plan.backlog)
        feasible = plan.backlog.sum(dtype=_I32) == 0
        stats = exchange.RedistributeStats(
            send_counts=sc.to(_I32),
            recv_counts=sc.T.to(_I32),
            dropped_send=plan.backlog.to(_I32),
            dropped_recv=dropped_recv,
            needed_capacity=plan.desired.amax(dim=1).to(_I32),
            pipeline=feasible.to(_I32).expand(V),
        )
        return {"stats": stats, "count": count}

    def _issue(T, nf):
        """Put the current step's exchange in flight against the
        drifted state: its plan, its gathered arrival payload, its
        ys."""
        plan = tp.issue(tp.bin_key(T), nf)
        arr = pack.gather_plan_cols(T, plan.arr_plan)
        return plan, arr, _step_ys(plan, nf)

    def _pipe(T, stack, nf, arr, plan):
        """Step k+1's drift and binning before step k's landing: the
        arrivals are drifted in flight and their next-step key lands with
        them in the same scatter (no second pass)."""
        U = _drift(T)
        if _stop_after == 1:
            return None
        key_u = tp.bin_key(U)  # step k+1's binning, before the landing
        if _stop_after == 2:
            return None
        arr_u = _drift(arr)
        pos_a = arr_u[:D].view(torch.float32).transpose(0, 1)  # [V, D, n]
        dest_a = binning.rank_of_position_planar(pos_a, rd.domain, rd.grid)
        me = torch.arange(V, dtype=_I32, device=T.device)[:, None]
        key_a = torch.where((arr_u[-1] > 0) & (dest_a != me), dest_a, V)
        aug = torch.cat([U, key_u.reshape(1, V * n)], dim=0)
        arr_aug = torch.cat([arr_u, key_a[None].to(_I32)], dim=0)
        aug2, stack2, nf2, _ = tp.land(aug, stack, nf, arr_aug,
                                       plan.vacated, plan.n_sent, plan.n_in)
        T2 = aug2[:KP + 1]
        key2 = torch.where(T2[-1] > 0, aug2[KP + 1], V).reshape(V, n)
        return T2, stack2, nf2, key2

    # gridlint: resident-path
    def macro(pos, vel, ids, count):
        fused_p = api._fuse_planar(pos, (vel, ids), V, n, specs,
                                   stacked=False)
        dev = fused_p.device
        gcol = torch.arange(V * n, dtype=_I32, device=dev)
        alive0 = ((gcol % n) < count[(gcol // n).long()]).to(_I32)
        st = migrate.init_state(torch.cat([fused_p, alive0[None]], dim=0),
                                vranks=V, batched=True)
        live0 = count.sum(dtype=_I32)
        # prologue: step 1's drift and issue (nothing in flight yet)
        T = _drift(st.fused)
        stack, nf = st.free_stack, st.n_free
        plan, arr, ys = _issue(T, nf)
        if armed:
            cum = statehealth.step_dropped(ys["stats"], pipelined=True)
            ys["probe"] = _probe(T, ys["count"], live0, cum)
        steps = [ys]
        for _ in range(chunk - 1):
            with traced_span("pipe:land+drift"):
                landed = _pipe(T, stack, nf, arr, plan)
            if landed is None or _stop_after == 5:
                continue  # a knockout cut: the next step starts as this did
            T2, stack2, nf2, key = landed
            with traced_span("pipe:issue"):
                plan2 = tp.issue(key, nf2)
                ys = _step_ys(plan2, nf2)
                if _stop_after == 3:
                    continue
                arr = pack.gather_plan_cols(T2, plan2.arr_plan)
            T, stack, nf, plan = T2, stack2, nf2, plan2
            if armed:
                with traced_span("pipe:probe"):
                    cum = cum + statehealth.step_dropped(ys["stats"],
                                                         pipelined=True)
                    ys["probe"] = _probe(T, ys["count"], live0, cum)
            steps.append(ys)
        # epilogue: land step `chunk` (drifted at its issue) and compact
        # the resident slots once, live rows first in slot order
        Tf, _, _, _ = tp.land(T, stack, nf, arr, plan.vacated, plan.n_sent,
                              plan.n_in)
        alive = (Tf[-1] > 0).reshape(V, n)
        perm = torch.argsort(alive.logical_not().to(_I32), dim=1,
                             stable=True).to(_I32)
        gidx = (torch.arange(V, dtype=_I32, device=dev)[:, None] * n
                + perm).reshape(-1)
        compact = Tf.index_select(1, gidx)
        count_f = alive.sum(dim=1, dtype=_I32)
        pad = (torch.arange(n, dtype=_I32, device=dev)[None, :]
               < count_f[:, None]).reshape(-1)
        compact = torch.where(pad[None, :], compact,
                              torch.zeros_like(compact))
        pos_f, (vel_f, ids_f) = api._unfuse_planar(compact[:KP], specs, V, n,
                                                   stacked=False)
        return (pos_f, vel_f, ids_f, count_f), resident.stack_ys(steps)

    return macro, cap, out_cap
