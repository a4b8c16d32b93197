"""One card's part of a run: set-up, the timed (or traced) window, and the
comparison with the reference.

:func:`run_rank` makes this card's rows from the seed, builds the loop
(:mod:`.program`; with ``control`` the reference in a lower precision
stands in its place), warms up every shape the window uses, and calls the
loop back to back for ``seconds``: each call's outputs are the next
call's inputs.
Then it frees the program's state and judges the final rows, and the
densities of a few calls drawn from the seed, against the reference
(:mod:`.reference`), which follows every step the program ran.

A cell of the one-shot call (:func:`run_oneshot`) calls
``redistribute()`` back to back on its snapshots in turn, each call's
input untouched by the one before but for the traffic's edit of a few
rows; it judges the last call's output and one drawn from the seed
(copied as it comes back), each against the reference's receive order of
that call's input.
"""

from __future__ import annotations

import gc
import itertools
import sys
import time

import numpy as np
import torch

from benchmark import program, reference, state, trace
from benchmark.spec import Cell

WARM_CALLS = 2  # the first builds and loads the kernels, the second is warm
TRACE_SECONDS = 2.0  # the traced window, at most
RHO_SAMPLES = 2  # densities drawn from the seed, besides the last
# the limit of rho_gap; the other numbers are exact, with the limit 0
RHO_GAP_LIMIT = 8e-7


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Solo:
    """The collective calls of a run on one card."""

    world = 1

    def decide(self, flag: bool) -> bool:
        return flag

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return t


class Group:
    """The same over a gloo group of the cards' processes (host tensors, so
    the harness adds no work to the cards' streams): rank 0 decides when
    the window ends, sums go to every rank."""

    def __init__(self, rank: int, world: int):
        import torch.distributed as dist

        self.dist = dist
        self.world = world
        self.group = dist.new_group(backend="gloo")

    def decide(self, flag: bool) -> bool:
        t = torch.tensor([int(flag)], dtype=torch.int64)
        self.dist.broadcast(t, 0, group=self.group)
        return bool(t[0])

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        t = t.cpu()
        self.dist.all_reduce(t, group=self.group)
        return t


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


CONTROLS = ("drift_bf16", "deposit_f32")


def _turning(cell: Cell, step):
    """``step`` with the turns of clustered rows (:func:`state.turn`, part
    of the traffic) made before each call; ``step`` itself for rows that
    never turn."""
    if cell.turn_calls is None:
        return step
    calls = itertools.count()

    def turned(st):
        with torch.profiler.record_function(trace.TURN):
            state.turn(st[1], next(calls), cell.turn_calls)
        return step(st)

    return turned


def _drift(cell: Cell, pos, vel, alive, precision: str = "f32"):
    return reference.Drift(pos, vel, alive, cell.dt, precision=precision,
                           turn_calls=cell.turn_calls,
                           steps_per_call=cell.steps_per_call)


def control_step(cell: Cell, pos, vel, alive, control: str):
    """The reference in the program's place, one stage computed in the
    nearest precision below the configuration's: ``drift_bf16``, the drift
    and wrap in bfloat16 (positions are float32); ``deposit_f32``, the
    density summed in float32 (the scan engine sums in double-float)."""
    if control not in CONTROLS:
        raise ValueError(f"control {control!r}: one of {CONTROLS}")
    drift = _drift(cell, pos, vel, alive,
                   "bf16" if control == "drift_bf16" else "f32")

    def step(st):
        drift.advance(cell.steps_per_call)
        rho = None
        if cell.deposit_shape is not None:
            rho = reference.cic_density(drift.pos, cell.deposit_shape,
                                        dtype=torch.float32)
        return drift, rho

    return step, drift


def _emit(cell: Cell, st, rank: int):
    if isinstance(st, reference.Drift):
        return st.pos, st.vel, reference.owner_slab(cell, st.pos)
    return program.emit(cell, st, rank)


def _window(step, st, seconds: float, comm, device, sample: set,
            keep_stats: bool):
    """Call ``step`` back to back until rank 0 has seen ``seconds`` pass.
    Returns the state, the number of calls, the window's seconds, each
    call's milliseconds, the sampled densities and the calls' stats."""
    cuda = device.type == "cuda"
    _sync(device)
    events, host = [], []
    if cuda:
        events.append(torch.cuda.Event(enable_timing=True))
        events[0].record()
    t0 = time.perf_counter()
    calls, rhos, stats = 0, {}, []
    rho = None
    while True:
        with torch.profiler.record_function(trace.CALL):
            st, rho = step(st)
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        else:
            host.append(time.perf_counter())
        if rho is not None and calls in sample:
            rhos[calls] = rho.clone()
        if keep_stats and not isinstance(st, reference.Drift):
            stats.append(st[3])
        calls += 1
        if comm.decide(time.perf_counter() - t0 >= seconds):
            break
    _sync(device)
    t1 = time.perf_counter()
    if cuda:
        call_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    else:
        call_ms = list(np.diff([t0] + host) * 1e3)
    if rho is not None:
        rhos[calls - 1] = rho
    return st, calls, t1 - t0, call_ms, rhos, stats


def run_rank(cell: Cell, seed: int, seconds: float, traced: bool, rank: int,
             comm, device, control: str = None, mesh=None) -> dict:
    """This card's run; returns what the line needs from it. ``control``
    names the control (:data:`CONTROLS`) run in the program's place."""
    if cell.entry == "redistribute":
        return run_oneshot(cell, seed, seconds, traced, comm, device, control)
    device = torch.device(device)
    S = cell.steps_per_call
    # the draw completes a cell under an assignment (its table, its sizes)
    cell, pos, vel, alive = state.draw(cell, seed, rank, device)
    step = None if control else _turning(cell,
                                         program.build(cell, device, mesh))
    if control:
        step, st = control_step(cell, pos, vel, alive, control)
    else:
        st = (pos, vel, alive, None)
    del pos, vel, alive
    warm_s = 0.0
    for _ in range(WARM_CALLS):
        _sync(device)
        t = time.perf_counter()
        st, _ = step(st)
        _sync(device)
        warm_s = time.perf_counter() - t
    rng = np.random.default_rng(state.card_seed(seed, 1 << 20))
    n_est = max(1, int(seconds / max(warm_s, 1e-3)))
    sample = set(int(c) for c in
                 rng.choice(n_est, size=min(RHO_SAMPLES, n_est),
                            replace=False))
    launches0 = {} if control else program.kernel_launches()
    out = {"rank": rank, "setup_end": time.time(), "warm_call_s": warm_s}
    if device.type == "cuda":
        out["kind"] = torch.cuda.get_device_name(device)
        out["mem_setup"] = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    if traced:
        def traced_window():
            with torch.profiler.record_function(trace.WINDOW):
                res = _window(step, st, min(seconds, TRACE_SECONDS), comm,
                              device, sample, keep_stats=True)
            return res

        res, tr = trace.profile(traced_window)
    else:
        res = _window(step, st, seconds, comm, device, sample, False)
    st, calls, window_s, call_ms, rhos, stats = res
    out.update(calls=calls, window_s=window_s, call_ms=call_ms,
               steps=calls * S)
    if device.type == "cuda":
        out["mem_window"] = torch.cuda.max_memory_allocated(device)
    if not control:
        launches = program.kernel_launches()
        out["launches_per_step"] = {
            k: (launches.get(k, 0) - launches0.get(k, 0)) / (calls * S)
            for k in launches if launches.get(k, 0) != launches0.get(k, 0)}
    if traced:
        busy, win = tr.busy_us()
        both = torch.zeros(2 * comm.world, dtype=torch.float64)
        both[2 * rank:2 * rank + 2] = torch.tensor([busy, win])
        both = comm.sum(both).tolist()
        ctx = trace.Context(
            cell=cell, kind=out.get("kind", "cpu"), trace=tr, rank=rank,
            stats=program.stats_arrays(stats) if stats else {},
            cards=list(zip(both[::2], both[1::2])))
        linked = sum(1 for d in tr.device if d[3] in tr.launches)
        log(f"trace: {len(tr.device)} device operations, {linked} with "
            f"their launch, {len(tr.ranges)} host ranges, window "
            f"{win * 1e-6:.3f} s, busy {busy * 1e-6:.3f} s")
        out.update(metrics=trace.read_all(ctx), busy_s=busy * 1e-6,
                   trace_window_s=win * 1e-6, breakdown=tr.breakdown())
        del tr, ctx, stats
    prog = digest(cell, st, rank)
    del st, res, step  # the program's state, freed before the reference
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = judge(cell, seed, rank, comm, device, prog, rhos,
                          (WARM_CALLS + calls) * S)
    return out


def digest(cell: Cell, st, rank: int) -> torch.Tensor:
    """This card's output condensed on the host: the count and the
    fingerprint of every slab, then the live rows that lie on a slab
    that does not own their position."""
    p, v, slab = _emit(cell, st, rank)
    count, fp = reference.digests(p, v, slab, cell.n_slabs)
    misplaced = (reference.owner_slab(cell, p) != slab).sum().reshape(1)
    return torch.cat([count, fp, misplaced]).cpu()


def judge(cell: Cell, seed: int, rank: int, comm, device, prog, rhos: dict,
          total_steps: int) -> dict:
    """The compared numbers, each summed over the cards: ``count_gap``,
    the live rows a slab holds against what the reference puts there,
    summed over slabs as absolute differences; ``misplaced_rows``, live
    rows on a slab that does not own their position; ``slabs_differing``,
    slabs whose count or fingerprint differs from the reference's;
    ``rho_gap`` (with a deposit), the largest difference of a sampled
    call's density from the reference's, over the reference's mean.
    ``prog`` is :func:`digest` of the program's output."""
    n = cell.n_slabs
    # the reference's own draw: its rows, and its own assignment of them
    rcell, pos0, vel0, alive0 = state.draw(cell, seed, rank, device)
    drift = _drift(cell, pos0, vel0, alive0)
    del pos0, vel0, alive0
    S = cell.steps_per_call
    rho_gap = None
    for c in sorted(rhos):
        drift.advance((WARM_CALLS + c + 1) * S - drift.steps)
        ref = reference.cic_density(drift.pos, cell.deposit_shape)
        gap = float((rhos[c].double() - ref).abs().max() / ref.mean())
        rho_gap = gap if rho_gap is None else max(rho_gap, gap)
    drift.advance(total_steps - drift.steps)
    rslab = reference.owner_slab(rcell, drift.pos)
    rcount, rfp = reference.digests(drift.pos, drift.vel, rslab, n)
    both = comm.sum(torch.cat([prog, rcount.cpu(), rfp.cpu()]))
    count, fp, mis = both[:n], both[n:2 * n], both[2 * n]
    rcount, rfp = both[2 * n + 1:3 * n + 1], both[3 * n + 1:]
    checks = {
        "count_gap": {"value": int((count - rcount).abs().sum()), "limit": 0},
        "misplaced_rows": {"value": int(mis), "limit": 0},
        "slabs_differing": {
            "value": int(((count != rcount) | (fp != rfp)).sum()),
            "limit": 0},
    }
    if rho_gap is not None:
        checks["rho_gap"] = {"value": rho_gap, "limit": RHO_GAP_LIMIT}
    return checks


# the one-shot call: two calibrating calls of "grow", then one calibrated
# call on each snapshot, the last of them held as the window holds its
# sample, so the window runs the calibrated path only
ONESHOT_WARM = 4
ONESHOT_SAMPLES = 1  # calls drawn from the seed and judged besides the last
ONESHOT_CONTROLS = ("bin_bf16",)


class _Calls:
    """``step(state) -> (result, None)``: call ``i`` of ``call`` on
    snapshot ``i % len(snaps)``, whatever the state, after the traffic's
    edit of that snapshot (:class:`state.Edits`). The results of the calls
    in ``keep`` are copied into ``held``, into buffers that :meth:`reserve`
    allocates in set-up: holding a result itself would make the allocator
    grow inside the window."""

    def __init__(self, call, snaps, edits):
        self.call, self.snaps, self.edits = call, snaps, edits
        self.i = 0
        self.keep, self.held, self.spare = set(), {}, []

    def reserve(self, like, n: int) -> None:
        """``n`` buffers shaped as the result ``like``."""
        self.spare = [(torch.empty_like(like[0]),
                       (torch.empty_like(like[1][0]),),
                       torch.empty_like(like[2])) for _ in range(n)]

    def release(self) -> None:
        """The held buffers back to the spares, ``keep`` emptied."""
        self.spare += self.held.values()
        self.held, self.keep = {}, set()

    def _hold(self, out):
        buf = self.spare.pop()
        if buf[0].shape != out[0].shape:
            raise RuntimeError(f"call {self.i}: the output's shape "
                               f"{tuple(out[0].shape)} is not set-up's "
                               f"{tuple(buf[0].shape)}")
        for b, o in ((buf[0], out[0]), (buf[1][0], out[1][0]),
                     (buf[2], out[2])):
            b.copy_(o)
        return buf

    def __call__(self, st):
        snap = self.snaps[self.i % len(self.snaps)]
        with torch.profiler.record_function(trace.EDIT):
            self.edits.apply(snap)
        out = self.call(snap)
        if self.i in self.keep:
            self.held[self.i] = self._hold(out)
        self.i += 1
        return out, None


def _padded(cell: Cell, pos, vel, counts):
    """Rows grouped by slab (:func:`reference.receive_order`) in the
    call's output layout: ``(pos [S * n, 3], (vel [S * n, 3],), count
    [S], None)``, slab ``s`` in rows ``[s * n, s * n + count[s])``, zeros
    after them."""
    S, n = cell.n_slabs, cell.n_local
    dev = pos.device
    slab = torch.repeat_interleave(torch.arange(S, device=dev), counts)
    i = torch.arange(pos.shape[0], device=dev) - (torch.cumsum(counts, 0)
                                                  - counts)[slab]
    ok = i < n
    slot = slab[ok] * n + i[ok]
    out_p = torch.zeros((S * n, 3), dtype=pos.dtype, device=dev)
    out_v = torch.zeros((S * n, 3), dtype=vel.dtype, device=dev)
    out_p[slot] = pos[ok]
    out_v[slot] = vel[ok]
    return out_p, (out_v,), counts.clamp(max=n).to(torch.int32), None


def oneshot_control(cell: Cell, control: str):
    """The reference in the one-shot call's place, its owners taken from
    positions rounded to bfloat16 (``bin_bf16``; the call bins float32)."""
    if control not in ONESHOT_CONTROLS:
        raise ValueError(f"control {control!r} is for the drift loop; the "
                         f"one-shot call's controls are {ONESHOT_CONTROLS}")

    def call(snapshot):
        pos, vel, count = snapshot
        return _padded(cell, *reference.receive_order(
            cell, pos, vel, count, bin_pos=pos.bfloat16().float()))

    return call


def oneshot_digest(cell: Cell, out, rank_slab: list) -> dict:
    """A call's output condensed on its device, by slab: ``count [S]``,
    ``hashes [S, out_capacity]`` (:func:`reference.row_hash` of each live
    row at its place, 0 after the count) and ``misplaced``, the live rows
    on a slab that does not own their position. ``out`` is the call's
    ``(positions, (vel,), count, ...)``; API rank ``r``'s output lies on
    slab ``rank_slab[r]``."""
    pos, vel = out[0], out[1][0]
    R, dev = len(rank_slab), pos.device
    oc = pos.shape[0] // R
    counts = out[2].cpu().tolist()
    count = torch.zeros(cell.n_slabs, dtype=torch.int64, device=dev)
    hashes = torch.zeros((cell.n_slabs, oc), dtype=torch.int64, device=dev)
    misplaced = torch.zeros((), dtype=torch.int64, device=dev)
    for r, s in enumerate(rank_slab):
        c = min(int(counts[r]), oc)
        p, v = pos[r * oc:r * oc + c], vel[r * oc:r * oc + c]
        count[s] = c
        hashes[s, :c] = reference.row_hashes(p, v)
        misplaced += (reference.owner_slab(cell, p.T) != s).sum()
    return {"count": count, "hashes": hashes, "misplaced": int(misplaced)}


def judge_oneshot(cell: Cell, seed: int, device, digests: dict) -> dict:
    """The compared numbers of the one-shot call, summed over the judged
    calls (``digests``: call index -> :func:`oneshot_digest`), each
    against the reference's receive order of that call's input, the
    snapshot drawn again with its edits made again (:func:`state.inputs`):
    ``count_gap``, ``misplaced_rows`` and ``slabs_differing`` as in
    :func:`judge`, and ``order_gap``, the live output rows whose six
    float32 bit patterns (by their hash) differ from the reference's row
    at the same place of the slab's receive order, or that have no row
    there."""
    S = cell.n_slabs
    tot = dict.fromkeys(("count_gap", "misplaced_rows", "slabs_differing",
                         "order_gap"), 0)
    for call, snap in state.inputs(cell, seed, device, max(digests) + 1):
        if call not in digests:
            continue
        dg = digests[call]
        rp, rv, rc = reference.receive_order(cell, *snap)
        rh = reference.row_hashes(rp, rv)
        del rp, rv
        slab = torch.repeat_interleave(torch.arange(S, device=rh.device), rc)
        rfp = torch.zeros(S, dtype=torch.int64, device=rh.device)
        rfp.index_add_(0, slab, rh)
        del slab
        pc, ph = dg["count"], dg["hashes"]
        i = torch.arange(ph.shape[1], device=ph.device)
        at = ((torch.cumsum(rc, 0) - rc)[:, None] + i).clamp_(
            max=max(rh.numel() - 1, 0))
        ref_h = rh[at] if rh.numel() else torch.zeros_like(ph)
        del at
        off = (i < pc[:, None]) & ((i >= rc[:, None]) | (ph != ref_h))
        tot["order_gap"] += int(off.sum())
        del ref_h, off
        tot["count_gap"] += int((pc - rc).abs().sum())
        tot["misplaced_rows"] += dg["misplaced"]
        tot["slabs_differing"] += int(((pc != rc) | (ph.sum(1) != rfp)).sum())
    return {k: {"value": v, "limit": 0} for k, v in tot.items()}


def run_oneshot(cell: Cell, seed: int, seconds: float, traced: bool, comm,
                device, control: str = None) -> dict:
    """:func:`run_rank` of a one-shot cell (one card): the snapshots from
    the seed, the instance (:func:`program.build_oneshot`; with
    ``control`` the reference in its place), :data:`ONESHOT_WARM` calls,
    the window, then the judged calls' digests, the program freed, and
    the comparison."""
    device = torch.device(device)
    snaps = state.snapshots(cell, seed, device)
    gr = None
    if control:
        call = oneshot_control(cell, control)
        rank_slab = list(range(cell.n_slabs))
    else:
        gr, call = program.build_oneshot(cell, device)
        rank_slab = reference.rank_slabs(cell)
    step = _Calls(call, snaps, state.Edits(cell, seed, device))
    st, warm_s = None, 0.0
    for i in range(ONESHOT_WARM):
        if i == 2:
            # calibrated from here: the sample's buffers, the last warm
            # call held in them as the window holds its sample
            step.reserve(st, ONESHOT_SAMPLES)
            step.keep = {ONESHOT_WARM - 1}
        _sync(device)
        t = time.perf_counter()
        st, _ = step(st)
        _sync(device)
        warm_s = time.perf_counter() - t
    step.release()
    if gr is not None:
        # the deferred check's first copy to pinned memory, made here
        gr.flush_overflow_checks()
        before = program.oneshot_report(gr)
        log(f"one-shot call: engine {before['engine']!r}, capacity "
            f"{before['capacity']}, out_capacity {before['out_capacity']}, "
            f"{before['blocking_fetches']} blocking reads in "
            f"{before['calls']} warm calls")
    span = min(seconds, TRACE_SECONDS) if traced else seconds
    n_est = max(1, int(span / max(warm_s, 1e-3)) // 2)
    rng = np.random.default_rng(state.card_seed(seed, 1 << 20))
    step.keep = {ONESHOT_WARM + int(c) for c in rng.choice(
        n_est, size=min(ONESHOT_SAMPLES, n_est), replace=False)}
    # the window's calls ignore the state: the last warm output, held
    # here, would lie beside the window's own outputs all through it
    st = None
    out = {"rank": 0, "setup_end": time.time(), "warm_call_s": warm_s}
    if device.type == "cuda":
        out["kind"] = torch.cuda.get_device_name(device)
        out["mem_setup"] = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        allocs = torch.cuda.memory_stats(device)["num_device_alloc"]
        reserved = torch.cuda.memory_reserved(device)
    if traced:
        def traced_window():
            with torch.profiler.record_function(trace.WINDOW):
                res = _window(step, st, span, comm, device, set(), False)
            return res

        res, tr = trace.profile(traced_window)
    else:
        res = _window(step, st, seconds, comm, device, set(), False)
    st, calls, window_s, call_ms, _, _ = res
    out.update(calls=calls, window_s=window_s, call_ms=call_ms, steps=calls)
    if device.type == "cuda":
        out["mem_window"] = torch.cuda.max_memory_allocated(device)
        allocs = torch.cuda.memory_stats(device)["num_device_alloc"] - allocs
        log(f"the allocator reserved {reserved} B before the window and "
            f"{torch.cuda.memory_reserved(device)} B after it, with {allocs} "
            f"device allocations in the window")
    counters = {}
    if gr is not None:
        after = program.oneshot_report(gr)
        gr.flush_overflow_checks()  # raises if a window dropped rows
        counters = {"calls": calls, "blocking_fetches":
                    after["blocking_fetches"] - before["blocking_fetches"]}
        log(f"one-shot call: engine {after['engine']!r}; {after['calls']} "
            f"calls made {after['attempts']} attempts, "
            f"{after['grows']} capacity grows, "
            f"{counters['blocking_fetches']} blocking reads in the window's "
            f"{calls} calls")
    if traced:
        busy, win = tr.busy_us()
        ctx = trace.Context(cell=cell, kind=out.get("kind", "cpu"), trace=tr,
                            rank=0, stats=counters, cards=[(busy, win)])
        log(f"trace: {len(tr.device)} device operations, "
            f"{len(tr.ranges)} host ranges, window {win * 1e-6:.3f} s, "
            f"busy {busy * 1e-6:.3f} s")
        out.update(metrics=trace.read_all(ctx), busy_s=busy * 1e-6,
                   trace_window_s=win * 1e-6, breakdown=tr.breakdown())
        del tr, ctx
    held = dict(step.held)
    held[step.i - 1] = st
    log(f"judged calls {sorted(held)} of {step.i}")
    digests = {c: oneshot_digest(cell, o, rank_slab) for c, o in held.items()}
    del st, res, step, held, snaps, call, gr  # the program, freed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    out["checks"] = judge_oneshot(cell, seed, device, digests)
    log(f"the reference judged {len(digests)} calls in "
        f"{time.perf_counter() - t:.2f} s")
    return out
