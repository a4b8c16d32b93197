"""racecheck rules T001-T005 over the :class:`ThreadModel`.

Each rule is a pure query against the model built in
:mod:`mpi_grid_redistribute_tpu_torch.analysis.racecheck` — no AST walking
here. Messages are built from thread-root labels and lock names (never
line numbers), so a finding's :meth:`Finding.baseline_key` survives
unrelated edits to the file above it.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from mpi_grid_redistribute_tpu_torch.analysis.core import Finding
from mpi_grid_redistribute_tpu_torch.analysis.racecheck import (
    MAIN,
    Access,
    LockId,
    ThreadModel,
    lock_str,
    t_rule,
)

# the single-writer journal surfaces guarded by T005: mutating one of
# these from a thread root not marked '# racecheck: recorder-writer'
# breaks the "one declared writer, many snapshot readers" discipline
# the telemetry layer's locking is sized for
_JOURNAL_MUTATORS: Dict[str, frozenset] = {
    "StepRecorder": frozenset({"record", "record_at", "clear"}),
    "MetricsRegistry": frozenset({"counter", "gauge", "histogram"}),
}


def _labels_of(model: ThreadModel, accesses: List[Access]) -> Set[str]:
    out: Set[str] = set()
    for a in accesses:
        out |= model.roots_of(a.fnkey)
    return out


def _is_cross_thread(
    model: ThreadModel, accesses: List[Access], labels: Set[str]
) -> bool:
    """Heuristic G — the object-insensitivity mitigation.

    The matrix merges a class's fields across instances, so "two roots
    touch Cls.field" does not by itself mean they touch the SAME
    object.  We call the entry cross-thread only when:

    * two distinct SPAWNED roots reach it (each spawned root that can
      see the class at all sees the instance threaded into it — in this
      codebase, closure-captured), or
    * one spawned POOL root (handler methods, thread-in-a-loop) writes
      it — the pool races with itself on one instance, or
    * one spawned root plus ``main``, where some main-side access lives
      in the MODULE THAT CREATED the thread — main built the object and
      handed it to the thread, so they share the instance.  A main-side
      access in an unrelated module is (under this approximation) a
      different instance and stays quiet.
    """
    spawned = sorted(labels - {MAIN})
    if len(spawned) >= 2:
        return True
    if not spawned:
        return False
    root = model.root_by_label[spawned[0]]
    if root.multi:
        cl = model.reach.get(root.label, set())
        if any(a.op == "write" and a.fnkey in cl for a in accesses):
            return True
    if MAIN in labels:
        for a in accesses:
            if (
                MAIN in model.roots_of(a.fnkey)
                and a.relpath == root.relpath
            ):
                return True
    return False


@t_rule("T001")
def t001_unguarded_shared_write(model: ThreadModel) -> List[Finding]:
    """Unguarded cross-thread write to shared mutable state.

    For every (class, field) / (module, global) entry with at least one
    non-``__init__`` write: if the entry is cross-thread (heuristic G
    above), every non-init access site must hold one COMMON lock —
    guarding the writes but reading without the lock is still a torn
    read. ``__init__`` writes are pre-publication and exempt."""
    findings: List[Finding] = []
    for (owner, field), accs in sorted(
        model.shared_entries().items(),
        key=lambda kv: (kv[0][0], kv[0][1], kv[1][0].field),
    ):
        live = [a for a in accs if not a.init]
        writes = [a for a in live if a.op == "write"]
        if not writes:
            continue
        labels = _labels_of(model, live)
        if not _is_cross_thread(model, live, labels):
            continue
        common = None
        for a in live:
            common = a.locks if common is None else (common & a.locks)
        if common:
            continue
        unguarded = sorted(
            (a for a in live if not a.locks),
            key=lambda a: (a.relpath, a.line, a.col),
        )
        site = next(
            (a for a in unguarded if a.op == "write"),
            unguarded[0] if unguarded else writes[0],
        )
        sym = site.symbol
        findings.append(
            Finding(
                rule="T001",
                path=site.relpath,
                line=site.line,
                col=site.col,
                message=(
                    f"unguarded cross-thread write: '{sym}' is "
                    f"accessed from {{{', '.join(sorted(labels))}}} "
                    "with no common lock held at every access site"
                ),
                symbol=sym,
            )
        )
    return findings


@t_rule("T002")
def t002_lock_order_cycle(model: ThreadModel) -> List[Finding]:
    """Lock-acquisition-order cycles.

    Edges: lock A held while acquiring lock B — from lexical ``with``
    nesting, plus one interprocedural level (a call made while holding
    A whose resolved target's body acquires B). Any directed cycle is a
    potential deadlock; one finding per cycle, anchored at the
    lexically first edge site in it."""
    edges: Dict[Tuple[LockId, LockId], Tuple[str, int, str]] = dict(
        model.lock_edges
    )
    for f in model.fns.values():
        for cf in f.calls:
            if not cf.held:
                continue
            for tk in cf.targets:
                for lk, _ in model.fns[tk].direct_locks:
                    for h in cf.held:
                        if h != lk:
                            edges.setdefault(
                                (h, lk),
                                (f.relpath, cf.node.lineno, f.qual),
                            )
    graph: Dict[LockId, Set[LockId]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)

    findings: List[Finding] = []
    seen_cycles: Set[Tuple[LockId, ...]] = set()

    def dfs(start: LockId, node: LockId, path: List[LockId]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt == start:
                cyc = path[:]
                # canonical rotation so each cycle reports once
                i = cyc.index(min(cyc))
                canon = tuple(cyc[i:] + cyc[:i])
                if canon in seen_cycles:
                    continue
                seen_cycles.add(canon)
                sites = [
                    edges[(canon[j], canon[(j + 1) % len(canon)])]
                    for j in range(len(canon))
                ]
                site = min(sites)
                names = [lock_str(l) for l in canon]
                findings.append(
                    Finding(
                        rule="T002",
                        path=site[0],
                        line=site[1],
                        col=0,
                        message=(
                            "lock-acquisition-order cycle: "
                            + " -> ".join(names + [names[0]])
                            + " (potential deadlock; pick one global "
                            "order)"
                        ),
                        symbol=site[2],
                    )
                )
            elif nxt not in path:
                dfs(start, nxt, path + [nxt])

    for start in sorted(graph):
        dfs(start, start, [start])
    return findings


@t_rule("T003")
def t003_blocking_under_lock(model: ThreadModel) -> List[Finding]:
    """Blocking call while holding a lock.

    Direct sites (sleep / thread join / event wait / subprocess / file
    or socket I/O / ``block_until_ready`` with a lock lexically held)
    plus one interprocedural level: a call made while holding a lock
    whose resolved target blocks. A blocked lock holder stalls every
    thread contending for that lock — the recorder's contract is that
    its lock only ever guards memory ops."""
    findings: List[Finding] = []
    for f in model.fns.values():
        for b in f.blocking:
            if not b.held:
                continue
            locks = ", ".join(sorted(lock_str(l) for l in b.held))
            findings.append(
                Finding(
                    rule="T003",
                    path=f.relpath,
                    line=b.line,
                    col=b.col,
                    message=(
                        f"blocking call '{b.name}' while holding "
                        f"lock(s) {locks}"
                    ),
                    symbol=f.qual,
                )
            )
        for cf in f.calls:
            if not cf.held:
                continue
            locks = ", ".join(sorted(lock_str(l) for l in cf.held))
            for tk in cf.targets:
                tgt = model.fns[tk]
                blocked = sorted({b.name for b in tgt.blocking})
                if not blocked:
                    continue
                findings.append(
                    Finding(
                        rule="T003",
                        path=f.relpath,
                        line=cf.node.lineno,
                        col=cf.node.col_offset,
                        message=(
                            f"call to '{tgt.qual}' (which blocks via "
                            f"{', '.join(blocked)}) while holding "
                            f"lock(s) {locks}"
                        ),
                        symbol=f.qual,
                    )
                )
    return findings


@t_rule("T004")
def t004_escaping_service_thread(model: ThreadModel) -> List[Finding]:
    """Threads created in ``# gridlint: service-path`` modules must be
    ``daemon=True`` AND joined somewhere in the module.

    Service-path code is what operators Ctrl-C / SIGTERM: a non-daemon
    thread keeps the interpreter alive after the server loop exits, and
    an un-joined one can still be mid-write while teardown runs. The
    daemon flag is the safety net, the join is the clean path — the
    rule wants both."""
    findings: List[Finding] = []
    for root in model.roots:
        if root.kind != "thread":
            continue
        if not model.service_marked(root.relpath):
            continue
        problems = []
        if root.daemon is not True:
            problems.append(
                "daemon=True not set"
                if root.daemon is None
                else "daemon=False"
            )
        if not root.joined:
            problems.append("never joined in this module")
        if not problems:
            continue
        findings.append(
            Finding(
                rule="T004",
                path=root.relpath,
                line=root.line,
                col=0,
                message=(
                    f"thread '{root.target_desc}' escapes the service "
                    f"path: {'; '.join(problems)} (service-path "
                    "threads must be daemon AND joined on shutdown)"
                ),
                symbol=root.target_desc,
            )
        )
    return findings


@t_rule("T005")
def t005_undeclared_recorder_writer(model: ThreadModel) -> List[Finding]:
    """Journal mutation outside the declared single-writer thread.

    Call sites resolving to ``StepRecorder.record/record_at/clear`` or
    ``MetricsRegistry.counter/gauge/histogram`` must only be reachable
    from spawned roots whose target carries the
    ``# racecheck: recorder-writer`` marker (``main`` is always allowed
    — setup happens before threads exist). A receiver constructed in
    the SAME function is exempt: a fresh recorder/registry is
    thread-local by construction (the re-snapshot scrape path)."""
    findings: List[Finding] = []
    for f in model.fns.values():
        for cf in f.calls:
            hits = []
            for tk in cf.targets:
                tgt = model.fns[tk]
                if (
                    tgt.cls in _JOURNAL_MUTATORS
                    and tgt.name in _JOURNAL_MUTATORS[tgt.cls]
                ):
                    hits.append(f"{tgt.cls}.{tgt.name}")
            if not hits:
                continue
            if model.receiver_is_fresh_local(f, cf):
                continue
            offending = sorted(
                label
                for label in model.roots_of(f.key)
                if label != MAIN
                and not model.root_by_label[label].marked_writer
            )
            if not offending:
                continue
            sym = sorted(hits)[0]
            findings.append(
                Finding(
                    rule="T005",
                    path=f.relpath,
                    line=cf.node.lineno,
                    col=cf.node.col_offset,
                    message=(
                        f"{sym} mutation in '{f.qual}' is reachable "
                        f"from undeclared writer thread(s) "
                        f"{{{', '.join(offending)}}} — mark the "
                        "intended writer's target with '# racecheck: "
                        "recorder-writer' or route this thread through "
                        "a snapshot"
                    ),
                    symbol=sym,
                )
            )
    return findings
