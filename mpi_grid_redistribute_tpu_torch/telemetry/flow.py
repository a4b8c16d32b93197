"""Per-link flow attribution: who sends how much to whom (the port's copy
of the JAX package's ``telemetry/flow.py``).

* Capture costs nothing extra: both migrate engines compute the granted
  per-(source, dest) send-count table for their pack phase, and
  ``MigrateStats.flow`` stacks it (``[R, R]`` int32 a step, entry
  ``[i, j]`` = rows rank ``i`` sent rank ``j``);
  ``RedistributeStats.send_counts`` carries the same matrix.
* :func:`flow_matrix_of` normalizes either stats tuple to a step-major
  ``[S, R, R]`` host array (one device read).
* :class:`FlowAccumulator` is the host-side gauge: cumulative matrix,
  per-step EMA, population-imbalance gauge (max/mean), top-k hot pairs.
* :func:`record_flow_snapshot` journals a compact ``flow_snapshot``
  event (totals, imbalance, hot pairs; never the full matrix).
* :func:`link_report` turns per-pair rows into per-link moved bytes and
  bandwidth utilization against ONE link's roof: NVLink 4 for
  ``"nvlink"``, HBM3 for ``"hbm"`` (:mod:`..utils.profiling`).

Row sums of the matrix equal ``sent`` and column sums equal
``received`` exactly (sends are receiver-granted).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from mpi_grid_redistribute_tpu_torch.utils import profiling
from mpi_grid_redistribute_tpu_torch.utils.stats import host_arrays


def flow_matrix_of(stats) -> np.ndarray:
    """Normalize a stats pytree to a step-major ``[S, R, R]`` flow array.

    Accepts a ``MigrateStats`` (uses the ``flow`` leaf) or a
    ``RedistributeStats`` (uses ``send_counts``), single-call or
    step-stacked. Returns int64 (cumulative sums of int32 matrices can
    overflow at production step counts).
    """
    if hasattr(stats, "flow"):
        if stats.flow is None:
            raise ValueError(
                "MigrateStats.flow is None: this stats pytree predates "
                "the flow capture (hand-built fixture?) — the engines "
                "always populate it"
            )
        m = host_arrays([stats.flow])[0]
    elif hasattr(stats, "send_counts"):
        m = host_arrays([stats.send_counts])[0]
    else:
        raise TypeError(
            f"expected MigrateStats or RedistributeStats, got "
            f"{type(stats).__name__}"
        )
    if m.ndim < 2 or m.shape[-1] != m.shape[-2]:
        raise ValueError(
            f"flow matrix must be [..., R, R], got shape {m.shape}"
        )
    return m.reshape((-1,) + m.shape[-2:]).astype(np.int64)


def top_pairs(
    matrix: np.ndarray, k: int = 5, include_diag: bool = False
) -> List[Tuple[int, int, int]]:
    """The ``k`` hottest (src, dst, rows) links, descending by rows.

    ``include_diag=False`` (default) keeps wire links only — the
    diagonal of a ``RedistributeStats`` matrix is rows a rank kept, which
    never cross the interconnect (``MigrateStats.flow`` diagonals are
    structurally zero). Ties break toward the lower (src, dst) pair so
    the ordering is deterministic. Zero links are never reported.
    """
    m = host_arrays([matrix])[0]
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"expected an [R, R] matrix, got shape {m.shape}")
    m = m.astype(np.int64, copy=True)
    if not include_diag:
        np.fill_diagonal(m, 0)
    flat = m.reshape(-1)
    # stable sort on (-rows, flat index): deterministic ties
    order = np.lexsort((np.arange(flat.size), -flat))
    out = []
    R = m.shape[0]
    for idx in order[: max(0, int(k))]:
        rows = int(flat[idx])
        if rows <= 0:
            break
        out.append((int(idx // R), int(idx % R), rows))
    return out


class FlowAccumulator:
    """Host-side flow gauge: cumulative matrix + per-step EMA + imbalance.

    Feed it step matrices with :meth:`update` wherever the driver already
    reads stats (one tiny host transfer — same contract as
    :func:`.recorder.record_migrate_steps`); read gauges with
    :meth:`snapshot`. ``ema_alpha`` weights the newest step; the EMA is
    seeded with the first step's matrix so early snapshots are not biased
    toward zero.
    """

    def __init__(self, n_ranks: Optional[int] = None, ema_alpha: float = 0.2):
        if not 0.0 < ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha must be in (0, 1], got {ema_alpha}")
        self.n_ranks = None if n_ranks is None else int(n_ranks)
        self.ema_alpha = float(ema_alpha)
        self.cumulative: Optional[np.ndarray] = None  # [R, R] int64
        self.ema: Optional[np.ndarray] = None  # [R, R] float64
        self.steps = 0
        self.imbalance = 0.0  # latest max/mean population (0 = never fed)
        self.population: Optional[np.ndarray] = None  # latest [R] int64

    def _init(self, R: int) -> None:
        if self.n_ranks is None:
            self.n_ranks = R
        elif self.n_ranks != R:
            raise ValueError(
                f"flow matrix is {R}x{R} but accumulator was built for "
                f"{self.n_ranks} ranks"
            )
        if self.cumulative is None:
            self.cumulative = np.zeros((R, R), np.int64)

    def update(self, stats_or_matrix, population=None) -> None:
        """Fold one step (or a step-stacked run) into the gauges.

        Accepts a stats pytree (:func:`flow_matrix_of` applied) or a raw
        ``[R, R]`` / ``[S, R, R]`` array. ``population`` ([R] or [S, R])
        refreshes the imbalance gauge; when the argument is a
        ``MigrateStats`` its own population leaf is used automatically.
        """
        if hasattr(stats_or_matrix, "flow") or hasattr(
            stats_or_matrix, "send_counts"
        ):
            m = flow_matrix_of(stats_or_matrix)
            if population is None and hasattr(stats_or_matrix, "population"):
                population = stats_or_matrix.population
            elif population is None:
                # redistribute path: rows each rank ended the exchange
                # with (column sums, diagonal included) IS its load
                population = m.sum(axis=1)
        else:
            m = host_arrays([stats_or_matrix])[0]
            if m.ndim == 2:
                m = m[None]
            if m.ndim != 3 or m.shape[-1] != m.shape[-2]:
                raise ValueError(
                    f"expected [R, R] or [S, R, R], got shape {m.shape}"
                )
            m = m.astype(np.int64)
        self._init(m.shape[-1])
        self.cumulative += m.sum(axis=0)
        for step in m.astype(np.float64):
            if self.ema is None:
                self.ema = step
            else:
                a = self.ema_alpha
                self.ema = a * step + (1.0 - a) * self.ema
        self.steps += m.shape[0]
        if population is not None:
            pop = host_arrays([population])[0]
            per_rank = pop.reshape(-1, pop.shape[-1])[-1].astype(np.int64)
            total = int(per_rank.sum())
            if int(per_rank.min(initial=0)) < 0:
                raise ValueError(
                    f"population must be non-negative, got {per_rank}"
                )
            self.population = per_rank
            # total == 0 means EVERY rank is empty (counts are
            # non-negative): an empty system is perfectly balanced, so
            # the gauge reads 1.0 — the old 0.0 sentinel conflated
            # "all-empty" with "never fed", and a some-ranks-empty
            # population (total > 0) must still read max/mean, where the
            # empty ranks rightly push the ratio UP, not reset it
            self.imbalance = (
                float(int(per_rank.max()) * per_rank.size / total)
                if total > 0 else 1.0
            )

    def top_pairs(
        self, k: int = 5, ema: bool = False
    ) -> List[Tuple[int, int, int]]:
        """Hottest off-diagonal links, cumulative (default) or by EMA."""
        src = self.ema if ema else self.cumulative
        if src is None:
            return []
        return top_pairs(np.asarray(src).astype(np.int64), k=k)

    def snapshot(self, k: int = 5) -> Dict[str, object]:
        """JSON-serializable gauge snapshot (compact: no full matrix —
        ``population`` is [R] scalars, bounded by the rank count)."""
        moved = 0
        if self.cumulative is not None:
            c = self.cumulative
            moved = int(c.sum() - np.trace(c))
        return {
            "steps": int(self.steps),
            "n_ranks": self.n_ranks,
            "moved_rows_total": moved,
            "imbalance": float(self.imbalance),
            "population": (
                None if self.population is None
                else self.population.tolist()
            ),
            "top_pairs": [list(p) for p in self.top_pairs(k=k)],
        }


def record_flow_snapshot(recorder, acc: FlowAccumulator, k: int = 5) -> None:
    """Journal one compact ``flow_snapshot`` event from an accumulator.

    The payload is the :meth:`FlowAccumulator.snapshot` dict flattened to
    scalars plus a ``top_pairs`` list — small enough for the ring, rich
    enough for :mod:`.health` imbalance rules and the trace export.
    """
    recorder.record("flow_snapshot", **acc.snapshot(k=k))


def link_report(
    matrix: np.ndarray,
    row_bytes: int,
    *,
    step_seconds: Optional[float] = None,
    domain: str = "nvlink",
    k: int = 5,
) -> Dict[str, object]:
    """Per-link moved bytes (and bandwidth, given honest step seconds).

    ``matrix`` is one ``[R, R]`` mean-per-step flow matrix (average
    :func:`flow_matrix_of` output over the step axis for a run). Each
    off-diagonal link's bytes/step is ``rows * row_bytes``; with
    ``step_seconds`` the per-link rate is compared against ONE link's
    roof (``profiling.NVLINK_BYTES_PER_SEC`` for ``"nvlink"``, the HBM
    roof for single-card ``"hbm"`` exchanges) — the per-link refinement
    of the aggregate ``bw_util``. Returns the ``k`` hottest links.
    """
    m = np.asarray(matrix, np.float64)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"expected an [R, R] matrix, got shape {m.shape}")
    roof = profiling.exchange_peak_bytes_per_sec(domain)
    off = m.copy()
    np.fill_diagonal(off, 0.0)
    pairs = top_pairs(np.rint(off).astype(np.int64), k=k)
    links = []
    for src, dst, rows in pairs:
        byts = float(off[src, dst]) * row_bytes
        entry: Dict[str, object] = {
            "src": src,
            "dst": dst,
            "rows_per_step": float(off[src, dst]),
            "bytes_per_step": byts,
            "bytes_per_sec": None,
            "bw_util": None,
        }
        if step_seconds is not None and step_seconds > 0:
            bps = byts / step_seconds
            entry["bytes_per_sec"] = bps
            entry["bw_util"] = bps / roof
        links.append(entry)
    return {
        "domain": domain,
        "link_roof_bytes_per_sec": roof,
        "links": links,
    }
