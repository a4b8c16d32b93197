"""Closed-loop adaptive rebalancing: plan and amortization guard (the
JAX package's ``telemetry/rebalance.py``).

* :class:`RebalancePlanner` measures the live per-cell occupancy over a
  FINE uniform cell grid (``cells_per_rank_axis`` fine cells per grid
  cell per axis), binned with the same wrap and digitize the engines
  route by (:mod:`..ops.binning`, on the state's own device), feeds it
  to the LPT map (:func:`..parallel.migrate.balanced_assignment`) and
  emits assignment-aware :class:`~..domain.GridEdges`.
* :class:`AmortizationGuard` decides whether applying the plan pays:
  the projected per-step saving over a horizon must clear the measured
  apply cost (an EMA, seeded by a multiple of the step time), with a
  cooldown so two remaps never run back to back.

The actuation is ``GridRedistribute.apply_assignment``; the wiring
(ALERT -> plan -> guard -> apply, a ``rebalance`` event either way) is
in :mod:`..service.driver`.

Projected-saving model (first order): the step time follows the
hottest rank, so a remap from ``old_imb`` to ``proj_imb`` (max/mean)
saves ``step_seconds * (1 - proj_imb / old_imb)`` a step. The journal
records projected against realized.

Planning reads the occupancy histogram (one small device-to-host copy)
and runs the LPT on the host; it runs only at a health boundary.
"""

from __future__ import annotations

# gridlint: service-path

from typing import NamedTuple, Optional

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch.domain import (
    Domain,
    GridEdges,
    ProcessGrid,
)


class RebalancePlan(NamedTuple):
    """One planner output: the fresh map plus the numbers the guard and
    the ``rebalance`` journal event need."""

    edges: GridEdges            # assignment-aware fine-cell -> rank map
    old_imbalance: float        # max/mean of the measured population
    projected_imbalance: float  # max/mean of the LPT bin loads
    n_cells: int                # fine cells in the plan
    occupied_cells: int         # fine cells with nonzero load


class RebalancePlanner:
    """Measure occupancy, run LPT, emit assignment-aware edges.

    ``cells_per_rank_axis`` sets the planning granularity: each grid
    cell is split into that many fine cells per axis, so an 8-rank
    ``(2, 2, 2)`` grid at factor 2 plans over 64 fine cells (8 per
    rank) — enough freedom for LPT to split a hot spot across ranks
    while keeping the assignment table a small constant.
    """

    def __init__(
        self,
        domain: Domain,
        grid: ProcessGrid,
        cells_per_rank_axis: int = 2,
    ):
        if int(cells_per_rank_axis) < 1:
            raise ValueError(
                f"cells_per_rank_axis must be >= 1, got {cells_per_rank_axis}"
            )
        grid.validate_against(domain)
        self.domain = domain
        self.grid = grid
        self.cells_shape = tuple(
            s * int(cells_per_rank_axis) for s in grid.shape
        )
        # uniform fine edges, endpoints exact (np.linspace pins both)
        self.fine_edges = tuple(
            tuple(
                float(v)
                for v in np.linspace(
                    domain.lo[a], domain.hi[a], self.cells_shape[a] + 1
                )
            )
            for a in range(grid.ndim)
        )

    def _live_rows(self, positions, count) -> torch.Tensor:
        pos = positions
        if not isinstance(pos, torch.Tensor):
            pos = torch.from_numpy(np.ascontiguousarray(pos))
        R = self.grid.nranks
        if pos.ndim != 2 or pos.shape[0] % R:
            raise ValueError(
                f"positions must be [R*n_local, ndim] over {R} ranks, "
                f"got {tuple(pos.shape)}"
            )
        if count is None:
            return pos
        n_local = pos.shape[0] // R
        c = (count if isinstance(count, torch.Tensor)
             else torch.from_numpy(np.asarray(count, dtype=np.int64)))
        c = c.to(pos.device, torch.int64).reshape(R)
        mask = (torch.arange(n_local, device=pos.device)[None, :]
                < c[:, None])
        return pos.reshape(R, n_local, -1)[mask]

    def occupancy(self, positions, count=None) -> np.ndarray:
        """Per-fine-cell live-row histogram (``[n_cells]`` int64,
        row-major) from the padded global layout (NumPy arrays or tensors
        on any device): the SAME wrap and digitize the engines route by
        (:mod:`..ops.binning`), on the positions' device, so a cell's
        measured load is exactly the rows the actuation lands there."""
        from mpi_grid_redistribute_tpu_torch.ops import binning

        live = self._live_rows(positions, count)
        probe = GridEdges(self.fine_edges)
        wrapped = binning.wrap_periodic(live.to(torch.float32), self.domain)
        cell = binning.cell_of_position(
            wrapped, self.domain, self.grid, edges=probe
        )
        strides = torch.tensor(probe.cell_strides, dtype=torch.int64,
                               device=cell.device)
        flat = (cell.to(torch.int64) * strides).sum(dim=-1)
        n_cells = int(np.prod(self.cells_shape))
        return torch.bincount(flat, minlength=n_cells).cpu().numpy().astype(
            np.int64)

    def plan(self, positions, count=None) -> Optional[RebalancePlan]:
        """One fresh cell -> rank map from the current state, or ``None``
        when there is nothing to balance (no live rows)."""
        from mpi_grid_redistribute_tpu_torch.parallel import migrate

        loads = self.occupancy(positions, count)
        total = int(loads.sum())
        if total == 0:
            return None
        R = self.grid.nranks
        assignment = migrate.balanced_assignment(loads, R)
        bins = np.bincount(
            np.asarray(assignment), weights=loads.astype(np.float64),
            minlength=R,
        )
        projected = float(bins.max() / bins.mean())
        if count is None:
            old = 1.0
        else:
            c = (count.cpu().numpy() if isinstance(count, torch.Tensor)
                 else np.asarray(count)).astype(np.float64)
            old = float(c.max() / c.mean()) if c.mean() > 0 else 1.0
        return RebalancePlan(
            edges=GridEdges(self.fine_edges, assignment),
            old_imbalance=old,
            projected_imbalance=projected,
            n_cells=int(loads.size),
            occupied_cells=int((loads > 0).sum()),
        )


class GuardDecision(NamedTuple):
    """One :meth:`AmortizationGuard.consider` verdict — everything the
    ``rebalance`` journal event needs to explain itself."""

    apply: bool
    reason: str                  # human decision trail (skip reason or "go")
    projected_saving_s: float    # projected per-step saving (seconds)
    cost_s: float                # apply cost the decision compared against


class AmortizationGuard:
    """Fire the big redistribute only when it amortizes.

    The decision inputs are gauges the driver already has (step-time
    EMA, the planner's old/projected imbalance); the cost side starts as
    ``initial_cost_factor`` x the step time (a remap is a near-total
    permutation plus a recompile, reliably several steps' worth) and
    converges to the EMA of MEASURED apply costs after the first apply.
    ``cooldown_steps`` enforces hysteresis: however loud the gauges, two
    remaps can never run closer than the cooldown, so a plan/actuate
    feedback oscillation cannot thrash.
    """

    def __init__(
        self,
        horizon_steps: int = 256,
        cooldown_steps: int = 64,
        min_improvement: float = 0.05,
        initial_cost_factor: float = 8.0,
        cost_alpha: float = 0.5,
    ):
        if int(horizon_steps) < 1:
            raise ValueError(
                f"horizon_steps must be >= 1, got {horizon_steps}"
            )
        if int(cooldown_steps) < 0:
            raise ValueError(
                f"cooldown_steps must be >= 0, got {cooldown_steps}"
            )
        if not 0.0 <= float(min_improvement) < 1.0:
            raise ValueError(
                f"min_improvement must be in [0, 1), got {min_improvement}"
            )
        if not 0.0 < float(cost_alpha) <= 1.0:
            raise ValueError(
                f"cost_alpha must be in (0, 1], got {cost_alpha}"
            )
        self.horizon_steps = int(horizon_steps)
        self.cooldown_steps = int(cooldown_steps)
        self.min_improvement = float(min_improvement)
        self.initial_cost_factor = float(initial_cost_factor)
        self.cost_alpha = float(cost_alpha)
        self.cost_ema_s: Optional[float] = None  # measured apply cost
        self.last_applied_step: Optional[int] = None
        self.applies = 0

    def consider(
        self,
        *,
        step: int,
        step_seconds: float,
        old_imbalance: float,
        projected_imbalance: float,
    ) -> GuardDecision:
        """Should the plan be applied now? Pure decision — no state
        changes (call :meth:`note_applied` after a realized apply)."""
        cost = (
            self.cost_ema_s
            if self.cost_ema_s is not None
            else self.initial_cost_factor * max(0.0, float(step_seconds))
        )
        if (
            self.last_applied_step is not None
            and step - self.last_applied_step < self.cooldown_steps
        ):
            remaining = self.cooldown_steps - (step - self.last_applied_step)
            return GuardDecision(
                False,
                f"cooldown: last rebalance at step "
                f"{self.last_applied_step}, {remaining} steps remaining",
                0.0,
                cost,
            )
        if old_imbalance <= 0.0:
            return GuardDecision(
                False, "no measured imbalance to improve on", 0.0, cost
            )
        improvement = 1.0 - projected_imbalance / old_imbalance
        saving = max(0.0, float(step_seconds)) * improvement
        if improvement < self.min_improvement:
            return GuardDecision(
                False,
                f"projected improvement {improvement:.1%} below the "
                f"{self.min_improvement:.1%} floor "
                f"({old_imbalance:.2f}x -> {projected_imbalance:.2f}x)",
                max(0.0, saving),
                cost,
            )
        horizon_saving = saving * self.horizon_steps
        if horizon_saving <= cost:
            return GuardDecision(
                False,
                f"projected saving {saving * 1e3:.3f} ms/step x "
                f"{self.horizon_steps} steps = {horizon_saving * 1e3:.1f} "
                f"ms does not clear the {cost * 1e3:.1f} ms apply cost",
                saving,
                cost,
            )
        return GuardDecision(
            True,
            f"projected saving {saving * 1e3:.3f} ms/step clears the "
            f"{cost * 1e3:.1f} ms apply cost within {self.horizon_steps} "
            f"steps ({old_imbalance:.2f}x -> {projected_imbalance:.2f}x)",
            saving,
            cost,
        )

    def note_applied(self, step: int, cost_seconds: float) -> None:
        """Fold one realized apply: arms the cooldown and replaces the
        seeded cost estimate with a measured EMA."""
        self.last_applied_step = int(step)
        self.applies += 1
        c = max(0.0, float(cost_seconds))
        self.cost_ema_s = (
            c
            if self.cost_ema_s is None
            else self.cost_alpha * c
            + (1.0 - self.cost_alpha) * self.cost_ema_s
        )
