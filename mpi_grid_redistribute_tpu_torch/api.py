"""Public API: ``GridRedistribute`` with its ``redistribute()`` and
``halo()``, and the functional ``redistribute()`` and ``reshard()`` (port
of the JAX package's ``api.py``).

Construct with domain bounds and a process-grid shape, then call
``redistribute(positions, *payload_arrays)``, and for ghosts
``halo(positions, *fields, width=..., count=...)``. Two backends: ``"torch"``
(the default) runs the canonical exchange, either on one device with the
R ranks of the grid as virtual ranks (what the reference does when it has
fewer devices than ranks), or with ``mesh=`` one rank a process over
``torch.distributed``; ``"numpy"`` runs the rank-simulation oracle with
the same padded layout and capacity semantics.

With ``mesh=`` (a :class:`~.parallel.mesh.RankMesh`), every rank calls
with ITS shard of the layout below: ``positions [n_local, ndim]``, fields
``[n_local, ...]`` and a scalar ``count``, and gets back its output shard
(``[out_capacity, ...]`` arrays, ``count [1]``) with the stats of all the
ranks (``[R, R]`` tables, ``[R]`` counters), the same on every rank.

Global data layout (one device and the numpy backend):
  * ``positions``: ``[R * n_local, ndim]``; shard r owns rows
    ``[r * n_local, (r + 1) * n_local)``, the first ``count[r]`` valid;
  * ``count``: ``[R]`` int32 valid-row counts (``None``: all rows valid);
  * fields: any number of ``[R * n_local, ...]`` arrays riding the same
    permutation.

Inputs are NumPy arrays or tensors; 64-bit dtypes are narrowed at the
boundary as JAX narrows them with x64 off (float64 -> float32, int64 ->
int32, uint64 -> uint32, complex128 -> complex64), so both backends and
the reference bin at the same precision. Planar eligibility is decided
on the caller's dtypes before that, as the reference decides it: an
array that is not 32-bit makes ``"auto"`` take the row-major engine and
an explicit planar-family engine raise ``TypeError``. The torch backend
returns tensors on its device, the numpy backend NumPy arrays.

Every instance journals into its ``telemetry`` recorder
(:mod:`.telemetry`) the events the reference journals (calls, growth,
engine resolution, the deferred check's windows), from host values it
already holds: journaling never reads the device.
:meth:`GridRedistribute.report`, ``flow()``, ``health()``, ``metrics()``
and ``to_perfetto()`` read it; ``report()`` and ``flow()`` also read the
last call's stats off the device, once.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch import _device, oracle
from mpi_grid_redistribute_tpu_torch.domain import Domain, GridEdges, ProcessGrid
from mpi_grid_redistribute_tpu_torch.parallel import exchange
from mpi_grid_redistribute_tpu_torch.parallel import halo as halo_lib
from mpi_grid_redistribute_tpu_torch.parallel import mesh as mesh_lib
from mpi_grid_redistribute_tpu_torch.parallel.halo import HaloResult
from mpi_grid_redistribute_tpu_torch.telemetry import context as context_lib
from mpi_grid_redistribute_tpu_torch.telemetry import flow as flow_lib
from mpi_grid_redistribute_tpu_torch.telemetry import health as health_lib
from mpi_grid_redistribute_tpu_torch.telemetry import metrics as metrics_lib
from mpi_grid_redistribute_tpu_torch.telemetry import recorder as telemetry_lib
from mpi_grid_redistribute_tpu_torch.telemetry import report as report_lib
from mpi_grid_redistribute_tpu_torch.telemetry import traceview as traceview_lib

# 64-bit dtypes and what JAX (x64 off) narrows them to
_NARROW_NP = {
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
    np.dtype(np.complex128): np.dtype(np.complex64),
}
_NARROW_TORCH = {
    torch.float64: torch.float32,
    torch.int64: torch.int32,
    torch.uint64: torch.uint32,
    torch.complex128: torch.complex64,
}


class RedistributeResult(NamedTuple):
    """Outcome of one redistribute: padded arrays, counts and stats."""

    positions: object
    fields: Tuple
    count: object
    stats: object


def _next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _host(x) -> np.ndarray:
    """A tensor or array as a NumPy array (a device tensor is read back)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class MoverCapacity:
    """Measured-need growth policy for the sparse migrate engine's
    ``mover_cap``: fold each window's ``MigrateStats`` with
    :meth:`update`. The per-step mover count is ``sent + backlog``; when
    its peak exceeds the cap, the cap ratchets to the next power of two
    (never shrinking; clipped to ``max_cap``) and ``update`` returns True,
    so the caller rebuilds its loop. A loop across ranks returns the
    stats of every rank on each, so every rank folds the same peak and
    grows at the same step. Each growth journals a ``mover_cap_grow``
    event to the optional ``recorder`` (a
    :class:`~.telemetry.recorder.StepRecorder`)."""

    def __init__(self, initial: int, max_cap: int = None, recorder=None):
        if int(initial) < 1:
            raise ValueError(f"initial must be >= 1, got {initial}")
        self.max_cap = None if max_cap is None else int(max_cap)
        self.value = _next_pow2(int(initial))
        if self.max_cap is not None:
            self.value = min(self.value, self.max_cap)
        self.recorder = recorder
        self.grow_count = 0

    def update(self, stats) -> bool:
        """Fold one step's (or a stacked window's) stats; True when
        ``value`` grew and the loop should be rebuilt."""
        movers = _host(stats.sent) + _host(stats.backlog)
        peak = int(movers.max()) if movers.size else 0
        if peak <= self.value:
            return False
        new = _next_pow2(peak)
        if self.max_cap is not None:
            new = min(new, self.max_cap)
        if new <= self.value:
            return False
        old, self.value = self.value, new
        self.grow_count += 1
        if self.recorder is not None:
            self.recorder.record(
                "mover_cap_grow", old=old, new=new, peak_movers=peak
            )
        return True


def _itemsize(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.element_size()
    return np.asarray(a).dtype.itemsize


def _caller_layout(positions, fields) -> Tuple[bool, int]:
    """``(planar_ok, row_bytes)`` of the caller's arrays, before any
    narrowing: the reference decides planar eligibility (every array
    32-bit) and prices a row on what it was given."""
    arrays = tuple(
        a if isinstance(a, (torch.Tensor, np.ndarray)) else np.asarray(a)
        for a in (positions,) + tuple(fields))
    ok = all(_itemsize(a) == 4 for a in arrays)
    return ok, report_lib.row_bytes_of(*arrays)


def _neighbor_active_offsets(grid: ProcessGrid, periodic) -> int:
    """Active links of ``grid``'s Moore stencil (the neighbor engine's
    wire is ``n_active * mover_cap`` columns a rank)."""
    return sum(1 for p in mesh_lib.neighbor_perms(grid, tuple(periodic))
               if p)


def _planar_specs(positions, fields):
    """Per-array ``(trailing_shape, dtype, k)`` for the planar engine, or
    ``None`` when an array is not 32-bit (the planar state carries every
    array as int32 rows; other widths take the row-major engine)."""
    specs = []
    for a in (positions,) + tuple(fields):
        if a.element_size() != 4:
            return None
        specs.append((tuple(a.shape[1:]), a.dtype,
                      math.prod(int(s) for s in a.shape[1:])))
    return tuple(specs)


def _fuse_planar(positions, fields, R: int, n_local: int, specs,
                 stacked: bool = True):
    """``[R * n, ...]`` row-major arrays -> ``[R, K, n]`` int32 planar
    state (every array viewed as int32 words, one row per component);
    ``stacked=False`` gives ``[K, R * n]`` (rank ``r`` in columns ``[r *
    n, (r + 1) * n)``)."""
    parts = []
    for a, (_, _, k) in zip((positions,) + tuple(fields), specs):
        flat = a.reshape(R, n_local, k)
        if flat.dtype != torch.int32:
            flat = flat.view(torch.int32)
        parts.append(flat.transpose(1, 2))  # [R, k, n]
    fused = torch.cat(parts, dim=1)
    if not stacked:
        fused = fused.transpose(0, 1).reshape(fused.shape[1], R * n_local)
    return fused


def _unfuse_planar(fused, specs, R: int, out_cap: int, stacked: bool = True):
    """Inverse of :func:`_fuse_planar`: ``(positions, fields)``."""
    if not stacked:
        fused = fused.reshape(fused.shape[0], R, out_cap).transpose(0, 1)
    outs = []
    row = 0
    for shape, dtype, k in specs:
        block = fused[:, row: row + k, :].transpose(1, 2).contiguous()
        if dtype != torch.int32:
            block = block.view(dtype)
        outs.append(block.reshape((R * out_cap,) + tuple(shape)))
        row += k
    return outs[0], tuple(outs[1:])


def _planar_call(engine, V: int, out_cap: int, specs):
    """Boundary fuse -> a planar vrank engine ``(fused [V, K, n], count) ->
    (out [V, K, out_cap], count, extra)`` -> boundary unfuse. The call
    returns ``(positions, count, fields, extra)``; ``extra`` is the
    engine's stats (redistribute) or overflow (halo)."""
    def call(positions, count, *fields):
        n_local = positions.shape[0] // V
        fused = _fuse_planar(positions, fields, V, n_local, specs)
        out, new_count, extra = engine(fused, count)
        pos_out, fields_out = _unfuse_planar(out, specs, V, out_cap)
        return pos_out, new_count, fields_out, extra

    return call


def _rowmajor_call(engine, R: int, out_cap: int):
    """A row-major vrank engine ``(pos [R, n, D], count, *fields [R, n,
    ...]) -> (pos [R, out_cap, D], count, *fields, extra)`` on ``[R * n,
    ...]`` arrays. The call returns ``(positions, count, fields,
    extra)``."""
    def call(positions, count, *fields):
        n = positions.shape[0] // R
        out = engine(
            positions.reshape(R, n, -1), count,
            *(f.reshape((R, n) + tuple(f.shape[1:])) for f in fields),
        )

        def unstack(a):
            return a.reshape((R * out_cap,) + tuple(a.shape[2:]))

        return (unstack(out[0]), out[1], tuple(unstack(f) for f in out[2:-1]),
                out[-1])

    return call


def _needed_out(stats) -> torch.Tensor:
    """The largest rank's unclipped output rows (count + dropped_recv):
    each row of ``recv_counts`` sums what a rank received, its own rows
    included, before the ``out_capacity`` clip. Read from the global
    stats, so it is the same on every rank of a mesh."""
    return stats.recv_counts.sum(dim=1, dtype=torch.int32).max()


def _needed_cross(stats) -> torch.Tensor:
    """The hierarchical engine's peak unclipped cross-pod block (0 for
    every other engine)."""
    if stats.needed_cross is None:
        return torch.zeros((), dtype=torch.int32,
                           device=stats.needed_capacity.device)
    return stats.needed_cross.max()


def _accum_overflow_counters(cum, stats):
    """Fold one call's overflow stats into the cumulative device-side
    counters ``[dropped_send, dropped_recv, needed_capacity, needed_out,
    needed_cross]`` (int32 ``[5]``): a few small device ops, no host
    read, so a window read every ``check_every`` calls covers every
    call."""
    return torch.stack([
        cum[0] + stats.dropped_send.sum(dtype=torch.int32),
        cum[1] + stats.dropped_recv.sum(dtype=torch.int32),
        torch.maximum(cum[2], stats.needed_capacity.max()),
        torch.maximum(cum[3], _needed_out(stats)),
        torch.maximum(cum[4], _needed_cross(stats)),
    ])


def _as_domain(domain, lo=None, hi=None, periodic=False) -> Domain:
    if isinstance(domain, Domain):
        return domain
    if domain is None:
        return Domain(lo, hi, periodic)
    raise TypeError(f"domain must be a Domain, got {type(domain)}")


def _mesh_planar_call(engine, out_cap: int, specs):
    """A rank's planar call: its ``[n, ...]`` arrays fused to ``[K, n]``,
    one multi-rank engine ``(fused, count) -> (out [K, out_cap], count
    [1], global stats)`` (``exchange.*_sharded``), the output unfused."""
    def one(fused, count):
        out, new_count, stats = engine(fused[0], count)
        return out[None], new_count, stats

    return _planar_call(one, 1, out_cap, specs)


class GridRedistribute:
    """Spatial particle redistribution over a Cartesian grid of shards, on
    one device or one rank a process.

    Args:
      domain: :class:`Domain` (or pass ``lo``/``hi``/``periodic``).
      grid: :class:`ProcessGrid` or a grid-shape tuple like ``(2, 2, 2)``.
      backend: ``"torch"`` (the canonical exchange on ``device``, the R
        ranks as virtual ranks) or ``"numpy"`` (the oracle).
      device: the torch backend's device; ``None`` means the GPU and
        raises when there is none (the tests pass ``"cpu"``).
      capacity: slots per remote (source, dest) pair (a rank's own rows
        never ride the wire and are never clipped); default
        ``next_pow2(ceil(n_local / R * capacity_factor))`` at call time,
        at most ``n_local``.
      capacity_factor: headroom of the default capacity.
      out_capacity: padded rows per shard on output; default ``n_local``.
      on_overflow: when a capacity overflow drops rows:

        * ``"grow"`` (default): read the measured need off the stats,
          rebuild at the next power-of-two capacity and re-run the call on
          the same inputs (up to 5 attempts); grown capacities stick on
          the instance. The check reads the device every call only while
          calibrating: after two clean checks every call folds its drop
          counters into cumulative device-side totals, and every
          ``check_every``-th call copies them to pinned host memory behind
          a CUDA event without waiting, resolving the copy made one window
          earlier. A drop found that late cannot be healed: it grows the
          capacities for later calls and raises ``RuntimeError`` naming the
          window. Call :meth:`flush_overflow_checks` (or use the instance
          as a context manager) at loop end;
        * ``"raise"``: raise ``RuntimeError`` on any drop (a host read
          every call);
        * ``"ignore"``: return at once, drops reported in ``stats``.
      check_every: the deferred check's cadence in calls (default 16).
      read_every_call: under ``"grow"``, keep reading every call's drop
        counters after calibration too (one host read a call): a drop is
        then healed in the same call, as a calibrating call's is, and the
        deferred windows run over the clean calls only. For a caller that
        reads every call's result anyway, such as the service driver.
      engine: ``"auto"`` (default: ``"hierarchical"`` across the ranks of
        a mesh of several pods, ``"sparse"`` across ranks of one pod,
        ``"planar"`` on one device, ``"rowmajor"`` when an array is not
        32-bit), ``"planar"``, ``"rowmajor"``, ``"sparse"``,
        ``"neighbor"`` (the count-driven engines: a ``[K, R * mover_cap]``
        wire, or one stencil shift a neighbor, falling back to the dense
        pool when the movers do not fit; ``mover_cap`` starts at
        ``capacity // 8`` rounded to a power of two and grows from the
        measured need, and once it reaches ``capacity`` the planar
        engine runs) or ``"hierarchical"`` (the two-level engine over
        the pods of ``dcn_shape``: the pod-local stencil inside a pod,
        one ``cross_cap`` block a destination pod across them; on a
        grid of one pod it resolves to ``"sparse"``).
      mover_cap: the count-driven engines' first wire block (rounded up
        to a power of two); ``None`` derives it as above.
      edges: optional :class:`GridEdges` (non-uniform or
        assignment-aware ownership), honoured by routing, the oracle and
        :func:`oracle.assert_ownership`.
      mesh: a :class:`~.parallel.mesh.RankMesh` shaped like ``grid``
        (:func:`~.parallel.mesh.make_mesh`): run one rank a process, each
        rank calling with its own shard (see the module docstring). Every
        growth decision reads the gathered stats, so the ranks rebuild
        together. The numpy backend ignores it, as the reference does.
      dcn_shape: per-axis pod counts (:class:`~.parallel.mesh.
        HierarchicalMesh`; each divides its grid extent): grid axis ``a``
        splits into ``dcn_shape[a]`` pods. With more than one pod the
        ``"hierarchical"`` engine is available, and ``"auto"`` takes it
        across the ranks of a mesh. ``None`` (or all ones) is one pod.
      cross_cap: the hierarchical engine's condensed cross-pod block, a
        destination pod (rounded up to a power of two); ``None`` derives
        ``capacity // 8``. It grows from the measured ``needed_cross``
        and, because clipped cross rows are dropped (there is no dense
        cross-pod fallback), a call that clipped re-runs on the same
        inputs at the grown block under ``on_overflow="grow"``.

    :meth:`halo` exchanges ghosts on the same grid (torch backend, uniform
    cells), with the same engine rule and its own overflow policy.

    Telemetry: ``telemetry`` (a :class:`~.telemetry.recorder.StepRecorder`,
    replaceable) journals every call, growth, engine resolution and
    deferred window; ``flow_acc`` (a :class:`~.telemetry.flow.
    FlowAccumulator`) and ``monitor`` (a :class:`~.telemetry.health.
    HealthMonitor` over the journal) back :meth:`flow` and
    :meth:`health`.
    """

    def __init__(
        self,
        domain: Domain = None,
        grid=None,
        *,
        lo=None,
        hi=None,
        periodic=False,
        backend: str = "torch",
        device=None,
        mesh=None,
        capacity: Optional[int] = None,
        capacity_factor: float = 2.0,
        out_capacity: Optional[int] = None,
        on_overflow: str = "grow",
        check_every: int = 16,
        read_every_call: bool = False,
        engine: str = "auto",
        mover_cap: Optional[int] = None,
        dcn_shape=None,
        cross_cap: Optional[int] = None,
        edges=None,
    ):
        self.domain = _as_domain(domain, lo, hi, periodic)
        if grid is None:
            raise ValueError("grid (ProcessGrid or shape tuple) is required")
        self.grid = (
            grid if isinstance(grid, ProcessGrid) else ProcessGrid(tuple(grid))
        )
        self.grid.validate_against(self.domain)
        if edges is not None and not isinstance(edges, GridEdges):
            edges = GridEdges(edges)
        self.edges = edges
        if edges is not None:
            edges.validate_against(self.domain, self.grid)
        if backend not in ("torch", "numpy"):
            raise ValueError(
                f"backend must be 'torch' or 'numpy', got {backend!r}"
            )
        self.backend = backend
        self.device = _device.resolve(device) if backend == "torch" else None
        self._mesh = mesh if backend == "torch" else None
        if self._mesh is not None:
            if not isinstance(self._mesh, mesh_lib.RankMesh):
                raise TypeError(
                    f"mesh must be a RankMesh (parallel.mesh.make_mesh), got "
                    f"{type(self._mesh).__name__}"
                )
            mesh_lib.validate_mesh_for_grid(self._mesh, self.grid)
        for name, v in (("capacity", capacity),
                        ("out_capacity", out_capacity)):
            if v is not None and int(v) < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        if on_overflow not in ("grow", "raise", "ignore"):
            raise ValueError(
                f"on_overflow must be 'grow', 'raise' or 'ignore', "
                f"got {on_overflow!r}"
            )
        self.on_overflow = on_overflow
        if int(check_every) < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        self.check_every = int(check_every)
        self.read_every_call = bool(read_every_call)
        if engine not in exchange.ENGINES:
            raise ValueError(
                f"engine must be one of {exchange.ENGINES}, got {engine!r}"
            )
        self.engine = engine
        self.capacity = capacity
        self.capacity_factor = float(capacity_factor)
        self.out_capacity = out_capacity
        # deferred-check state of "grow" (see the class docstring): clean
        # synchronous checks in a row, calls since the last scheduled
        # check, the pending host copy, the cumulative device counters,
        # the totals already accounted for, and a count of blocking reads
        self._clean_checks = 0
        self._calls_since_check = 0
        self._pending_check = None  # (host [4], event, cap, out_cap, n, call)
        self._call_index = 0
        self._blocking_fetches = 0
        self._cum_counters = None
        self._seen_send = 0
        self._seen_recv = 0
        self._resolved_through = 0
        self._del_warned = False
        self._last_caps = None  # (cap, out_cap, n_local) of the last call
        self._last_stats = None
        self._halo_caps = {}  # widths tuple -> grown (pass_cap, ghost_cap)
        # the count-driven engines' wire block: None = derived on first use
        if mover_cap is not None and int(mover_cap) < 1:
            raise ValueError(f"mover_cap must be >= 1, got {mover_cap}")
        self._mover_cap = (None if mover_cap is None
                           else _next_pow2(int(mover_cap)))
        # the two-level plane: pods of the grid, and the hierarchical
        # engine's cross block (None = derived on first use)
        self._hier = (None if dcn_shape is None
                      else mesh_lib.HierarchicalMesh(self.grid, dcn_shape))
        if cross_cap is not None and int(cross_cap) < 1:
            raise ValueError(f"cross_cap must be >= 1, got {cross_cap}")
        self._cross_cap = (None if cross_cap is None
                           else _next_pow2(int(cross_cap)))
        # (requested engine, vranks, planar_ok, devices) of the last
        # resolution: engine_resolved is journaled when it changes
        self._last_resolution = None
        # the scheduled wire of the last dispatch: engine, wire columns a
        # rank, dense-pool columns, shards (the hierarchical engine also
        # splits its columns into engine_cols_ici / engine_cols_dcn)
        self._last_wire = None
        self._hier_n_act = None  # active links of the pod-local stencil
        # the telemetry journal, its flow gauge and its rule monitor:
        # host-side, fed from values the instance already holds
        self.telemetry = telemetry_lib.StepRecorder()
        self._last_row_bytes = None
        self.flow_acc = flow_lib.FlowAccumulator()
        self.monitor = health_lib.HealthMonitor(self.telemetry)

    @property
    def nranks(self) -> int:
        return self.grid.nranks

    @property
    def n_pods(self) -> int:
        """Number of pods (1 without ``dcn_shape`` or with all ones)."""
        return 1 if self._hier is None else self._hier.n_pods

    @property
    def mesh(self):
        """The :class:`~.parallel.mesh.RankMesh` of a multi-rank instance,
        ``None`` on one device."""
        return self._mesh

    def _mover_cap_for(self, cap: int) -> int:
        """The count-driven engines' per-destination wire block: first
        ``next_pow2(cap // 8)``, then only grown by
        :meth:`_maybe_grow_mover_cap`."""
        if self._mover_cap is None:
            self._mover_cap = _next_pow2(max(1, cap // 8))
        return self._mover_cap

    def _maybe_grow_mover_cap(self, needed: int) -> None:
        """Grow the wire block to the measured per-destination peak (the
        smallest block that would have kept the count-driven branch). The
        dense fallback already gave the same bits, so nothing re-runs;
        the next call runs the grown block."""
        if self._mover_cap is None or needed <= self._mover_cap:
            return
        wire = self._last_wire
        if wire is None or wire.get("engine") not in (
                "sparse", "neighbor", "hierarchical"):
            return  # the dense engines do not use the block
        old = self._mover_cap
        self._mover_cap = _next_pow2(int(needed))
        self.telemetry.record("mover_cap_grow", old=old,
                              new=self._mover_cap, peak_movers=int(needed))

    def _cross_cap_for(self, cap: int) -> int:
        """The hierarchical engine's cross block, a destination pod: first
        ``next_pow2(cap // 8)``, then only grown by
        :meth:`_maybe_grow_cross_cap`."""
        if self._cross_cap is None:
            self._cross_cap = _next_pow2(max(1, cap // 8))
        return self._cross_cap

    def _maybe_grow_cross_cap(self, needed: int) -> bool:
        """Grow the cross block to the measured ``needed_cross`` (the
        peak unclipped cross-pod rows to one destination pod: the
        smallest block that would have carried every one). Clipped cross
        rows are dropped, not sent densely, so on True the caller re-runs
        the same call at the grown block."""
        if self._cross_cap is None or needed <= self._cross_cap:
            return False
        wire = self._last_wire
        if wire is None or wire.get("engine") != "hierarchical":
            return False
        old = self._cross_cap
        self._cross_cap = _next_pow2(int(needed))
        self.telemetry.record("cross_cap_grow", old=old,
                              new=self._cross_cap, peak_cross=int(needed))
        return True

    def _capacities(self, n_local: int) -> Tuple[int, int]:
        cap = self.capacity
        if cap is None:
            cap = max(1, math.ceil(n_local / self.nranks
                                   * self.capacity_factor))
            # power-of-two buckets: growing workloads change capacities
            # only on bucket crossings
            cap = _next_pow2(cap)
        cap = min(cap, n_local)  # no more than n_local to one destination
        out_cap = n_local if self.out_capacity is None else self.out_capacity
        return cap, out_cap

    def _canonical_np(self, a) -> np.ndarray:
        a = _host(a)
        return a.astype(_NARROW_NP.get(a.dtype, a.dtype), copy=False)

    def _canonical_torch(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(self._canonical_np(a)))
        a = a.to(self.device)
        return a.to(_NARROW_TORCH.get(a.dtype, a.dtype))

    def _check_inputs(self, pos, fields, count):
        if self._mesh is not None:
            return self._check_rank_inputs(pos, fields, count)
        R = self.nranks
        canon = (self._canonical_np if self.backend == "numpy"
                 else self._canonical_torch)
        pos = canon(pos)
        fields = tuple(canon(f) for f in fields)
        if pos.ndim != 2 or pos.shape[1] != self.domain.ndim:
            raise ValueError(
                f"positions must be [R*n_local, {self.domain.ndim}], "
                f"got {tuple(pos.shape)}"
            )
        if pos.shape[0] % R:
            raise ValueError(
                f"global rows {pos.shape[0]} must divide evenly over "
                f"{R} ranks"
            )
        n_local = pos.shape[0] // R
        for i, f in enumerate(fields):
            if f.shape[0] != pos.shape[0]:
                raise ValueError(
                    f"field {i} leading dim {f.shape[0]} != {pos.shape[0]}"
                )
        if count is None and self.backend == "torch":
            count = torch.full((R,), n_local, dtype=torch.int32,
                               device=self.device)
        elif count is None:
            count = np.full((R,), n_local, dtype=np.int32)
        if isinstance(count, torch.Tensor) and self.backend == "torch":
            # a tensor count (e.g. the previous call's result.count) is
            # clipped where it lives: a host range check would read it back
            if tuple(count.shape) != (R,):
                raise ValueError(
                    f"count must be [{R}], got {tuple(count.shape)}")
            count = count.to(self.device, torch.int32).clamp(0, n_local)
        else:
            count_host = np.asarray(_host(count), dtype=np.int32)
            if count_host.shape != (R,):
                raise ValueError(
                    f"count must be [{R}], got {count_host.shape}")
            if (count_host < 0).any() or (count_host > n_local).any():
                raise ValueError(
                    f"count entries must be in [0, {n_local}], got "
                    f"{count_host}"
                )
            count = (count_host if self.backend == "numpy"
                     else torch.from_numpy(count_host).to(
                         self.device, non_blocking=True))
        return pos, fields, n_local, count

    def _check_rank_inputs(self, pos, fields, count):
        """One rank's shard: ``pos [n_local, ndim]``, fields ``[n_local,
        ...]`` and a scalar (or ``[1]``) count; ``None`` means all rows."""
        pos = self._canonical_torch(pos)
        fields = tuple(self._canonical_torch(f) for f in fields)
        if pos.ndim != 2 or pos.shape[1] != self.domain.ndim:
            raise ValueError(
                f"positions must be [n_local, {self.domain.ndim}] on each "
                f"rank, got {tuple(pos.shape)}"
            )
        n_local = pos.shape[0]
        for i, f in enumerate(fields):
            if f.shape[0] != n_local:
                raise ValueError(
                    f"field {i} leading dim {f.shape[0]} != {n_local}"
                )
        if count is None:
            count = n_local
        if isinstance(count, torch.Tensor):
            if count.numel() != 1:
                raise ValueError(
                    f"count must be a scalar on each rank, got "
                    f"{tuple(count.shape)}")
            count = count.reshape(1).to(self.device, torch.int32).clamp(
                0, n_local)
        else:
            c = np.asarray(_host(count)).reshape(-1)
            if c.size != 1:
                raise ValueError(
                    f"count must be a scalar on each rank, got {c.size} "
                    f"values")
            c = int(c[0])
            if not 0 <= c <= n_local:
                raise ValueError(
                    f"count must be in [0, {n_local}], got {c}")
            count = torch.full((1,), c, dtype=torch.int32,
                               device=self.device)
        return pos, fields, n_local, count

    def _engine_call(self, positions, fields, cap: int, out_cap: int,
                     planar_ok: bool = True):
        """The engine for these arrays and capacities, by the reference's
        one dispatch rule (``exchange.resolve_engine``): on one device the
        vrank engines, across the ranks of a mesh the multi-rank ones.
        ``planar_ok`` is False when the caller's arrays were not all
        32-bit before narrowing. Journals ``engine_resolved`` when the
        routing inputs change, and sets the scheduled-wire model
        ``_last_wire``."""
        specs = None
        if self.engine in ("auto", "planar", "sparse", "neighbor",
                           "hierarchical"):
            specs = _planar_specs(positions, fields) if planar_ok else None
            if specs is None and self.engine != "auto":
                raise TypeError(
                    f"engine={self.engine!r} requires 32-bit positions and "
                    "fields (they ride as int32 rows); cast or use "
                    "engine='auto'/'rowmajor'"
                )
        mesh = self._mesh
        n_dev = 1 if mesh is None else mesh.size
        res_key = (self.engine, mesh is None, specs is not None, n_dev)
        rec = None
        if res_key != self._last_resolution:
            self._last_resolution = res_key
            rec = self.telemetry
        resolved = exchange.resolve_engine(
            self.engine, vranks=mesh is None, n_devices=n_dev,
            planar_ok=specs is not None, canonical=True,
            n_pods=self.n_pods, recorder=rec,
        )
        R = self.nranks
        dense_cols = R * cap
        if resolved in ("sparse", "neighbor", "hierarchical"):
            B = self._mover_cap_for(cap)
            if B >= cap:
                # the grown block reached the dense pool: run planar
                if rec is None and self._last_wire is not None and (
                        self._last_wire.get("engine") != "planar"):
                    self.telemetry.record(
                        "engine_resolved", requested=self.engine,
                        resolved="planar",
                        reason=(f"{resolved}: mover_cap {B} >= capacity "
                                f"{cap}, count-driven pool no smaller than "
                                f"dense"),
                        canonical=True)
                resolved = "planar"
        if resolved == "hierarchical":
            B2 = self._cross_cap_for(cap)
            hier = self._hier
            if self._hier_n_act is None:
                self._hier_n_act = exchange._hier_tables(
                    hier, self.domain.periodic).n_act
            cols_ici = (self._hier_n_act * B
                        + (hier.n_pods - 1) * hier.pod_size * B2)
            cols_dcn = (hier.n_pods - 1) * B2
            self._last_wire = {
                "engine": resolved, "engine_cols": cols_ici + cols_dcn,
                "engine_cols_ici": cols_ici, "engine_cols_dcn": cols_dcn,
                "dense_cols": dense_cols, "shards": R,
            }
        elif resolved in ("sparse", "neighbor"):
            cols = (B * _neighbor_active_offsets(self.grid,
                                                 self.domain.periodic)
                    if resolved == "neighbor" else R * B)
            self._last_wire = {"engine": resolved, "engine_cols": cols,
                               "dense_cols": dense_cols, "shards": R}
        else:
            self._last_wire = {"engine": resolved, "engine_cols": dense_cols,
                               "dense_cols": dense_cols, "shards": R}
        grid, dom, edges = self.grid, self.domain, self.edges
        if resolved == "hierarchical":
            if mesh is None:
                return _planar_call(
                    exchange.build_redistribute_hierarchical_vranks(
                        dom, grid, self._hier, cap, out_cap, B, B2, dom.ndim,
                        edges=edges), self.nranks, out_cap, specs)
            return _mesh_planar_call(
                exchange.build_redistribute_hierarchical(
                    mesh, dom, grid, self._hier, cap, out_cap, B, B2,
                    dom.ndim, edges=edges), out_cap, specs)
        if resolved in ("sparse", "neighbor"):
            if mesh is None:
                return _planar_call(
                    exchange.build_redistribute_count_driven_vranks(
                        dom, grid, cap, out_cap, B, dom.ndim, edges=edges,
                        engine=resolved), self.nranks, out_cap, specs)
            return _mesh_planar_call(
                exchange.shard_redistribute_count_driven_sharded(
                    mesh, dom, grid, cap, out_cap, B, dom.ndim, edges=edges,
                    engine=resolved), out_cap, specs)
        if resolved == "planar":
            if mesh is None:
                return _planar_call(exchange.vrank_redistribute_planar_fn(
                    dom, grid, cap, out_cap, dom.ndim, edges=edges),
                    self.nranks, out_cap, specs)
            return _mesh_planar_call(
                exchange.shard_redistribute_planar_sharded(
                    mesh, dom, grid, cap, out_cap, dom.ndim, edges=edges),
                out_cap, specs)
        if mesh is None:
            return _rowmajor_call(exchange.vrank_redistribute_fn(
                dom, grid, cap, out_cap, edges), self.nranks, out_cap)
        engine = exchange.build_redistribute(mesh, dom, grid, cap, out_cap,
                                             edges=edges)

        def call(positions, count, *fields):
            out = engine(positions, count, *fields)
            return out[0], out[1], tuple(out[2:-1]), out[-1]

        return call

    def _run_once(self, positions, fields, count, cap: int, out_cap: int,
                  planar_ok: bool = True) -> RedistributeResult:
        if self.backend == "numpy":
            pos_out, counts_out, fields_out, stats = (
                oracle.redistribute_oracle_padded(
                    self.domain, self.grid, positions, count, list(fields),
                    cap, out_cap, edges=self.edges,
                )
            )
            return RedistributeResult(pos_out, tuple(fields_out), counts_out,
                                      exchange.RedistributeStats(**stats))
        fn = self._engine_call(positions, fields, cap, out_cap, planar_ok)
        pos_out, new_count, fields_out, stats = fn(positions, count, *fields)
        return RedistributeResult(pos_out, fields_out, new_count, stats)

    def engine_fn(self, positions, *fields):
        """``(fn, cap, out_cap)``: the engine :meth:`redistribute` would run
        for arrays of these shapes and dtypes, with no overflow policy
        around it: ``fn(positions, count, *fields) -> (positions, count,
        fields, stats)``. The caller reads the drop counters and grows
        through :meth:`_grow`; a fresh ``engine_fn`` takes the grown
        capacities. Resolution, its journal event and the scheduled-wire
        model are those of one :meth:`redistribute` call."""
        if self.backend != "torch":
            raise ValueError(
                "engine_fn requires backend='torch': the numpy oracle has "
                "no engine to hand out"
            )
        R = 1 if self._mesh is not None else self.nranks
        if positions.ndim != 2 or positions.shape[0] % R:
            raise ValueError(
                f"positions must be [R*n_local, ndim] over {R} ranks, "
                f"got {tuple(positions.shape)}"
            )
        cap, out_cap = self._capacities(positions.shape[0] // R)
        planar_ok, self._last_row_bytes = _caller_layout(positions, fields)
        return (self._engine_call(positions, fields, cap, out_cap, planar_ok),
                cap, out_cap)

    def redistribute(self, positions, *fields, count=None) -> RedistributeResult:
        """Bin, pack, exchange: every particle moves to its owner shard.

        Returns a :class:`RedistributeResult` in the global padded layout
        (leading dim ``R * out_capacity``). Under ``on_overflow="grow"`` an
        overflow is healed by rebuilding at the measured need and
        re-running on the same inputs. Every event the call journals
        carries its call index (``ctx_call``)."""
        planar_ok, row_bytes = _caller_layout(positions, fields)
        positions, fields, n_local, count = self._check_inputs(
            positions, fields, count
        )
        self._call_index += 1
        # the numpy backend prices the narrowed rows, as the reference's
        self._last_row_bytes = (
            row_bytes if self.backend == "torch"
            else report_lib.row_bytes_of(positions, *fields))
        with context_lib.scoped(call=self._call_index):
            return self._redistribute_attempts(positions, fields, count,
                                               n_local, planar_ok)

    def apply_assignment(self, edges, positions, *fields,
                         count=None) -> RedistributeResult:
        """Rebind ownership to ``edges`` (typically an assignment-aware
        fine-cell -> rank map) and re-home the state in one canonical
        redistribute. The new edges stick on the instance: later calls
        route by them. The returned particle set is the input set,
        permuted. ``edges=None`` reverts to uniform cells."""
        if edges is not None and not isinstance(edges, GridEdges):
            edges = GridEdges(edges)
        if edges is not None:
            edges.validate_against(self.domain, self.grid)
        self.edges = edges
        return self.redistribute(positions, *fields, count=count)

    def halo(
        self,
        positions,
        *fields,
        width,
        count=None,
        headroom: float = 2.0,
        pass_capacity: Optional[int] = None,
        ghost_capacity: Optional[int] = None,
    ) -> HaloResult:
        """Ghost exchange: for every rank, copies of the neighbour ranks'
        particles within ``width`` of its subdomain faces.

        Args:
          positions: ``[R * n_local, ndim]`` in :meth:`redistribute`'s
            global padded layout (typically its output).
          *fields: per-particle arrays riding along (ids, masses).
          width: scalar or per-axis halo width in domain units, at most
            the per-axis subdomain width (one-hop shell).
          count: ``[R]`` valid-row counts (e.g. ``result.count``).
          headroom: multiplier of the derived capacities
            (:func:`~.parallel.halo.default_capacities`), sized from the
            PADDED per-rank rows, so forcing overflow needs it well
            below 1.
          pass_capacity / ghost_capacity: explicit pins; by default
            derived, and under ``on_overflow="grow"`` grown on a measured
            overflow (grown sizes stick on the instance per width).
            ``"raise"`` raises on any overflow; ``"ignore"`` returns
            without reading the device, ``overflow`` in the result.

        Returns a :class:`HaloResult`: ``ghost_positions [R *
        ghost_capacity, ndim]`` (shifted into each receiver's frame
        across periodic wraps), ``ghost_count [R]``, ``ghost_fields``,
        ``overflow [R]``. The planar engine runs when every array is
        32-bit, the row-major one otherwise; both give the same ghosts.
        "grow" and "raise" read ``overflow`` on the host once an attempt.

        With ``mesh=`` each rank passes its shard (``positions [n_local,
        ndim]``, a scalar ``count``) and gets its own ghosts
        (``ghost_positions [ghost_capacity, ndim]``, fields alike) with
        the ghost counts and overflow of every rank (``[R]``, gathered),
        so every rank grows, retries or raises together.
        """
        if self.backend != "torch":
            raise ValueError(
                "halo() runs on the torch backend; for NumPy-side "
                "validation use oracle.brute_force_ghosts (the set-level "
                "ghost oracle)"
            )
        if self.edges is not None:
            raise ValueError(
                "halo() requires uniform cells (edges=None): the halo "
                "engines' face predicates assume uniform subdomain "
                "widths — rebalance with GridEdges only on the "
                "redistribute path, or rebuild without edges for ghosts"
            )
        planar_ok = _caller_layout(positions, fields)[0]
        positions, fields, n_local, count = self._check_inputs(
            positions, fields, count
        )
        widths = halo_lib._as_per_axis(width, self.domain.ndim)
        dpc, dgc = halo_lib.default_capacities(
            self.domain, self.grid, widths, n_local, headroom
        )
        grown_pc, grown_gc = self._halo_caps.get(widths, (0, 0))
        pc = pass_capacity if pass_capacity is not None else max(dpc,
                                                                 grown_pc)
        gc = ghost_capacity if ghost_capacity is not None else max(dgc,
                                                                   grown_gc)
        max_attempts = 5
        for attempt in range(1, max_attempts + 1):
            result = self._halo_once(positions, fields, count, widths, pc,
                                     gc, planar_ok)
            self.telemetry.record("halo", n_local=n_local, pass_capacity=pc,
                                  ghost_capacity=gc)
            if self.on_overflow == "ignore":
                return result  # no host read
            overflow = _host(result.overflow)
            total_ov = int(overflow.sum())
            if not total_ov:
                return result
            if self.on_overflow == "raise":
                raise RuntimeError(
                    f"halo overflow: {total_ov} ghosts dropped at "
                    f"pass_capacity={pc}, ghost_capacity={gc} — raise "
                    f"capacities/headroom or use on_overflow='grow'"
                )
            if pass_capacity is not None and ghost_capacity is not None:
                raise RuntimeError(
                    f"halo overflow: {total_ov} ghosts dropped at the "
                    f"explicitly pinned capacities ({pc}, {gc})"
                )
            if attempt == max_attempts:
                # growth happens only when another attempt follows, so
                # (pc, gc) are the capacities of the run that dropped
                raise RuntimeError(
                    f"halo capacity growth did not converge in "
                    f"{max_attempts} attempts (last run: "
                    f"pass_capacity={pc}, ghost_capacity={gc}, "
                    f"{total_ov} ghosts still dropped)"
                )
            # pass and ghost drops cascade into one counter: grow both by
            # at least the worst rank's overflow, in power-of-two buckets
            max_ov = int(overflow.max())
            old_pc, old_gc = pc, gc
            if pass_capacity is None:
                pc = _next_pow2(max(2 * pc, pc + max_ov))
            if ghost_capacity is None:
                gc = _next_pow2(gc + max_ov)
            self._halo_caps[widths] = (max(pc, grown_pc), max(gc, grown_gc))
            self.telemetry.record(
                "halo_grow", old_pass_capacity=old_pc, new_pass_capacity=pc,
                old_ghost_capacity=old_gc, new_ghost_capacity=gc,
                overflow=total_ov)

    def _halo_once(self, positions, fields, count, widths, pc: int,
                   gc: int, planar_ok: bool = True) -> HaloResult:
        specs = None
        if self.engine in ("auto", "planar"):
            specs = _planar_specs(positions, fields) if planar_ok else None
            if specs is None and self.engine == "planar":
                raise TypeError(
                    "engine='planar' requires 32-bit positions and fields "
                    "(they ride as int32 rows); cast or use "
                    "engine='auto'/'rowmajor'"
                )
        mesh, dom, grid = self._mesh, self.domain, self.grid
        if mesh is not None and specs is not None:
            fn = _mesh_planar_call(halo_lib.build_halo_planar(
                mesh, dom, grid, widths, pc, gc), gc, specs)
        elif mesh is not None:
            return halo_lib.build_halo_exchange(
                mesh, dom, grid, widths, pass_capacity=pc,
                ghost_capacity=gc)(positions, count, *fields)
        elif specs is not None:
            fn = _planar_call(halo_lib.vrank_halo_planar_fn(
                dom, grid, widths, pc, gc), self.nranks, gc, specs)
        else:
            fn = _rowmajor_call(halo_lib.vrank_halo_fn(
                dom, grid, widths, pc, gc), self.nranks, gc)
        return HaloResult(*fn(positions, count, *fields))

    def _read_overflow(self, result) -> Tuple[int, int, int, int, int]:
        """One blocking read of ``(dropped_send, dropped_recv, needed,
        needed_out, needed_cross)`` off a call's stats."""
        self._blocking_fetches += 1
        st = result.stats
        if self.backend == "numpy":
            return (int(st.dropped_send.sum()), int(st.dropped_recv.sum()),
                    int(st.needed_capacity.max()),
                    int((result.count + st.dropped_recv).max()), 0)
        vals = torch.stack([
            st.dropped_send.sum(dtype=torch.int32),
            st.dropped_recv.sum(dtype=torch.int32),
            st.needed_capacity.max(),
            _needed_out(st),
            _needed_cross(st),
        ]).tolist()
        return tuple(int(v) for v in vals)

    def _redistribute_attempts(self, positions, fields, count, n_local,
                               planar_ok: bool = True) -> RedistributeResult:
        max_attempts = 5
        for _ in range(max_attempts):
            cap, out_cap = self._capacities(n_local)
            result = self._run_once(positions, fields, count, cap, out_cap,
                                    planar_ok)
            self._last_stats = result.stats
            wire = self._last_wire or {}
            # scheduled wire bytes of this call's exchange (static pool
            # width x row bytes x shards), whatever the occupancy
            wire_bytes = (wire.get("engine_cols", 0)
                          * (self._last_row_bytes or 0)
                          * wire.get("shards", 0))
            self.telemetry.record(
                "redistribute", call=self._call_index, n_local=n_local,
                capacity=cap, out_capacity=out_cap,
                engine=wire.get("engine", self.engine), wire_bytes=wire_bytes,
            )
            if self.on_overflow == "ignore":
                return result  # no host read of the stats
            calibrated = (self.on_overflow == "grow"
                          and self._clean_checks >= 2
                          and self.backend == "torch")
            if calibrated and not self.read_every_call:
                self._fold_into_window(result.stats, n_local, cap, out_cap)
                return result
            dropped_send, dropped_recv, needed, needed_out, needed_cross = (
                self._read_overflow(result))
            if not dropped_send and not dropped_recv:
                if calibrated:
                    # read_every_call: a clean call joins the windows
                    self._fold_into_window(result.stats, n_local, cap,
                                           out_cap)
                elif self.on_overflow == "grow":
                    self._clean_checks += 1
                    self._maybe_grow_mover_cap(needed)
                    # clean: re-arm the cross block for the next call
                    self._maybe_grow_cross_cap(needed_cross)
                return result
            self._clean_checks = 0
            if self.on_overflow == "raise":
                raise RuntimeError(
                    f"particle loss detected: dropped_send={dropped_send}, "
                    f"dropped_recv={dropped_recv} — raise capacity / "
                    f"out_capacity or use on_overflow='grow'"
                )
            self._maybe_grow_mover_cap(needed)
            # cross-pod clipping is healed by the cross block, not the
            # capacity: True re-runs this call at the grown block
            grew_cross = self._maybe_grow_cross_cap(needed_cross)
            grew = self._grow(dropped_send, dropped_recv, needed, needed_out,
                              n_local, cap, out_cap)
            if not (grew or grew_cross):
                raise RuntimeError(
                    f"overflow not resolvable by growth (capacity {cap}, "
                    f"out_capacity {out_cap} already at their maxima): "
                    f"dropped_send={dropped_send} dropped_recv={dropped_recv}"
                )
        raise RuntimeError(
            f"capacity growth did not converge in {max_attempts} attempts"
        )

    def _grow(self, dropped_send, dropped_recv, needed, needed_out, n_local,
              cap, out_cap) -> bool:
        """Raise the instance capacities from the measured need; True if
        grown. A capacity grows when the measured window needed more than
        the caps it ran with, and never below its floor: the current
        explicit capacity, or in derived mode the caps of the most recent
        call, so a late flush of a stale window never shrinks one."""
        grew = False
        last_cap, last_out = (
            (self._last_caps[0], self._last_caps[1])
            if self._last_caps is not None else (0, 0)
        )
        if dropped_send:
            new_cap = min(_next_pow2(needed), n_local)
            if new_cap > cap:
                floor = last_cap if self.capacity is None else self.capacity
                self.capacity = max(new_cap, floor)
                grew = True
                self.telemetry.record(
                    "capacity_grow", which="send", old=cap,
                    new=self.capacity, needed=needed, dropped=dropped_send,
                    call=self._call_index)
        if dropped_recv:
            new_out = min(_next_pow2(needed_out), self.nranks * n_local)
            if new_out > out_cap:
                floor = (last_out if self.out_capacity is None
                         else self.out_capacity)
                self.out_capacity = max(new_out, floor)
                grew = True
                self.telemetry.record(
                    "capacity_grow", which="recv", old=out_cap,
                    new=self.out_capacity, needed=needed_out,
                    dropped=dropped_recv, call=self._call_index)
        return grew

    def _fold_into_window(self, stats, n_local, cap, out_cap) -> None:
        """Calibrated: fold a call's counters into the cumulative device
        totals, read one window later."""
        if self._cum_counters is None:
            self._cum_counters = torch.zeros(
                (5,), dtype=torch.int32, device=self.device)
        self._cum_counters = _accum_overflow_counters(
            self._cum_counters, stats)
        self._deferred_check(n_local, cap, out_cap)

    def _deferred_check(self, n_local, cap, out_cap) -> None:
        """Every ``check_every``-th call: resolve the previous snapshot
        (its copy finished a window ago) and start a non-blocking copy of
        the cumulative counters into pinned host memory behind an event."""
        self._last_caps = (cap, out_cap, n_local)
        self._calls_since_check += 1
        if self._calls_since_check < self.check_every:
            return
        self._calls_since_check = 0
        self._resolve_pending()
        self._pending_check = self._snapshot() + (
            cap, out_cap, n_local, self._call_index)
        self.telemetry.record("overflow_window_scheduled",
                              through_call=self._call_index,
                              window=self.check_every)

    def _snapshot(self):
        """``(host, event)``: the cumulative counters copied to the host
        without a wait (``event`` None on the CPU, where the copy is
        synchronous)."""
        cum = self._cum_counters
        if cum.device.type != "cuda":
            return cum.clone(), None
        host = torch.empty(cum.shape, dtype=cum.dtype, pin_memory=True)
        host.copy_(cum, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _resolve_pending(self) -> None:
        if self._pending_check is None:
            return
        host, event, cap, out_cap, n_local, call_idx = self._pending_check
        # read first, bookkeeping after: a failed read leaves the window
        # pending, so a later resolve or flush still reports it
        if event is not None:
            event.synchronize()
        total_send, total_recv, needed, needed_out, needed_cross = (
            int(v) for v in host.tolist())
        self._pending_check = None
        self._resolved_through = max(self._resolved_through, call_idx)
        # re-arm the count-driven and cross blocks from the window's peaks
        self._maybe_grow_mover_cap(needed)
        self._maybe_grow_cross_cap(needed_cross)
        dropped_send = total_send - self._seen_send
        dropped_recv = total_recv - self._seen_recv
        if not dropped_send and not dropped_recv:
            self.telemetry.record("overflow_window_clean",
                                  through_call=call_idx)
            return
        self._seen_send, self._seen_recv = total_send, total_recv
        self.telemetry.record("overflow_window_loss", through_call=call_idx,
                              dropped_send=dropped_send,
                              dropped_recv=dropped_recv)
        # too late to heal (the results were consumed): grow for later
        # calls, then fail loudly
        self._grow(dropped_send, dropped_recv, needed, needed_out, n_local,
                   cap, out_cap)
        self._clean_checks = 0
        raise RuntimeError(
            f"deferred overflow check: the {self.check_every}-call window "
            f"ending at call {call_idx} dropped {dropped_send} (send) / "
            f"{dropped_recv} (recv) particles; capacities have been grown "
            f"for subsequent calls, but results in that window are lossy — "
            f"restart from the last checkpoint or rerun. Use a smaller "
            f"check_every (or on_overflow='ignore' + your own per-step "
            f"check) to narrow the window."
        )

    def _has_unresolved_windows(self) -> bool:
        """True when deferred-mode calls exist whose counters were not read
        back yet."""
        return (self._cum_counters is not None
                and self._call_index > self._resolved_through)

    def flush_overflow_checks(self) -> None:
        """Resolve the whole cumulative counter history (blocking): the
        pending window and any partial one. Call at loop end under
        ``on_overflow="grow"``; raises like the in-loop check on a loss."""
        if self._cum_counters is not None and self._last_caps is not None:
            cap, out_cap, n_local = self._last_caps
            self._pending_check = self._snapshot() + (
                cap, out_cap, n_local, self._call_index)
            self._calls_since_check = 0
        self._resolve_pending()

    def _exchange_topology(self) -> Tuple[str, int]:
        """``(domain, n_chips)`` of the exchange: ``("hbm", 1)`` for the
        vrank engines on one device (and the numpy oracle), ``("nvlink",
        world)`` across the ranks of a mesh of several."""
        if self._mesh is None or self._mesh.size == 1:
            return "hbm", 1
        return "nvlink", self._mesh.size

    def report(self, step_seconds: Optional[float] = None) -> dict:
        """One merged, JSON-serializable metrics dict
        (:func:`~.telemetry.report.exchange_report`) from the LAST
        redistribute call's stats: summary counters, exchange bytes a
        step (total and moved), and with ``step_seconds`` the achieved
        GB/s and ``bw_util`` against this instance's roof (HBM3 on one
        card, NVLink across cards), the journal's event counts, the
        scheduled wire and the instance's capacities.

        Reads the last stats off the device once: call it at loop or
        bench boundaries. Pass a length-differenced ``step_seconds``
        (:func:`~.utils.profiling.time_per_step_samples`); without it the
        rate and utilization fields are ``None``. Across ranks the stats
        are the gathered ones, so every rank returns the same dict."""
        if self._last_stats is None:
            raise RuntimeError(
                "report() needs at least one redistribute() call"
            )
        domain, n_chips = self._exchange_topology()
        wire = self._last_wire or {}
        out = report_lib.exchange_report(
            self._last_stats, self._last_row_bytes,
            step_seconds=step_seconds, domain=domain, n_chips=n_chips,
            recorder=self.telemetry,
            engine_wire_cols=wire.get("engine_cols"),
            dense_wire_cols=wire.get("dense_cols"),
            wire_shards=wire.get("shards"),
        )
        out["engine"] = wire.get("engine", self.engine)
        if "engine_cols_dcn" in wire:
            # the two-level engine: pod-crossing blocks over the slower
            # tier, the stencil and the in-pod fan-out over the faster
            rb = self._last_row_bytes or 0
            shards = wire.get("shards", 0)
            out["dcn_bytes_per_step"] = wire["engine_cols_dcn"] * rb * shards
            out["ici_bytes_per_step"] = wire["engine_cols_ici"] * rb * shards
        out["calls"] = self._call_index
        out["capacity"] = self.capacity
        out["out_capacity"] = self.out_capacity
        out["blocking_fetches"] = self._blocking_fetches
        out["unresolved_windows"] = bool(self._has_unresolved_windows())
        return out

    def flow(self, k: int = 5, update: bool = True) -> dict:
        """Per-link flow view of the LAST redistribute call
        (:mod:`~.telemetry.flow`): the ``[R, R]`` matrix (``[i, j]`` =
        rows rank ``i`` sent rank ``j``; row sums are the send totals,
        column sums the receive totals), the cumulative matrix and
        imbalance gauge of ``flow_acc``, and the ``k`` hottest off-diagonal
        links. ``update=True`` folds the stats into the gauge and
        journals a ``flow_snapshot`` event. Reads the stats off the
        device once; across ranks every rank returns the same view."""
        if self._last_stats is None:
            raise RuntimeError("flow() needs at least one redistribute() call")
        steps = flow_lib.flow_matrix_of(self._last_stats)
        if update:
            # a redistribute's load is the rows each rank ended with
            self.flow_acc.update(steps, population=steps.sum(axis=1))
            flow_lib.record_flow_snapshot(self.telemetry, self.flow_acc, k=k)
        return {
            "matrix": steps[-1],
            "cumulative": self.flow_acc.cumulative,
            "imbalance": self.flow_acc.imbalance,
            "hot_links": self.flow_acc.top_pairs(k=k),
            "snapshot": self.flow_acc.snapshot(k=k),
        }

    def health(self) -> dict:
        """Evaluate the health rules (:class:`~.telemetry.health.
        HealthMonitor`) over this instance's journal: ``{"status":
        "OK"|"WARN"|"ALERT", "findings": [...]}``. New findings are
        journaled as ``alert`` events and fire the callbacks of
        ``rd.monitor``. Host-side only."""
        return self.monitor.evaluate()

    def metrics(self, render: bool = False):
        """The journal replayed into the grid metric families
        (:mod:`~.telemetry.metrics`): the registry, or with
        ``render=True`` its OpenMetrics text. Counters use the all-time
        counts, exact after ring eviction. Host-side only."""
        reg = metrics_lib.from_journal(self.telemetry)
        return reg.render_openmetrics() if render else reg

    def to_perfetto(self, path: Optional[str] = None, **kwargs):
        """The journal as Chrome-trace/Perfetto JSON
        (:mod:`~.telemetry.traceview`): written to ``path`` (returns the
        event count) or returned as a dict. Extra kwargs
        (``phase_timings``, ``step_seconds``) go to
        :func:`~.telemetry.traceview.to_chrome_trace`."""
        if path is not None:
            return traceview_lib.write_trace(path, self.telemetry, **kwargs)
        return traceview_lib.to_chrome_trace(self.telemetry, **kwargs)

    def __enter__(self) -> "GridRedistribute":
        """``with GridRedistribute(...) as rd``: the exit flushes the
        deferred checks, so a lossy trailing window raises there."""
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.flush_overflow_checks()
        else:
            # an exception is in flight: still resolve, but warn (always
            # printed) rather than raise over it
            try:
                self.flush_overflow_checks()
            except Exception as loss:
                with warnings.catch_warnings():
                    warnings.simplefilter("always")
                    warnings.warn(
                        f"flush_overflow_checks at context exit: {loss!r}",
                        RuntimeWarning, stacklevel=2,
                    )
        return False

    def __del__(self):
        # unread deferred windows at garbage collection: warn, since
        # __del__ cannot raise
        try:
            unresolved = self._has_unresolved_windows() and not self._del_warned
        except AttributeError:
            return  # partially constructed instance
        if unresolved:
            self._del_warned = True
            warnings.warn(
                "GridRedistribute dropped with unresolved deferred "
                "overflow windows: call flush_overflow_checks() at loop "
                "end (or use the instance as a context manager: "
                "`with GridRedistribute(...) as rd:`) — a capacity "
                "overflow in the trailing window would otherwise go "
                "unreported",
                RuntimeWarning, stacklevel=2,
            )


def redistribute(positions, *fields, domain: Domain, grid, count=None,
                 backend: str = "torch", **kwargs) -> RedistributeResult:
    """One-shot functional form of :class:`GridRedistribute`."""
    rd = GridRedistribute(domain, grid, backend=backend, **kwargs)
    return rd.redistribute(positions, *fields, count=count)


def reshard(positions, *fields, domain: Domain, grid, n_local: int,
            backend: str = "numpy", telemetry=None,
            **kwargs) -> RedistributeResult:
    """Route UNPADDED live rows onto ``grid``'s owners in one canonical
    redistribute (the elastic-restart entry).

    Ownership follows position, so re-decomposing ``N`` live rows onto an
    M-rank grid is one redistribute: the ``[N, ndim]`` rows are chunked
    contiguously over M input shards (any chunking works; the exchange
    routes by position) into the ``[M * n_local, ...]`` padded layout.
    ``fields`` ride the same permutation. Defaults to the numpy backend,
    as the reference does; overflow heals by growing. With ``mesh=`` (torch
    backend) every rank passes the same live rows and gets its output
    shard. ``telemetry=`` (a :class:`~.telemetry.recorder.StepRecorder`)
    journals the call there."""
    grid = grid if isinstance(grid, ProcessGrid) else ProcessGrid(grid)
    positions = _host(positions)
    n = positions.shape[0]
    m = grid.nranks
    if int(n_local) < 1:
        raise ValueError(f"n_local must be >= 1, got {n_local}")
    in_rows = max(1, -(-n // m))  # ceil: every live row gets an input slot
    fields = tuple(_host(f) for f in fields)
    pos_in = np.zeros((m * in_rows,) + positions.shape[1:], positions.dtype)
    pos_in[:n] = positions
    fields_in = []
    for f in fields:
        buf = np.zeros((m * in_rows,) + f.shape[1:], f.dtype)
        buf[:n] = f
        fields_in.append(buf)
    # input shard c's live rows are rows [c * in_rows, c * in_rows +
    # count_in[c]) of the flat live array
    count_in = np.clip(
        n - in_rows * np.arange(m, dtype=np.int64), 0, in_rows
    ).astype(np.int32)
    rd = GridRedistribute(
        domain, grid, backend=backend, capacity=in_rows,
        out_capacity=int(n_local), on_overflow="grow", **kwargs,
    )
    if telemetry is not None:
        rd.telemetry = telemetry
    if rd.mesh is not None:
        # every rank passes the same live rows and routes its own chunk
        r = rd.mesh.rank
        rows = slice(r * in_rows, (r + 1) * in_rows)
        return rd.redistribute(pos_in[rows], *(f[rows] for f in fields_in),
                               count=int(count_in[r]))
    return rd.redistribute(pos_in, *fields_in, count=count_in)
