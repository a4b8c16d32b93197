"""Pure-NumPy multi-rank redistribution oracle (port of the JAX package's
``oracle.py``, its NumPy path).

It simulates R MPI ranks in one process with MPI ``Alltoallv`` receive
order: each rank receives the concatenation, over source ranks in
ascending order, of the rows that source sent it, each source's rows in
their original (stable) order. The canonical exchange is held against it
bit for bit.

The reference's oracle bins through its ``ops/binning.py``, which imports
JAX, so this module keeps its own NumPy copy of that binning (the
reference's ``xp=np`` branch). It is independent of the port's PyTorch
binning, which the oracle thereby checks.
"""

from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import numpy as np

from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.ops.binning import _is_pow2
from mpi_grid_redistribute_tpu_torch.utils import native


def wrap_periodic(pos: np.ndarray, domain: Domain) -> np.ndarray:
    """Wrap ``[N, D]`` positions into ``[lo, hi)`` on the periodic axes."""
    dt = pos.dtype
    lo = np.asarray(domain.lo, dtype=dt)
    extent = np.asarray(domain.extent, dtype=dt)
    q = pos - lo
    with np.errstate(over="ignore", invalid="ignore"):
        if all(_is_pow2(float(e))
               for e, p in zip(domain.extent, domain.periodic) if p):
            inv = np.asarray(
                [1.0 / e if _is_pow2(float(e)) else 0.0
                 for e in domain.extent], dtype=dt)
            r = q - np.floor(q * inv) * extent
            wrapped = lo + np.where(r < 0, np.zeros_like(r), r)
        else:
            wrapped = lo + np.remainder(q, extent)
        wrapped = np.where(wrapped >= lo + extent, lo, wrapped)
    return np.where(np.asarray(domain.periodic, dtype=bool), wrapped, pos)


def _cell_edges_axis(p: np.ndarray, edges, a: int) -> np.ndarray:
    ax = edges.edges[a]
    if edges.uniform_axes[a]:
        g = len(ax) - 1
        lo = np.asarray(ax[0], dtype=p.dtype)
        inv = np.asarray(g / (ax[-1] - ax[0]), dtype=p.dtype)
        with np.errstate(over="ignore", invalid="ignore"):
            c = np.floor((p - lo) * inv).astype(np.int32)
        return np.clip(c, 0, g - 1)
    inner = np.asarray(ax[1:-1], dtype=p.dtype)
    return np.searchsorted(inner, p, side="right").astype(np.int32)


def cell_of_position(pos: np.ndarray, domain: Domain, grid: ProcessGrid,
                     edges=None) -> np.ndarray:
    """``[N, D]`` positions -> ``[N, D]`` int32 cells (uniform, clamped;
    or the digitize of ``edges``)."""
    if edges is not None:
        return np.stack([_cell_edges_axis(pos[..., a], edges, a)
                         for a in range(grid.ndim)], axis=-1)
    lo = np.asarray(domain.lo, dtype=pos.dtype)
    inv_width = np.asarray(
        [s / e for s, e in zip(grid.shape, domain.extent)], dtype=pos.dtype
    )
    with np.errstate(over="ignore", invalid="ignore"):
        cell = np.floor((pos - lo) * inv_width).astype(np.int32)
    return np.clip(cell, 0, np.asarray([s - 1 for s in grid.shape],
                                       dtype=np.int32))


def rank_of_position(pos: np.ndarray, domain: Domain, grid: ProcessGrid,
                     edges=None) -> np.ndarray:
    """Wrap -> cell -> destination rank ``[N]`` int32."""
    cell = cell_of_position(wrap_periodic(pos, domain), domain, grid,
                            edges=edges)
    if edges is not None and edges.assignment is not None:
        strides = np.asarray(edges.cell_strides, dtype=np.int32)
        flat = np.sum(cell * strides, axis=-1).astype(np.int32)
        return np.asarray(edges.assignment, dtype=np.int32)[flat]
    strides = np.asarray(grid.strides, dtype=np.int32)
    return np.sum(cell * strides, axis=-1).astype(np.int32)


def redistribute_oracle(
    domain: Domain,
    grid: ProcessGrid,
    pos_shards: Sequence[np.ndarray],
    field_shards: Sequence[Sequence[np.ndarray]] = (),
    edges=None,
) -> Tuple[List[np.ndarray], List[List[np.ndarray]], np.ndarray]:
    """Simulate a full R-rank redistribute on the host.

    ``pos_shards[r]`` are rank r's ``[n_r, ndim]`` positions (ragged
    allowed), ``field_shards[r]`` its payload arrays. Returns
    ``(recv_pos, recv_fields, counts_matrix)``: rank r's received
    positions and payloads in Alltoallv order, and ``counts_matrix[s, r]``
    the rows sent s -> r."""
    R = grid.nranks
    if len(pos_shards) != R:
        raise ValueError(f"expected {R} shards, got {len(pos_shards)}")
    if field_shards and len(field_shards) != R:
        raise ValueError(
            f"expected {R} field shards, got {len(field_shards)}"
        )
    for r, fields in enumerate(field_shards):
        for f in fields:
            if f.shape[0] != pos_shards[r].shape[0]:
                raise ValueError(
                    f"rank {r}: field leading dim {f.shape[0]} != "
                    f"{pos_shards[r].shape[0]} particles"
                )
    counts = np.zeros((R, R), dtype=np.int64)
    send_rows: List[List[np.ndarray]] = []
    for s in range(R):
        dest = rank_of_position(np.asarray(pos_shards[s]), domain, grid,
                                edges=edges)
        rows = [np.flatnonzero(dest == d) for d in range(R)]
        send_rows.append(rows)
        counts[s] = [len(idx) for idx in rows]
    recv_pos: List[np.ndarray] = []
    recv_fields: List[List[np.ndarray]] = []
    nf = len(field_shards[0]) if field_shards else 0
    for d in range(R):
        recv_pos.append(np.concatenate(
            [pos_shards[s][send_rows[s][d]] for s in range(R)], axis=0))
        recv_fields.append([
            np.concatenate(
                [field_shards[s][k][send_rows[s][d]] for s in range(R)],
                axis=0)
            for k in range(nf)
        ])
    return recv_pos, recv_fields, counts


def redistribute_oracle_padded(
    domain: Domain,
    grid: ProcessGrid,
    pos: np.ndarray,
    counts: np.ndarray,
    fields: Sequence[np.ndarray],
    capacity: int,
    out_capacity: int,
    native_ok: bool = True,
    edges=None,
):
    """The padded-layout oracle, with the canonical engines' capacity
    semantics: input ``[R * n_local, ...]`` rows with ``counts[r]`` valid
    rows per shard; per REMOTE (source, dest) pair only the first
    ``capacity`` rows (stable order) are sent and the rest counted in
    ``dropped_send`` (a rank's own rows never ride the wire and are never
    clipped); each receiver keeps the first ``out_capacity`` rows of its
    Alltoallv-ordered stream and counts the rest in ``dropped_recv``.
    Padding rows are zero.

    ``native_ok`` lets the binning and the per-destination sort run in
    the C++ host runtime (:mod:`.utils.native`, uniform cells, when it is
    built), bit-identical to the NumPy path; ``False`` pins NumPy (the
    reference-equivalent CPU pipeline a benchmark baseline emulates).

    Returns ``(pos_out [R * out_capacity, ...], counts_out [R],
    fields_out, stats_dict)``."""
    R = grid.nranks
    n_local = pos.shape[0] // R
    if pos.shape[0] != R * n_local:
        raise ValueError(f"global rows {pos.shape[0]} not divisible by R={R}")
    counts = np.asarray(counts, dtype=np.int64)
    send_counts = np.zeros((R, R), dtype=np.int32)
    dropped_send = np.zeros((R,), dtype=np.int32)
    needed_capacity = np.zeros((R,), dtype=np.int32)
    send_rows: List[List[np.ndarray]] = []
    for s in range(R):
        sl = slice(s * n_local, s * n_local + int(counts[s]))
        if native_ok and edges is None:
            dest = native.bin_positions(np.asarray(pos[sl]), domain, grid)
            dcounts, order = native.count_sort(dest, R)
        elif (native_ok and edges.assignment is not None
              and all(edges.uniform_axes)):
            # uniform fine edges with an assignment: the fine lattice is a
            # uniform grid, so its flat cell is the C++ digitize against
            # it, and the rank one table gather
            flat = native.bin_positions(np.asarray(pos[sl]), domain,
                                        ProcessGrid(edges.cells_shape))
            dest = np.asarray(edges.assignment, dtype=np.int32)[flat]
            dcounts, order = native.count_sort(dest, R)
        else:
            dest = rank_of_position(np.asarray(pos[sl]), domain, grid,
                                    edges=edges)
            dcounts = np.bincount(dest, minlength=R + 1)[:R]
            order = np.argsort(dest, kind="stable")
        bounds = np.concatenate([[0], np.cumsum(dcounts)])
        remote = np.asarray(dcounts[:R]).copy()
        remote[s] = 0
        needed_capacity[s] = remote.max() if R > 1 else 0
        rows = []
        for d in range(R):
            idx = order[bounds[d]: bounds[d + 1]] + s * n_local
            if d != s:
                dropped_send[s] += max(len(idx) - capacity, 0)
                idx = idx[:capacity]
            rows.append(idx)
            send_counts[s, d] = len(idx)
        send_rows.append(rows)
    counts_out = np.zeros((R,), dtype=np.int32)
    dropped_recv = np.zeros((R,), dtype=np.int32)
    pos_out = np.zeros((R * out_capacity,) + pos.shape[1:], dtype=pos.dtype)
    fields_out = [
        np.zeros((R * out_capacity,) + f.shape[1:], dtype=f.dtype)
        for f in fields
    ]
    for d in range(R):
        idx = np.concatenate([send_rows[s][d] for s in range(R)])
        dropped_recv[d] = max(len(idx) - out_capacity, 0)
        idx = idx[:out_capacity]
        counts_out[d] = len(idx)
        sl = slice(d * out_capacity, d * out_capacity + len(idx))
        pos_out[sl] = pos[idx]
        for k, f in enumerate(fields):
            fields_out[k][sl] = f[idx]
    stats = {
        "send_counts": send_counts,
        "recv_counts": send_counts.T.copy(),
        "dropped_send": dropped_send,
        "dropped_recv": dropped_recv,
        "needed_capacity": needed_capacity,
    }
    return pos_out, counts_out, fields_out, stats


def assert_ownership(domain: Domain, grid: ProcessGrid,
                     pos_shards: Sequence[np.ndarray], edges=None) -> None:
    """Every particle a rank holds lies inside that rank's subdomain (after
    the periodic wrap; the non-uniform one when ``edges`` is given)."""
    for r, pos in enumerate(pos_shards):
        if len(pos) == 0:
            continue
        dest = rank_of_position(np.asarray(pos), domain, grid, edges=edges)
        bad = np.flatnonzero(dest != r)
        if bad.size:
            raise AssertionError(
                f"rank {r}: {bad.size} particles outside subdomain, e.g. "
                f"{np.asarray(pos)[bad[0]]} -> rank {dest[bad[0]]}"
            )


def brute_force_ghosts(
    domain: Domain,
    grid: ProcessGrid,
    pos_shards: Sequence[np.ndarray],
    halo_width,
) -> List[np.ndarray]:
    """Set-level halo oracle: for each rank, every particle (from any
    shard, under every periodic image shift) inside the rank's subdomain
    widened by ``halo_width`` but NOT inside the subdomain itself, as
    float32 ``[g, ndim]``. Comparisons are float64 (the shifted position
    ``p + shift`` and the box bounds), as in the reference's oracle.

    The engines also fix a ghost ORDER; this defines the SET, compared
    after sorting rows. Rows come out in the reference's loop order
    (source shard, particle, image shift), computed with one pass over
    all particles per shift and grid coordinate instead of the
    reference's per-particle loops. A scalar width broadcasts over axes.
    """
    R = grid.nranks
    ndim = domain.ndim
    ext = np.asarray(domain.extent)
    w = np.asarray(halo_width, dtype=np.float64)
    if w.ndim == 0:
        w = np.full((ndim,), float(w))
    shifts = np.asarray([
        np.asarray(vec) * ext for vec in itertools.product(*[
            (-1, 0, 1) if domain.periodic[a] else (0,) for a in range(ndim)
        ])
    ])
    pts = [np.asarray(p) for p in pos_shards]
    pts = [p for p in pts if len(p)]
    if not pts:
        return [np.zeros((0, ndim), np.float32) for _ in range(R)]
    P = np.concatenate(pts, axis=0)
    boxes = [grid.subdomain_of_rank(d, domain) for d in range(R)]
    hit = np.zeros((R, len(P), len(shifts)), dtype=bool)
    for s, v in enumerate(shifts):
        q = P + v  # float64
        # (axis, lo) -> (inside the widened interval, inside the owned
        # one): a rank's box test is the AND of its axes' intervals
        axis_tests = {}
        for d, (lo, hi) in enumerate(boxes):
            wide = own = True
            for a in range(ndim):
                key = (a, lo[a])
                if key not in axis_tests:
                    qa = q[:, a]
                    axis_tests[key] = (
                        (qa >= lo[a] - w[a]) & (qa < hi[a] + w[a]),
                        (qa >= lo[a]) & (qa < hi[a]))
                wide = wide & axis_tests[key][0]
                own = own & axis_tests[key][1]
            hit[d, :, s] = wide & ~own
    out = []
    for d in range(R):
        p_idx, s_idx = np.nonzero(hit[d])
        out.append((P[p_idx] + shifts[s_idx]).astype(np.float32))
    return out
