"""Elastic restore: re-shard a snapshot onto another grid (the JAX
package's ``service/elastic.py``).

Ownership follows POSITION, never the shard that wrote a row, so
re-decomposing R snapshot shards onto an M-rank
:class:`~..domain.ProcessGrid` is one canonical redistribute over the
live rows. :func:`reshard_state` strips the padding
(:func:`~..utils.checkpoint.gather_live`), routes the live rows with
:func:`~..api.reshard` on the numpy backend (a restore runs on the host
and must not need the lost devices), and counts the rows that landed on
another rank index than the shard that snapshotted them (the ``moved``
of the driver's ``reshard`` event). Values are only permuted, so the
global particle SET does not depend on the grid: :func:`particle_set`
gives the bytes two runs are held to.
"""

from __future__ import annotations

# gridlint: service-path

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from mpi_grid_redistribute_tpu_torch.domain import Domain, ProcessGrid
from mpi_grid_redistribute_tpu_torch.utils import checkpoint
from mpi_grid_redistribute_tpu_torch.utils.checkpoint import (  # noqa: F401
    _host,
    gather_live,
)


class ElasticRestoreError(RuntimeError):
    """A snapshot cannot be restored onto the configured grid: the shapes
    disagree and auto-reshard is off (or no grid fits the surviving
    device budget). The message names both shapes."""


class ReshardedState(NamedTuple):
    """Outcome of :func:`reshard_state`: the snapshot laid out on the new
    grid's global padded layout (NumPy arrays)."""

    arrays: Dict[str, np.ndarray]
    n_local: int
    moved_rows: int
    live_rows: int


def reshard_state(
    arrays: Dict[str, np.ndarray],
    manifest: dict,
    grid_shape,
    domain: Optional[Domain] = None,
    n_local: Optional[int] = None,
    pos_key: str = "pos",
    count_key: str = "count",
) -> ReshardedState:
    """Re-shard a loaded snapshot onto ``grid_shape`` in one redistribute.

    ``arrays``/``manifest`` are :func:`~..utils.checkpoint.load_latest`'s;
    every global array but ``pos_key`` rides the permutation as a field.
    ``n_local`` defaults to ``ceil(R * rows_per_shard / M)``: the total
    slot capacity is kept, so a shrink to half the ranks doubles the
    padding a rank (the engine still grows if the skew needs more). The
    returned ``n_local`` is the output layout's rows a rank.
    ``moved_rows`` counts live rows whose owner under the new grid is
    another index than the snapshot shard that held them."""
    from mpi_grid_redistribute_tpu_torch import api
    from mpi_grid_redistribute_tpu_torch.ops import binning

    grid = (
        grid_shape
        if isinstance(grid_shape, ProcessGrid)
        else ProcessGrid(tuple(int(x) for x in grid_shape))
    )
    if domain is None:
        domain = Domain(0.0, 1.0, periodic=True)
    nranks = int(manifest["nranks"])
    rows = int(manifest["rows_per_shard"])
    count_vec = _host(arrays[count_key]).astype(np.int64).ravel()
    live = checkpoint.gather_live(arrays, nranks, rows, count_key=count_key)
    field_names = [n for n in sorted(live) if n not in (pos_key, count_key)]
    m = grid.nranks
    if n_local is None:
        n_local = max(1, -(-(nranks * rows) // m))
    res = api.reshard(
        live[pos_key],
        *(live[n] for n in field_names),
        domain=domain,
        grid=grid,
        n_local=int(n_local),
        backend="numpy",
    )
    out = {pos_key: _host(res.positions)}
    for name, f in zip(field_names, res.fields):
        out[name] = _host(f)
    out[count_key] = _host(res.count)
    rows_out = out[pos_key].shape[0] // m
    old_shard = np.repeat(np.arange(nranks, dtype=np.int64), count_vec)
    owner = binning.rank_of_position(
        torch.from_numpy(np.ascontiguousarray(live[pos_key])), domain, grid
    ).numpy().astype(np.int64)
    moved = int((owner != old_shard).sum())
    return ReshardedState(
        arrays=out,
        n_local=int(rows_out),
        moved_rows=moved,
        live_rows=int(old_shard.shape[0]),
    )


def particle_set(pos, vel, ids, count) -> bytes:
    """Canonical bytes of the global particle SET of a service state
    (NumPy arrays or tensors on any device): live rows gathered across
    shards, stably sorted by id, then the raw bytes of ``ids``, ``pos``
    and ``vel``. Two states agree iff they hold the same particles with
    the same bits, whichever shard owns which row."""
    count = _host(count).astype(np.int64).ravel()
    nranks = count.shape[0]
    pos = _host(pos)
    rows = pos.shape[0] // max(nranks, 1)
    live = gather_live(
        {"pos": pos, "vel": _host(vel), "ids": _host(ids), "count": count},
        nranks, rows,
    )
    order = np.argsort(live["ids"], kind="stable")
    return b"".join(
        np.ascontiguousarray(live[k][order]).tobytes()
        for k in ("ids", "pos", "vel")
    )
