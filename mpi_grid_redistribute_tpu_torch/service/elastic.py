"""Particle-set audit of a service state (the part of the JAX package's
``service/elastic.py`` the chunked service step needs; its
``reshard_state`` waits for the service driver).

:func:`particle_set` is the equality two runs of the service loop are
held to: the same particles with the same bits, whichever shard holds
which row."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def gather_live(arrays: Dict[str, np.ndarray], nranks: int,
                rows_per_shard: int,
                count_key: str = "count") -> Dict[str, np.ndarray]:
    """Strip the padding of a global padded layout: each shard's first
    ``count[r]`` rows, concatenated in shard order, for every array, and
    ``count_key`` mapped to the total (the reference's
    ``utils/checkpoint.gather_live``)."""
    count = np.asarray(arrays[count_key]).astype(np.int64).ravel()
    if count.shape != (nranks,):
        raise ValueError(
            f"count array {count.shape} does not match {nranks} shards"
        )
    if count.min() < 0 or count.max() > rows_per_shard:
        raise ValueError(
            f"count outside [0, {rows_per_shard}]: {count.tolist()}"
        )
    idx = np.concatenate(
        [
            np.arange(r * rows_per_shard, r * rows_per_shard + count[r])
            for r in range(nranks)
        ]
    ) if nranks else np.zeros((0,), dtype=np.int64)
    live: Dict[str, np.ndarray] = {}
    for name, a in arrays.items():
        if name == count_key:
            live[name] = np.asarray(count.sum(), dtype=np.int64)
            continue
        a = np.asarray(a)
        if a.shape[0] != nranks * rows_per_shard:
            raise ValueError(
                f"array {name!r} leading dim {a.shape[0]} is not the "
                f"global layout {nranks}*{rows_per_shard}"
            )
        live[name] = a[idx]
    return live


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
