"""Checkpoint and resume of particle state (the JAX package's
``utils/checkpoint.py``, its on-disk format kept byte for byte, so a
snapshot written by either package loads in the other).

* :func:`save` / :func:`load`: one ``np.savez_compressed`` file per shard
  plus a JSON manifest with a sha256 per shard file, so an R-shard run
  restarts on another shard count (shard r owns rows ``[r*n_local,
  (r+1)*n_local)``). ``save`` takes tensors (any device) and NumPy
  arrays alike; tensors are copied to the host first.
* Atomic publish: the snapshot is staged in a ``<dir>.tmp-<pid>``
  sibling and renamed into place, so a crash mid-write never leaves a
  half-visible snapshot; ``load`` checks every shard's checksum and
  raises :class:`CheckpointCorruptError` naming the bad shard.
* :func:`load_latest` scans a directory of snapshots newest first and
  returns the first that loads clean, counting the invalid ones it
  skipped (the supervisor's restore path); :func:`gather_live` strips
  the padding of a loaded snapshot (the elastic restore's first half).

The reference's ``save_orbax``/``load_orbax`` pass through to orbax, a
JAX library; they are not part of the port.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import io
import json
import os
import shutil
import zipfile
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

_MANIFEST = "manifest.json"
_TMP_TAG = ".tmp-"
_OLD_TAG = ".old-"


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class CheckpointCorruptError(RuntimeError):
    """A snapshot failed to load: torn shard, checksum mismatch, missing
    file, or an unreadable manifest. ``shard`` names the offending file
    (``manifest.json`` when the manifest itself is bad)."""

    def __init__(self, directory: str, shard: str, detail: str):
        self.directory = directory
        self.shard = shard
        self.detail = detail
        super().__init__(
            f"corrupt checkpoint {directory!r} (shard {shard}): {detail}"
        )


class LatestCheckpoint(NamedTuple):
    """Result of :func:`load_latest`: the newest snapshot that loaded
    clean, plus how many newer-but-invalid ones were skipped over."""

    arrays: Dict[str, np.ndarray]
    manifest: dict
    path: str
    skipped: int


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save(
    directory: str,
    arrays: Dict[str, np.ndarray],
    nranks: int,
    step: int = 0,
    extra: Optional[dict] = None,
    per_shard: Sequence[str] = ("count",),
) -> None:
    """Write one npz per shard + a manifest, published atomically.

    ``arrays`` maps names to global padded arrays (NumPy arrays or
    tensors on any device, copied to the host first) whose leading dim divides
    by ``nranks`` (the library's global layout). Names listed in
    ``per_shard`` are instead treated as [nranks]-shaped per-shard scalar
    vectors (one entry per shard, e.g. the ``count`` array); membership is
    by name, never inferred from shape, so a genuine global 1-D array that
    happens to have ``nranks`` rows shards normally.

    Shards are compressed on parallel threads. The whole snapshot is
    staged in a ``<directory>.tmp-<pid>`` sibling
    and renamed into place only once every shard and the manifest (with
    per-shard sha256 checksums) are on disk — readers either see the
    previous complete snapshot or the new complete one, never a torn mix.
    """
    per_shard = tuple(per_shard)
    arrays = {name: _host(a) for name, a in arrays.items()}
    rows = None
    for name, a in arrays.items():
        if name in per_shard:
            if a.shape != (nranks,):
                raise ValueError(
                    f"per-shard array {name!r} must have shape "
                    f"({nranks},), got {a.shape}"
                )
            continue
        if a.shape[0] % nranks:
            raise ValueError(
                f"array {name!r} leading dim {a.shape[0]} does not divide "
                f"over {nranks} shards"
            )
        r = a.shape[0] // nranks
        if rows is None:
            rows = r
        elif rows != r:
            raise ValueError(
                f"array {name!r} has {r} rows/shard, expected {rows}"
            )
    if rows is None:
        raise ValueError("no global arrays to checkpoint")

    directory = directory.rstrip(os.sep)
    parent = os.path.dirname(directory)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = f"{directory}{_TMP_TAG}{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    def write_shard(rank: int) -> Tuple[str, str]:
        shard = {}
        for name, a in arrays.items():
            if name in per_shard:
                shard[name] = a[rank : rank + 1]
            else:
                shard[name] = a[rank * rows : (rank + 1) * rows]
        fname = f"shard_{rank:05d}.npz"
        np.savez_compressed(os.path.join(tmp, fname), **shard)
        return fname, _sha256_file(os.path.join(tmp, fname))

    # shards compress on parallel threads (zlib releases the GIL): the
    # same files as one after another, in a fraction of the time
    workers = max(1, min(nranks, os.cpu_count() or 1))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        checksums: Dict[str, str] = dict(pool.map(write_shard,
                                                  range(nranks)))
    manifest = {
        "nranks": nranks,
        "rows_per_shard": rows,
        "step": step,
        "names": sorted(arrays.keys()),
        "per_shard": sorted(n for n in per_shard if n in arrays),
        "checksums": checksums,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())

    # atomic publish: the target either keeps its old complete content or
    # gains the new complete content — os.rename of the staged dir is the
    # commit point. An existing target is swung aside first (rename is
    # atomic; rmtree of the retired copy is not, but at that point it is
    # no longer the visible snapshot).
    if os.path.isdir(directory):
        old = f"{directory}{_OLD_TAG}{os.getpid()}"
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.rename(directory, old)
        os.rename(tmp, directory)
        shutil.rmtree(old)
    else:
        os.rename(tmp, directory)


def _read_manifest(directory: str) -> dict:
    path = os.path.join(directory, _MANIFEST)
    try:
        with open(path, encoding="utf-8") as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(directory, _MANIFEST, str(e)) from e
    for key in ("nranks", "rows_per_shard", "names"):
        if key not in manifest:
            raise CheckpointCorruptError(
                directory, _MANIFEST, f"missing manifest key {key!r}"
            )
    return manifest


def load(
    directory: str, ranks: Optional[Sequence[int]] = None
) -> Tuple[Dict[str, np.ndarray], dict]:
    """Read shards back into global arrays. Returns ``(arrays, manifest)``.

    ``ranks`` restricts loading to a subset of shards (concatenated in the
    given order) — the resume path for re-decomposing onto a different
    grid: load everything, then :func:`..api.redistribute` once.

    Every shard is checksum-verified against the manifest (when the
    manifest carries checksums — pre-hardening snapshots without them
    still load); any torn zip, missing file, missing array, or checksum
    mismatch raises :class:`CheckpointCorruptError` naming the shard.
    """
    manifest = _read_manifest(directory)
    nranks = manifest["nranks"]
    checksums = manifest.get("checksums", {})
    if ranks is None:
        ranks = range(nranks)
    ranks = list(ranks)
    for rank in ranks:
        if not 0 <= rank < nranks:
            raise ValueError(f"rank {rank} outside checkpoint of {nranks}")

    def read_shard(rank: int) -> List[np.ndarray]:
        fname = f"shard_{rank:05d}.npz"
        path = os.path.join(directory, fname)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise CheckpointCorruptError(directory, fname, str(e)) from e
        want = checksums.get(fname)
        if want is not None:
            got = hashlib.sha256(raw).hexdigest()
            if got != want:
                raise CheckpointCorruptError(
                    directory,
                    fname,
                    f"sha256 mismatch: manifest {want[:12]}…, "
                    f"file {got[:12]}…",
                )
        try:
            with np.load(io.BytesIO(raw)) as z:
                return [z[name] for name in manifest["names"]]
        except (zipfile.BadZipFile, KeyError, OSError, ValueError) as e:
            raise CheckpointCorruptError(
                directory, fname, f"{type(e).__name__}: {e}"
            ) from e

    # shards are read, checked and decompressed on parallel threads; the
    # first bad shard in the given order is the one reported
    workers = max(1, min(len(ranks), os.cpu_count() or 1))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        shards = list(pool.map(read_shard, ranks))
    return {
        name: np.concatenate([sh[k] for sh in shards], axis=0)
        for k, name in enumerate(manifest["names"])
    } if shards else {}, manifest


def gather_live(
    arrays: Dict[str, np.ndarray],
    nranks: int,
    rows_per_shard: int,
    count_key: str = "count",
) -> Dict[str, np.ndarray]:
    """Strip padding from a loaded snapshot: concatenate each shard's
    first ``count[r]`` rows, dropping the dead tail slots.

    The elastic-restore first half: a snapshot's global layout is only
    meaningful at its own ``(nranks, rows_per_shard)``; the live rows are
    mesh-independent. Returns every global array reduced to ``[N, ...]``
    live rows (same relative order as on disk) plus ``count_key`` mapped
    to the scalar total — ready for :func:`..api.reshard` onto any grid.
    """
    count = _host(arrays[count_key]).astype(np.int64).ravel()
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
        a = _host(a)
        if a.shape[0] != nranks * rows_per_shard:
            raise ValueError(
                f"array {name!r} leading dim {a.shape[0]} is not the "
                f"global layout {nranks}*{rows_per_shard}"
            )
        live[name] = a[idx]
    return live


def list_snapshots(root: str) -> List[str]:
    """Candidate snapshot directories under ``root``, newest first.

    Any subdirectory not left over from a staged/retired write
    (``.tmp-``/``.old-`` suffixes) is a candidate — even one with a
    missing or broken manifest, so :func:`load_latest` can *count* it as
    skipped instead of silently ignoring a torn newest snapshot. Ordered
    by manifest ``step`` when readable, falling back to directory mtime.
    """
    if not os.path.isdir(root):
        return []
    cands = []
    for name in sorted(os.listdir(root)):
        if _TMP_TAG in name or _OLD_TAG in name:
            continue
        path = os.path.join(root, name)
        if not os.path.isdir(path):
            continue
        try:
            with open(os.path.join(path, _MANIFEST), encoding="utf-8") as f:
                step = int(json.load(f)["step"])
        except (OSError, ValueError, KeyError, TypeError):
            step = -1  # unreadable manifest: sorts oldest, still listed
        cands.append((step, os.stat(path).st_mtime_ns, name, path))
    cands.sort(reverse=True)
    return [c[-1] for c in cands]


def load_latest(
    root: str, ranks: Optional[Sequence[int]] = None
) -> Optional[LatestCheckpoint]:
    """Load the newest snapshot under ``root`` that passes validation.

    Invalid snapshots (torn shards, checksum mismatches, broken
    manifests) are skipped, newest-first, and counted — the supervisor
    journals that count in its ``restore`` event so a corrupted snapshot
    is never silently stepped over. Returns ``None`` when no valid
    snapshot exists.
    """
    skipped = 0
    for path in list_snapshots(root):
        try:
            arrays, manifest = load(path, ranks=ranks)
        except CheckpointCorruptError:
            skipped += 1
            continue
        return LatestCheckpoint(arrays, manifest, path, skipped)
    return None
