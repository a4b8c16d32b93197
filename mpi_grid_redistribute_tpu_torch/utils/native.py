"""ctypes binding of the C++ host runtime (``native/grid_redistribute_
native.cpp``): digitize, counting-sort pack and row gather for the CPU
oracle and the host-side comparators (the port's copy of the JAX
package's ``utils/native.py``, the same entry points and fallbacks).

Building is opt-in: :func:`build` compiles the source with ``g++ -O3
-march=native -shared -fPIC`` into ``build/native/`` beside the package,
the library named by a hash of the source and the flags, so a changed
source rebuilds and an unchanged one is reused (the scheme of
``ops/_build.py``). ``MPI_GRID_NATIVE_BUILD=1`` lets the first use build
it; ``MPI_GRID_NO_NATIVE=1`` never loads it. Every entry point has a NumPy
fallback, bit-identical, and the first fallback on a native-requested
call is logged; :func:`available` says which path is live.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "grid_redistribute_native.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_logged_fallback = False
_log = logging.getLogger(__name__)


def lib_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libgrid_redistribute_native-{h.hexdigest()[:16]}.so"


def _compile(timeout: float) -> bool:
    if not SOURCE.exists():
        _log.warning("native source missing: %s", SOURCE)
        return False
    lib = lib_path()
    if lib.exists():
        return True
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=timeout)
        os.replace(tmp, lib)  # atomic: a reader never sees half a library
    except (subprocess.SubprocessError, OSError) as e:
        _log.warning("native build failed (%s); using NumPy fallback", e)
        tmp.unlink(missing_ok=True)
        return False
    return True


def build(timeout: float = 120) -> bool:
    """Compile (if needed) and load the library; True when it is usable
    afterwards, False (with a log line) otherwise."""
    global _tried
    if os.environ.get("MPI_GRID_NO_NATIVE"):
        return False  # opted out: never compile
    if _load() is not None:
        return True
    if not _compile(timeout):
        return False
    with _lock:
        _tried = False  # retry the load now that the library exists
    return _load() is not None


def _note_fallback() -> None:
    """Log once when a native-requested call falls back to NumPy."""
    global _logged_fallback
    if os.environ.get("MPI_GRID_NO_NATIVE"):
        return  # the fallback is what was asked for
    with _lock:
        if _logged_fallback:
            return
        _logged_fallback = True
    _log.warning(
        "C++ host runtime unavailable (call utils.native.build() or "
        "set MPI_GRID_NATIVE_BUILD=1); using NumPy fallback"
    )


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, or None. The lock guards only the handoff;
    the probe, the opt-in build and ``dlopen`` run outside it."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
    lib = _probe_and_load()
    with _lock:
        _lib = lib
        return _lib


def _probe_and_load() -> Optional[ctypes.CDLL]:
    if os.environ.get("MPI_GRID_NO_NATIVE") or not SOURCE.exists():
        return None
    path = lib_path()
    if not path.exists() and os.environ.get("MPI_GRID_NATIVE_BUILD"):
        _compile(120)
    if not path.exists():
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    if lib.grn_abi_version() != 1:
        return None
    lib.grn_bin.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.grn_count_sort.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.grn_gather_rows.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_char_p,
    ]
    return lib


def available() -> bool:
    """True when the C++ library is loaded (vs the NumPy fallback)."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def bin_positions(pos: np.ndarray, domain, grid) -> np.ndarray:
    """Destination rank per row, the C++ twin of
    ``oracle.rank_of_position`` (uniform cells)."""
    lib = _load()
    if lib is None:
        _note_fallback()
        from mpi_grid_redistribute_tpu_torch import oracle

        return oracle.rank_of_position(np.asarray(pos), domain, grid)
    pos = np.ascontiguousarray(pos, dtype=np.float32)
    n, ndim = pos.shape
    lo = np.asarray(domain.lo, dtype=np.float64)
    hi = np.asarray(domain.hi, dtype=np.float64)
    per = np.asarray(domain.periodic, dtype=np.int32)
    gshape = np.asarray(grid.shape, dtype=np.int32)
    dest = np.empty((n,), dtype=np.int32)
    lib.grn_bin(_ptr(pos, ctypes.c_float), n, ndim,
                _ptr(lo, ctypes.c_double), _ptr(hi, ctypes.c_double),
                _ptr(per, ctypes.c_int32), _ptr(gshape, ctypes.c_int32),
                _ptr(dest, ctypes.c_int32))
    return dest


def count_sort(dest: np.ndarray, nranks: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(counts, stable order grouping rows by destination)``; sentinel
    ``nranks`` entries group at the tail and are not counted. An O(N + R)
    counting sort in C++; the fallback is bincount + a stable argsort."""
    lib = _load()
    dest = np.ascontiguousarray(dest, dtype=np.int32)
    if lib is None:
        _note_fallback()
        counts = np.bincount(dest, minlength=nranks + 1)[:nranks]
        return (counts.astype(np.int64),
                np.argsort(dest, kind="stable").astype(np.int64))
    n = dest.shape[0]
    counts = np.empty((nranks,), dtype=np.int64)
    order = np.empty((n,), dtype=np.int64)
    lib.grn_count_sort(_ptr(dest, ctypes.c_int32), n, nranks,
                       _ptr(counts, ctypes.c_int64),
                       _ptr(order, ctypes.c_int64))
    return counts, order


def gather_rows(src: np.ndarray, order: np.ndarray) -> np.ndarray:
    """``out[j] = src[order[j]]``, the pack gather, one memcpy pass in
    C++."""
    lib = _load()
    if lib is None:
        _note_fallback()
        return src[order]
    src = np.ascontiguousarray(src)
    order = np.ascontiguousarray(order, dtype=np.int64)
    out = np.empty((order.shape[0],) + src.shape[1:], dtype=src.dtype)
    row_bytes = src.dtype.itemsize
    for s in src.shape[1:]:
        row_bytes *= s
    lib.grn_gather_rows(src.ctypes.data_as(ctypes.c_char_p),
                        _ptr(order, ctypes.c_int64), order.shape[0],
                        row_bytes, out.ctypes.data_as(ctypes.c_char_p))
    return out
