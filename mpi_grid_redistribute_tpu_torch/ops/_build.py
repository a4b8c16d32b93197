"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes`` and called with
raw device pointers and PyTorch's current stream. Nothing is built when
this module is imported: a kernel builds on its first launch, or all at
once, in parallel, through :func:`build_all`. Libraries land in
``build/kernels/`` beside the package, named by a hash of the source and
the flags, so a changed source rebuilds and an unchanged one is reused.

Every C entry returns ``cudaGetLastError()`` after its launch;
:meth:`Kernel.launch` raises when that is not 0 (a refused launch never
runs, and a later synchronize would not report it). Each kernel counts
its launches, so a run can show that its main path went through the
kernel (:func:`reset_counts`, :func:`counts`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the CUDA kernels are compiled at first use"
    )


class Kernel:
    """One CUDA source and its C entry point.

    ``argtypes`` are the ctypes types of the entry's arguments (pointers
    and the stream as ``c_void_p``, so 64-bit values are not cut); the
    entry returns an ``int`` CUDA error code."""

    def __init__(self, name: str, source: str, entry: str, argtypes):
        self.name = name
        self.source = CSRC / source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._strerror = None
        self._lock = threading.Lock()

    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start ``nvcc`` for this source; ``None`` when already built.
        Returns ``(process, tmp_path, lib_path)``."""
        lib = self.lib_path()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        return proc, tmp, lib

    def _finish_build(self, job) -> None:
        proc, tmp, lib = job
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source.name} "
                f"(exit {proc.returncode}):\n{out}"
            )
        os.replace(tmp, lib)

    def load(self):
        with self._lock:
            if self._fn is None:
                job = self.start_build()
                if job is not None:
                    self._finish_build(job)
                lib = ctypes.CDLL(str(self.lib_path()))
                fn = getattr(lib, self.entry)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = getattr(lib, f"{self.source.stem}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._fn, self._strerror = fn, err
        return self._fn

    def launch(self, *args) -> None:
        """Launch through the C entry, raise on a CUDA error, count it."""
        fn = self.load()
        code = fn(*args)
        if code != 0:
            msg = self._strerror(code).decode()
            raise RuntimeError(f"{self.name}: CUDA error {code} ({msg})")
        self.launches += 1


KERNELS: dict = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def build_all() -> None:
    """Compile every registered kernel that is not built yet, one
    ``nvcc`` per source, all started together."""
    jobs = []
    for k in KERNELS.values():
        job = k.start_build()
        if job is not None:
            jobs.append((k, job))
    errors = []
    for k, job in jobs:  # wait for every nvcc before raising
        try:
            k._finish_build(job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in KERNELS.values():
        k.load()


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def stream_ptr(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for the C entries."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
