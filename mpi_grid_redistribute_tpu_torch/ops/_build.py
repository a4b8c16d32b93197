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
kernel (:func:`reset_counts`, :func:`counts`), and, where one source has
several routes, its launches by route (``Kernel.routes``).
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
# -split-compile=0: nvcc optimizes a source's kernels on every core at once
# (dfscan.cu's 51 template instances build in ~20 s instead of ~34 on the
# card's 8 cores)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-split-compile=0", "-shared", "-Xcompiler", "-fPIC",
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
    entry returns an ``int`` CUDA error code. ``entries`` names further C
    entries of the same source with their argtypes (a launch picks one by
    ``entry=``), and ``routes`` the routes whose launches ``routes``
    counts apart; :attr:`launches` counts them all."""

    def __init__(self, name: str, source: str, entry: str, argtypes,
                 entries: dict = None, routes=()):
        self.name = name
        self.source = CSRC / source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.entries = {entry: self.argtypes, **(entries or {})}
        self.launches = 0
        self.routes = dict.fromkeys(routes, 0)
        self._fn = None
        self._strerror = None
        self._usage = None
        self._lock = threading.Lock()

    def lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):  # what a source includes
            h.update(header.read_bytes())
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
                fn = {}
                for entry, argtypes in self.entries.items():
                    fn[entry] = getattr(lib, entry)
                    fn[entry].argtypes = argtypes
                    fn[entry].restype = ctypes.c_int
                err = getattr(lib, f"{self.source.stem}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                usage = getattr(lib, f"{self.source.stem}_resource_usage")
                usage.argtypes = [ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.POINTER(ctypes.c_int)]
                usage.restype = ctypes.c_int
                self._fn, self._strerror, self._usage = fn, err, usage
        return self._fn

    def resource_usage(self) -> dict:
        """``{function: attributes}`` for every ``__global__`` function of
        the source (``csrc/resource_usage.cuh``): ``regs`` a thread,
        ``static_smem`` and ``local_bytes`` (spills) in bytes,
        ``max_threads`` a block and the binary's ``sm`` version, as
        ``cudaFuncGetAttributes`` reads them on the current card."""
        self.load()
        out = {}
        name = ctypes.c_char_p()
        vals = (ctypes.c_int * 5)()
        i = 0
        while True:
            code = self._usage(i, ctypes.byref(name), vals)
            if name.value is None:
                return out
            if code != 0:
                msg = self._strerror(code).decode()
                fn = name.value.decode()
                raise RuntimeError(
                    f"{self.name}: cudaFuncGetAttributes({fn}) failed: CUDA "
                    f"error {code} ({msg})")
            out[name.value.decode()] = dict(zip(
                ("regs", "static_smem", "local_bytes", "max_threads", "sm"),
                (int(v) for v in vals)))
            i += 1

    def call(self, *args, entry: str = None) -> None:
        """Call a C entry (``entry``, default the first) and raise on a
        CUDA error; counts nothing, as for an entry that launches nothing
        (a size query)."""
        code = self.load()[entry or self.entry](*args)
        if code != 0:
            msg = self._strerror(code).decode()
            raise RuntimeError(f"{self.name}: CUDA error {code} ({msg})")

    def launch(self, *args, entry: str = None, route: str = None) -> None:
        """Launch through the C entry (``entry``, default the first),
        raise on a CUDA error, count it (and under ``route``)."""
        self.call(*args, entry=entry)
        self.launches += 1
        if route is not None:
            self.routes[route] += 1


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


def nvcc_version() -> str:
    """The toolkit that builds the kernels, as ``nvcc --version``'s last
    ``V<major>.<minor>.<patch>`` token (the whole last line when it has
    none)."""
    out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout.strip()
    last = out.splitlines()[-1] if out else ""
    for tok in reversed(out.replace(",", " ").split()):
        if tok.startswith("V") and tok[1:2].isdigit():
            return tok[1:]
    return last


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        for route in k.routes:
            k.routes[route] = 0


def counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def out_tensor(_out, shape, dtype, like, what: str):
    """The internal ``_out=`` hook of the kernels that allocate their
    outputs (``analysis.kernelcheck`` places them inside guard bands):
    ``torch.empty`` on ``like``'s device when ``_out`` is None, else
    ``_out`` once it is checked to be a contiguous ``dtype`` ``shape``
    there."""
    import torch

    if _out is None:
        return torch.empty(shape, dtype=dtype, device=like.device)
    if (tuple(_out.shape) != tuple(shape) or _out.dtype != dtype
            or _out.device != like.device or not _out.is_contiguous()):
        raise ValueError(
            f"{what}: _out must be a contiguous {dtype} {tuple(shape)} on "
            f"{like.device}, got {_out.dtype} {tuple(_out.shape)} on "
            f"{_out.device}")
    return _out


def into(_out, t, what: str):
    """The plain route's side of the ``_out=`` hook: ``t`` itself, or
    ``t`` copied into the checked ``_out``."""
    if _out is None:
        return t
    return out_tensor(_out, t.shape, t.dtype, t, what).copy_(t)


def stream_ptr(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for the C entries."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
