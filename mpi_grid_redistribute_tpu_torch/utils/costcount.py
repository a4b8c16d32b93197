"""Counted costs of a program: the bytes it moves, the flops it does and
the collective payloads it sends, the port's counterpart of XLA's
``cost_analysis()`` (``telemetry.roofline.count_cost`` is the entry
point; this module holds the machinery the kernels and collectives hook
into, and imports nothing of the port).

The rules, whichever device runs the program:

* **bytes**: each aten op the program dispatches counts every tensor it
  reads and every tensor it writes, once each (``numel * itemsize`` of
  the tensor as the op sees it). An argument the op mutates is read and
  written (``add_``), but the arguments of a pure write (``copy_``,
  ``fill_``, ``zero_`` and ``out=``) are written only. An in-place
  scatter (``index_put_``, ``scatter_``, ``index_add_``,
  ``masked_scatter_`` and their kin) writes only the elements it
  addresses: its target counts those, twice where it accumulates
  (read-modify-write), never the whole tensor. View and metadata ops (an
  op that writes nothing and returns only aliases of its inputs),
  allocations (``empty*``) and copies between the host and the device
  (a transfer over the bus, not the device's memory traffic; on the CPU
  the same ``.to(device)`` dispatches nothing) count 0.
* **flops**: ``torch.utils.flop_counter``'s formulas for products, one
  flop per output element of a pointwise op with a floating-point output
  (data movement such as ``clone``, ``where`` and ``masked_fill`` not
  included), and one per input element of a floating-point reduction or
  scan. Integer, compare and index ops count 0.
* **each kernel** (the public functions of ``ops/driftbin.py``,
  ``ops/overlay.py``, ``ops/segdep.py``, ``ops/dfscan.py`` and
  ``ops/scatter.py``, and their plain versions) counts its own bytes and
  flops by the formula beside it (:func:`kernel_scope`), the traffic its
  bound in ``chip_smoke.py`` divides by. The aten ops issued inside the
  scope (the plain version's on the CPU, the wrapper's on the card) are
  not counted, and the kernel itself is a ``ctypes`` launch no dispatch
  mode sees, so a program counts the same on either route.
* **collectives**: ``parallel/collectives.py`` reports each payload it
  puts on the wire (:func:`count_collective`), once a call, under the
  reference's primitive name; a mesh without a process group issues
  none and reports nothing.

Counting is per thread: only the thread inside :func:`counting` counts,
and a kernel scope costs one attribute read when nothing counts.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten

# ops that allocate or reshape without moving data
_FREE = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten.resize_.default,
    _aten.set_.source_Storage_storage_offset, _aten.set_.source_Tensor,
    _aten._unsafe_view.default,
}
# copies, which count 0 between the host and the device
_COPY = {
    _aten._to_copy.default, _aten.copy_.default, _aten._copy_from.default,
    _aten._copy_from_and_resize.default,
}
# in-place ops whose mutated argument is written, never read
_WRITE_ONLY = {
    _aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
    _aten.zero_.default,
}
# in-place scatters: the target is written where addressed, not whole
_ACCUMULATE = {
    _aten.scatter_add_.default, _aten.index_add_.default,
    _aten.scatter_reduce_.two, _aten.index_reduce_.default,
}
_SCATTER = _ACCUMULATE | {
    _aten.index_put_.default, _aten._index_put_impl_.default,
    _aten.scatter_.src, _aten.scatter_.value, _aten.scatter_.reduce,
    _aten.scatter_.value_reduce, _aten.index_copy_.default,
    _aten.index_fill_.int_Scalar, _aten.index_fill_.int_Tensor,
    _aten.masked_scatter_.default, _aten.put_.default,
}
# pointwise-tagged ops that move data rather than compute on it
_NOT_ARITH = {
    _aten.clone, _aten.where, _aten.masked_fill, _aten.masked_fill_,
    _aten.lift_fresh_copy, _aten.copy, _aten.alias_copy,
}
# floating-point reductions and scans: one flop an input element
_REDUCE = {
    _aten.sum, _aten.cumsum, _aten.cumsum_, _aten.mean, _aten.prod,
    _aten.cumprod, _aten.nansum, _aten.amax, _aten.amin,
}


class CostCounter:
    """What one :func:`counting` block saw."""

    def __init__(self):
        self.bytes_accessed = 0
        self.flops = 0
        self.ops = 0
        self.collective_bytes: Dict[str, int] = {}
        self.collective_count = 0
        self.kernels: Dict[str, dict] = {}

    def as_dict(self) -> dict:
        return {
            "flops": int(self.flops),
            "bytes_accessed": int(self.bytes_accessed),
            "ops": self.ops,
            "collective_bytes": dict(sorted(self.collective_bytes.items())),
            "collective_bytes_total": int(sum(
                self.collective_bytes.values())),
            "collective_count": self.collective_count,
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
        }


class _State(threading.local):
    def __init__(self):
        self.counters = []
        self.depth = 0  # nesting of kernel scopes


_STATE = _State()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(v):
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        return [t for t in v if isinstance(t, torch.Tensor)]
    return []


def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _scattered(func, args, kwargs) -> int:
    """Elements an in-place scatter writes into its target ``args[0]``."""
    self = args[0]
    name = func.overloadpacket
    if name in (_aten.index_put_, _aten._index_put_impl_):
        indices = args[1] if len(args) > 1 else kwargs["indices"]
        covered, shapes = 0, []
        for ix in indices:
            if ix is None:
                covered += 1  # a full slice
                continue
            if ix.dtype == torch.bool:
                shapes.append((int(ix.count_nonzero()),))
                covered += ix.dim()
            else:
                shapes.append(tuple(ix.shape))
                covered += 1
        full = _prod(s for i, s in enumerate(self.shape[:covered])
                     if indices[i] is None) if covered else 1
        n_idx = torch.broadcast_shapes(*shapes).numel() if shapes else 1
        return n_idx * full * _prod(self.shape[covered:])
    if name == _aten.masked_scatter_:
        return int(args[1].count_nonzero())
    if name in (_aten.index_add_, _aten.index_copy_, _aten.index_reduce_):
        return args[3].numel()
    if name == _aten.index_fill_:
        dim = args[1] % max(1, self.dim())
        return args[2].numel() * self.numel() // max(1, self.shape[dim])
    if name == _aten.put_:
        return args[1].numel()
    return args[2].numel()  # the scatter family: the index's elements


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten op reads and writes, by the module's rule."""
    if func.is_view or func in _FREE:
        return 0
    if func in _COPY:
        outs = out if isinstance(out, (list, tuple)) else (out,)
        devices = {t.device for v in list(args) + list(kwargs.values())
                   + list(outs) for t in _tensors(v)}
        if len(devices) > 1:
            return 0
    if func in _SCATTER:
        reads = sum(_nbytes(t) for v in list(args[1:]) + list(kwargs.values())
                    for t in _tensors(v))
        written = _scattered(func, args, kwargs) * args[0].element_size()
        accumulate = kwargs.get("accumulate", len(args) > 3 and args[3])
        if func in _ACCUMULATE or (
                func.overloadpacket in (_aten.index_put_,
                                        _aten._index_put_impl_)
                and accumulate is True):
            written *= 2
        return reads + written
    schema = func._schema
    read = written = 0
    any_write = False
    pure_write = func in _WRITE_ONLY
    for i, a in enumerate(schema.arguments):
        if i < len(args):
            v = args[i]
        elif a.name in kwargs:
            v = kwargs[a.name]
        else:
            continue
        ts = _tensors(v)
        if not ts:
            continue
        size = sum(_nbytes(t) for t in ts)
        if a.alias_info is not None and a.alias_info.is_write:
            any_write = True
            written += size
            if not (pure_write or a.kwarg_only):  # out= is written only
                read += size
        else:
            read += size
    fresh = 0
    aliased = 0
    outs = out if isinstance(out, (list, tuple)) else (out,)
    for r, v in zip(schema.returns, outs):
        ts = _tensors(v)
        if r.alias_info is not None:
            aliased += len(ts)
            continue
        fresh += sum(_nbytes(t) for t in ts)
    if not any_write and not fresh and aliased:
        return 0  # an alias of an input: metadata
    return read + written + fresh


def op_flops(func, args, kwargs, out) -> int:
    """Flops of one aten op, by the module's rule."""
    packet = func.overloadpacket
    if packet in flop_registry:
        return int(flop_registry[packet](*args, **kwargs, out_val=out))
    if packet in _REDUCE:
        src = args[0] if args else None
        if isinstance(src, torch.Tensor) and src.is_floating_point():
            return src.numel()
        return 0
    if torch.Tag.pointwise in func.tags and packet not in _NOT_ARITH:
        outs = out if isinstance(out, (list, tuple)) else (out,)
        return sum(t.numel() for t in outs
                   if isinstance(t, torch.Tensor) and t.is_floating_point())
    return 0


class _CountMode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _STATE.depth == 0:
            b = op_bytes(func, args, kwargs, out)
            f = op_flops(func, args, kwargs, out)
            for c in _STATE.counters:
                c.ops += 1
                c.bytes_accessed += b
                c.flops += f
        return out


@contextlib.contextmanager
def counting():
    """Count everything this thread does inside the block; yields the
    :class:`CostCounter`."""
    counter = CostCounter()
    _STATE.counters.append(counter)
    try:
        with _CountMode():
            yield counter
    finally:
        _STATE.counters.remove(counter)


def kernel_scope(name: str, cost: Callable[..., tuple]):
    """Decorate a kernel's public function (or its plain version): while
    something counts, the call adds ``cost(*args, **kwargs) -> (bytes,
    flops)`` (computed from the call's inputs after it ran) in place of
    every aten op it issues. A scope inside a scope adds nothing."""

    def deco(fn):
        @functools.wraps(fn)
        def scoped(*args, **kwargs):
            if not _STATE.counters:
                return fn(*args, **kwargs)
            _STATE.depth += 1
            try:
                out = fn(*args, **kwargs)
                if _STATE.depth == 1:
                    b, f = cost(*args, **kwargs)
                    for c in _STATE.counters:
                        k = c.kernels.setdefault(
                            name, {"calls": 0, "bytes": 0, "flops": 0})
                        k["calls"] += 1
                        k["bytes"] += int(b)
                        k["flops"] += int(f)
                        c.bytes_accessed += int(b)
                        c.flops += int(f)
            finally:
                _STATE.depth -= 1
            return out

        return scoped

    return deco


def count_collective(name: str, x: torch.Tensor) -> None:
    """A collective put ``x`` on the wire (called by
    ``parallel.collectives`` once a call, only where it issues one)."""
    for c in _STATE.counters:
        c.collective_bytes[name] = (c.collective_bytes.get(name, 0)
                                    + _nbytes(x))
        c.collective_count += 1


def in_range(targets: torch.Tensor, n: int) -> int:
    """How many of ``targets`` lie in ``[0, n)`` (a data-dependent kernel
    cost; one read off the device, made only while counting)."""
    return int(((targets >= 0) & (targets < n)).sum())
