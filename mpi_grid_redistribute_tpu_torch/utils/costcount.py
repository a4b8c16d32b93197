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
  reference's primitive name, with the mesh axes the call is declared
  over; a mesh without a process group issues none and reports nothing.

A counting block may also **record** (``counting(record=True)``): the
counter then keeps, in order, one :class:`Event` an aten op (outside
kernel scopes) with its output shapes, one a kernel scope, one a
collective with its bytes and axes, and one at each entry to and exit
from a :func:`region` (``telemetry.phases.traced_span`` opens one), and
the high-water mark of the bytes the recorded ops allocated that are
still live (``peak_live_bytes``, :meth:`CostCounter.peak`): each fresh
output's storage is live from the op that makes it to the last recorded
op that reads it (a view reads its base), or to the end for what the
program returns. That is a liveness model over the record, like the
reference's over a jaxpr, not the allocator's view: when a tensor really
dies depends on who else holds it (a process group's work object frees
its tensors on its own thread), and the model does not. Views, aliases
of an input and copies between the host and the device allocate
nothing, and a kernel scope allocates its fresh outputs, not its
intermediates, so the card and the CPU read alike. A recording block
holds every fresh output until it ends (the memory of a recorded run is
the sum of its allocations). Recording changes none of the counts, and
``as_dict`` is the same with or without it (the analyzers of
``analysis/`` read the record).

Counting is per thread: only the thread inside :func:`counting` counts,
and a kernel scope costs two attribute reads when nothing counts or
watches (:func:`watching_kernels`).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

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


class Event(NamedTuple):
    """One recorded event. ``kind`` is ``"op"`` (``name`` the aten op,
    ``shapes`` its tensor outputs' shapes), ``"kernel"`` (a kernel scope:
    ``name`` the kernel, ``shapes`` its outputs'), ``"coll"`` (``name``
    the primitive, ``nbytes`` its payload, ``axes`` the mesh axes it is
    declared over, ``world`` whether it spans the whole mesh), ``"enter"``
    or ``"exit"`` (a :func:`region` named ``name``)."""

    kind: str
    name: str
    shapes: Tuple[Tuple[int, ...], ...] = ()
    nbytes: int = 0
    axes: Tuple[str, ...] = ()
    world: bool = True


class CostCounter:
    """What one :func:`counting` block saw (``events`` and :meth:`peak`
    only when it records)."""

    def __init__(self, record: bool = False):
        self.bytes_accessed = 0
        self.flops = 0
        self.ops = 0
        self.collective_bytes: Dict[str, int] = {}
        self.collective_count = 0
        self.kernels: Dict[str, dict] = {}
        self.record = record
        self.events: List[Event] = []
        # the liveness model: storage pointer -> index into _spans, each
        # span [first op, last op reading it, bytes]
        self._clock = 0
        self._storages: Dict[int, int] = {}
        self._spans: List[list] = []
        # every fresh output is held until the block ends, so no storage
        # is freed and its pointer reused: a pointer names one storage
        self._held: list = []

    def collective_sequence(self) -> List[Tuple[str, int]]:
        """The recorded collectives in order, ``(name, bytes)`` each."""
        return [(e.name, e.nbytes) for e in self.events if e.kind == "coll"]

    def _use(self, tensors, fresh) -> None:
        """One recorded op read ``tensors`` and made ``fresh``."""
        self._clock += 1
        for t in tensors:
            if t.numel():
                i = self._storages.get(t.untyped_storage().data_ptr())
                if i is not None:
                    self._spans[i][1] = self._clock
        for t in fresh:
            n = _nbytes(t)
            if n:
                self._storages[t.untyped_storage().data_ptr()] = len(
                    self._spans)
                self._spans.append([self._clock, self._clock, n])
                self._held.append(t)

    def peak(self, outputs=()) -> int:
        """The most bytes live at once under the liveness model, the
        storages of ``outputs`` (what the program returned) live to the
        end."""
        end = self._clock + 1
        for t in _leaves(outputs):
            if t.numel():
                i = self._storages.get(t.untyped_storage().data_ptr())
                if i is not None:
                    self._spans[i][1] = end
        delta = [0] * (end + 2)
        for first, last, n in self._spans:
            delta[first] += n
            delta[last + 1] -= n
        peak = live = 0
        for d in delta:
            live += d
            peak = max(peak, live)
        return peak

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
        self.watch = 0  # watching_kernels() blocks open


_STATE = _State()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _leaves(v) -> list:
    """Every tensor in a (nested) tuple or list."""
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        return [t for x in v for t in _leaves(x)]
    return []


def _recorders() -> List[CostCounter]:
    return [c for c in _STATE.counters if c.record]


def _shapes(outs) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(int(d) for d in t.shape) for t in outs)


def _fresh(func, args, kwargs, out) -> list:
    """The tensors an op returns that hold memory of their own: not a
    view or a declared alias of an input, not sharing an input's
    storage, not a copy onto another device."""
    if func.is_view:
        return []
    outs = out if isinstance(out, (list, tuple)) else (out,)
    returns = func._schema.returns
    ins = [t for v in list(args) + list(kwargs.values()) for t in _tensors(v)]
    in_ptrs = {t.untyped_storage().data_ptr() for t in ins if t.numel()}
    in_devices = {t.device for t in ins}
    fresh = []
    for i, v in enumerate(outs):
        if i < len(returns) and returns[i].alias_info is not None:
            continue
        for t in _tensors(v):
            if not t.numel() or t.untyped_storage().data_ptr() in in_ptrs:
                continue
            if func in _COPY and in_devices and t.device not in in_devices:
                continue
            fresh.append(t)
    return fresh


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
        # a span's profiler range (the profiler:: ops) is bookkeeping, so
        # a count does not depend on whether a span opened one
        if _STATE.depth == 0 and func.namespace != "profiler":
            b = op_bytes(func, args, kwargs, out)
            f = op_flops(func, args, kwargs, out)
            for c in _STATE.counters:
                c.ops += 1
                c.bytes_accessed += b
                c.flops += f
            recorders = _recorders()
            if recorders:
                outs = out if isinstance(out, (list, tuple)) else (out,)
                ev = Event("op", func._schema.name,
                           _shapes(t for v in outs for t in _tensors(v)))
                fresh = _fresh(func, args, kwargs, out)
                ins = _leaves(list(args) + list(kwargs.values()))
                for c in recorders:
                    c.events.append(ev)
                    c._use(ins, fresh)
        return out


@contextlib.contextmanager
def counting(record: bool = False):
    """Count everything this thread does inside the block; yields the
    :class:`CostCounter` (which also records when ``record``)."""
    counter = CostCounter(record)
    _STATE.counters.append(counter)
    try:
        with _CountMode():
            yield counter
    finally:
        _STATE.counters.remove(counter)
        counter._held = []


def kernel_scope(name: str, cost: Callable[..., tuple]):
    """Decorate a kernel's public function (or its plain version): while
    something counts, the call adds ``cost(*args, **kwargs) -> (bytes,
    flops)`` (computed from the call's inputs after it ran) in place of
    every aten op it issues. A scope inside a scope adds nothing."""

    def deco(fn):
        @functools.wraps(fn)
        def scoped(*args, **kwargs):
            if not _STATE.counters and not _STATE.watch:
                return fn(*args, **kwargs)
            _STATE.depth += 1
            try:
                out = fn(*args, **kwargs)
                if _STATE.depth == 1 and _STATE.counters:
                    b, f = cost(*args, **kwargs)
                    # the formula's host ints, read only while counting
                    b, f = int(b), int(f)  # gridlint: disable=G002
                    for c in _STATE.counters:
                        k = c.kernels.setdefault(
                            name, {"calls": 0, "bytes": 0, "flops": 0})
                        k["calls"] += 1
                        k["bytes"] += b
                        k["flops"] += f
                        c.bytes_accessed += b
                        c.flops += f
                    recorders = _recorders()
                    if recorders:
                        outs = _leaves(out)
                        ins = [t for v in list(args) + list(kwargs.values())
                               for t in _tensors(v)]
                        ptrs = {t.untyped_storage().data_ptr() for t in ins
                                if t.numel()}
                        fresh = [t for t in outs if t.numel() and
                                 t.untyped_storage().data_ptr() not in ptrs]
                        for c in recorders:
                            c.events.append(Event("kernel", name,
                                                  _shapes(outs)))
                            c._use(ins, fresh)
            finally:
                _STATE.depth -= 1
            return out

        return scoped

    return deco


@contextlib.contextmanager
def watching_kernels():
    """Track kernel scopes on this thread inside the block without
    counting anything (:func:`in_kernel_scope` reads it)."""
    _STATE.watch += 1
    try:
        yield
    finally:
        _STATE.watch -= 1


def in_kernel_scope() -> bool:
    """Is this thread inside a kernel's scope (its wrapper, or its plain
    version standing in for it)? Known only while something counts or
    watches."""
    return _STATE.depth > 0


def count_collective(name: str, x: torch.Tensor,
                     axes: Tuple[str, ...] = (), world: bool = True) -> None:
    """A collective put ``x`` on the wire (called by
    ``parallel.collectives`` once a call, only where it issues one).
    ``axes`` are the mesh axes it is declared over and ``world`` whether
    it spans the whole mesh (a sub-axis call is not)."""
    n = _nbytes(x)
    for c in _STATE.counters:
        c.collective_bytes[name] = c.collective_bytes.get(name, 0) + n
        c.collective_count += 1
        if c.record:
            c.events.append(Event("coll", name, (), n, tuple(axes),
                                  bool(world)))


class _Region:
    def __init__(self, name: str, recorders):
        self.name = name
        self.recorders = recorders

    def __enter__(self):
        for c in self.recorders:
            c.events.append(Event("enter", self.name))
        return self

    def __exit__(self, *exc):
        for c in self.recorders:
            c.events.append(Event("exit", self.name))
        return False


def region(name: str) -> Optional[_Region]:
    """A named region of the record (``with region("mig:fast"): ...``),
    or ``None`` when nothing records on this thread (the caller then
    opens nothing)."""
    recorders = _recorders()
    return _Region(name, recorders) if recorders else None


def in_range(targets: torch.Tensor, n: int) -> int:
    """How many of ``targets`` lie in ``[0, n)`` (a data-dependent kernel
    cost; one read off the device, made only while counting)."""
    return int(((targets >= 0) & (targets < n)).sum())
