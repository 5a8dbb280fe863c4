"""Tier-1 runtime profiler: dead stores / silent stores / silent loads in
one concrete run of a PyTorch program (paper §4-§5, adapted per
DESIGN.md §2).

``fn(*args)`` runs once under a ``TorchDispatchMode`` recorder, the
counterpart of the reference's concrete jaxpr interpretation: every aten
operation that reaches the dispatcher becomes one record, with

  * a LOAD for each tensor input (not for an ``out=`` argument, nor for
    the destination of an in-place overwrite: ``copy_``, ``fill_``,
    ``zero_``, ``index_put_`` without accumulation);
  * a STORE for each output, and a STORE at the argument's own address
    for each argument the schema marks as written in place (``add_``,
    ``index_put_``, ``copy_``, ``out=``);
  * no event for a view (outputs that alias an input: ``select``,
    ``view``, ``unbind``, ``expand``, ``slice``, ``transpose``, and ops
    whose outputs share an input's storage without the schema saying so,
    such as ``_unsafe_view``), and no STORE for ``empty*``.

The kernel entry points of ``kernels/ops.py`` launch through ctypes or
Triton, which the dispatcher never sees; under a recording each records
itself as ONE operation (``recorded``): a LOAD per tensor input, a STORE
per output and per pool written in place, the recording paused inside —
as the reference treats a ``pallas_call`` as one equation. Contexts are
the user frames at dispatch (``context.context_of_op``).

Buffers are storages. After the run, a second pass places each storage
in a modeled flat address space (the reference's size-class-recycling
``Allocator``): a storage's base is freed after the last recorded use of
any tensor on it, except for ``fn``'s arguments and outputs, so
addresses recycle as the mutable heap JXPerf watches does. An event's
address is its storage's base plus the tensor's storage offset. Addresses
are assigned after the run because nothing dies while recording: the
trace holds every value.

Values stay where they are, by reference (device tensors on the card);
the engine reads only the sampled elements. An in-place write would
change what earlier events recorded, so before a write every earlier
event whose extent overlaps the written one is given a copy of its value
(``stats["snapshot_bytes"]``).

Multi-epoch profiling is trace→replay: epoch 0 records an EventTrace and
runs it through the EventEngine; epochs 2..N replay that trace through a
fresh-epoch engine without running an operation (replay=False runs ``fn``
again under the recorder each epoch instead).
"""
from __future__ import annotations

import functools
import inspect
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes,
                                          _get_current_dispatch_mode)

from repro_torch.configs.base import ProfilerConfig
from repro_torch.core.context import context_of_op
from repro_torch.core.events import (LOAD, STORE, EventEngine, EventTrace,
                                     MemEvent)
from repro_torch.core.findings import WasteProfile

# the unified profile IS the tier-1 report (seed `Report` name kept)
Report = WasteProfile

# factories whose output holds no defined value: no STORE
_EMPTY = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                    "new_empty_strided"})
# in-place ops that write their destination without reading it
_OVERWRITES = frozenset({"copy_", "fill_", "zero_", "index_put_",
                         "_index_put_impl_"})


# ----------------------------------------------------------------------
class Allocator:
    """Flat address space with size-class recycling (heap analogue)."""

    def __init__(self):
        self.next = 0
        self.free_lists: Dict[int, List[int]] = {}

    def alloc(self, nelems: int) -> int:
        fl = self.free_lists.get(nelems)
        if fl:
            return fl.pop()
        addr = self.next
        self.next += max(nelems, 1)
        return addr

    def free(self, addr: int, nelems: int) -> None:
        self.free_lists.setdefault(nelems, []).append(addr)


@dataclass(frozen=True)
class _Schema:
    name: str
    view: bool                           # an output aliases an input
    writes: Tuple[Tuple[int, str, bool], ...]  # (position, name, kwarg-only)


_SCHEMAS: Dict[Any, _Schema] = {}


def _schema_of(func) -> _Schema:
    sch = _SCHEMAS.get(func)
    if sch is None:
        s = func._schema
        sch = _Schema(
            name=func.overloadpacket.__name__,
            view=any(r.alias_info is not None and not r.alias_info.is_write
                     for r in s.returns),
            writes=tuple((i, a.name, a.kwarg_only)
                         for i, a in enumerate(s.arguments)
                         if a.alias_info is not None
                         and a.alias_info.is_write))
        _SCHEMAS[func] = sch
    return sch


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _key(t: torch.Tensor):
    return (t.device, t.untyped_storage().data_ptr())


def _extent(t: torch.Tensor) -> Tuple[int, int]:
    """First and last storage element a tensor can touch."""
    lo = t.storage_offset()
    return lo, lo + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))


# ----------------------------------------------------------------------
class Recorder(TorchDispatchMode):
    """Records the operations of one concrete run (see the module doc).
    ``trace(protected)`` then assigns addresses and returns the
    EventTrace."""

    def __init__(self):
        super().__init__()
        self.ops = 0                  # recorded operations (op index)
        self.kernel_ops = 0           # of which kernel entry points
        self.views = 0                # view operations seen (no events)
        self.snapshot_bytes = 0
        # (op index, event, storage key, storage offset) in stream order
        self.records: List[Tuple[int, MemEvent, Any, int]] = []
        self.sizes: Dict[Any, int] = {}       # storage key -> elements
        self.last_use: Dict[Any, int] = {}
        # one tensor per storage: no storage is freed (and its data
        # pointer reused) while the recording runs
        self.keep: Dict[Any, torch.Tensor] = {}
        # storage key -> [(event, lo, hi)] whose values alias the storage
        self.live: Dict[Any, List[Tuple[MemEvent, int, int]]] = {}

    # ------------------------------------------------------------------
    def _event(self, kind: str, t: torch.Tensor, ctx) -> None:
        n = t.numel()
        if n == 0:
            return
        key = _key(t)
        if key not in self.sizes:
            self.sizes[key] = max(
                t.untyped_storage().nbytes() // t.element_size(), 1)
            self.keep[key] = t
        ev = MemEvent(kind=kind, address=-1, nelems=n,
                      itemsize=t.element_size(), values=t, ctx=ctx)
        self.records.append((self.ops, ev, key, t.storage_offset()))
        self.last_use[key] = self.ops
        lo, hi = _extent(t)
        self.live.setdefault(key, []).append((ev, lo, hi))

    def _before_write(self, t: torch.Tensor) -> None:
        """Give every earlier event that can read the elements about to be
        written a copy of its value (the value at its event)."""
        if t.numel() == 0:
            return
        key = _key(t)
        lo, hi = _extent(t)
        kept, copies = [], {}
        for ev, elo, ehi in self.live.get(key, ()):
            if elo <= hi and lo <= ehi:
                src = ev.values
                if id(src) not in copies:
                    copies[id(src)] = src.clone()
                    self.snapshot_bytes += src.numel() * src.element_size()
                ev.values = copies[id(src)]
            else:
                kept.append((ev, elo, ehi))
        self.live[key] = kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        sch = _schema_of(func)
        if sch.view:
            self.views += 1
            return func(*args, **kwargs)
        inputs = _tensors((args, kwargs))
        written = []
        if not sch.writes:
            # an op that writes nothing runs first: one whose outputs all
            # share an input's storage is a view its schema does not mark
            # (``_unsafe_view``, ``_reshape_alias``)
            out = func(*args, **kwargs)
            outs = _tensors(out)
            in_keys = {_key(t) for t in inputs}
            if outs and all(_key(t) in in_keys for t in outs):
                self.views += 1
                return out
            ctx = context_of_op(sch.name)
            for t in inputs:
                self._event(LOAD, t, ctx)
        else:
            ctx = context_of_op(sch.name)
            accumulate = (sch.name in ("index_put_", "_index_put_impl_")
                          and (args[3] if len(args) > 3
                               else kwargs.get("accumulate", False)))
            overwrite = sch.name in _OVERWRITES and not accumulate
            unread = set()
            for pos, name, kw_only in sch.writes:
                ts = _tensors(args[pos] if pos < len(args)
                              else kwargs.get(name))
                written += ts
                if kw_only or overwrite:
                    unread.update(id(t) for t in ts)
            for t in inputs:
                if id(t) not in unread:
                    self._event(LOAD, t, ctx)
            for t in written:
                self._before_write(t)
            out = func(*args, **kwargs)
            outs = _tensors(out)
            in_keys = {_key(t) for t in inputs}
        if sch.name not in _EMPTY:
            for t in outs:
                if _key(t) not in in_keys:
                    self._event(STORE, t, ctx)
        for t in written:
            self._event(STORE, t, ctx)
        self.ops += 1
        return out

    def kernel_op(self, name: str, fn: Callable, args, kwargs, written):
        """One kernel entry point as one operation: a LOAD per tensor
        input, the call with the recording paused, a STORE per output
        that is not an input and per tensor written in place."""
        ctx = context_of_op(f"ops.{name}")
        inputs = _tensors((args, kwargs))
        for t in inputs:
            self._event(LOAD, t, ctx)
        for t in written:
            self._before_write(t)
        with _disable_current_modes():
            out = fn(*args, **kwargs)
        in_keys = {_key(t) for t in inputs}
        for t in _tensors(out):
            if _key(t) not in in_keys:
                self._event(STORE, t, ctx)
        for t in written:
            self._event(STORE, t, ctx)
        self.ops += 1
        self.kernel_ops += 1
        return out

    # ------------------------------------------------------------------
    def trace(self, protected) -> EventTrace:
        """Assign addresses (the second pass) and return the stream. A
        storage's base is allocated at its first event and freed after
        its last use, unless its key is in `protected`."""
        frees: Dict[int, List[Any]] = {}
        for key, op in self.last_use.items():
            if key not in protected:
                frees.setdefault(op, []).append(key)
        alloc, base = Allocator(), {}
        trace = EventTrace()
        done = 0                       # ops whose dead storages are freed
        for op, ev, key, off in self.records:
            while done < op:
                for k in frees.get(done, ()):
                    alloc.free(base[k], self.sizes[k])
                done += 1
            if key not in base:
                base[key] = alloc.alloc(self.sizes[key])
            ev.address = base[key] + off
            trace.append(ev)
        self.keep.clear()
        self.live.clear()
        return trace


def active_recorder() -> Optional[Recorder]:
    mode = _get_current_dispatch_mode()
    return mode if isinstance(mode, Recorder) else None


def recorded(name: str, writes: Optional[Callable[[Dict], Tuple]] = None):
    """Decorate a kernel entry point so that under a recording it records
    as one operation ``ops.<name>``; `writes` maps its bound arguments to
    the tensors it writes in place. Outside a recording the entry point
    runs as it is."""
    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def entry(*args, **kwargs):
            rec = active_recorder()
            if rec is None:
                return fn(*args, **kwargs)
            written = ()
            if writes is not None:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                written = _tensors(writes(bound.arguments))
            return rec.kernel_op(name, fn, args, kwargs, written)
        return entry
    return deco


# ----------------------------------------------------------------------
class JxInterpreter:
    """Profile fn(*args) and produce a :class:`WasteProfile`. After
    ``profile``, ``trace`` holds the recorded stream and ``stats`` the
    recording's counts and times."""

    def __init__(self, cfg: Optional[ProfilerConfig] = None):
        self.cfg = cfg or ProfilerConfig(enabled=True)
        self.engine = EventEngine(self.cfg, tier=1)
        self.trace: Optional[EventTrace] = None
        self.stats: Dict[str, Any] = {}

    def record(self, fn, *args) -> EventTrace:
        """Run fn(*args) once under a recorder; return its EventTrace."""
        rec = Recorder()
        t0 = time.perf_counter()
        with rec:
            out = fn(*args)
        protected = {_key(t) for t in _tensors((args, out))}
        trace = rec.trace(protected)
        self.stats.update(
            ops=rec.ops, kernel_ops=rec.kernel_ops, views=rec.views,
            events=len(trace), element_events=trace.element_events,
            snapshot_bytes=rec.snapshot_bytes,
            record_s=time.perf_counter() - t0)
        return trace

    def profile(self, fn, *args, epochs: int = 1,
                replay: bool = True) -> WasteProfile:
        """Profile `epochs` identical executions of fn(*args).

        replay=True (default): run once under the recorder, then replay
        the recorded EventTrace for the remaining epochs. replay=False
        runs fn again under the recorder every epoch: both give identical
        profiles at a fixed seed when fn is deterministic and leaves its
        inputs as it found them. A fn that mutates its own arguments (or
        the tensors it closes over) in a way that changes its next run is
        then not the same program each epoch; replay profiles the first
        run N times.

        Memory trade: the trace holds every value of the run by reference
        (on the device where the run happened) until profiling ends, so
        peak memory is the run's total footprint rather than its live
        set.
        """
        self.stats = {"epoch_s": []}
        for epoch in range(epochs):
            self.engine.reset_epoch()          # GC-epoch semantics
            if epoch == 0 or not replay:
                self.trace = self.record(fn, *args)
            t0 = time.perf_counter()
            self.engine.replay(self.trace)
            self.stats["epoch_s"].append(time.perf_counter() - t0)
        return self.engine.finalize()


def profile_fn(fn, *args, cfg: Optional[ProfilerConfig] = None,
               epochs: int = 1, replay: bool = True) -> WasteProfile:
    """Profile fn(*args) with tier 1 (trace→replay epochs)."""
    return JxInterpreter(cfg).profile(fn, *args, epochs=epochs,
                                      replay=replay)
