"""Tier 0: static waste lint over an abstract trace of a step (DESIGN.md
§ Static tier), held against src/repro/core/jaxpr_lint.py.

The earliest point where the paper's waste classes are visible: the
graph of a train step, engine tick or prefill traced on fake tensors
(``core/graph_trace.py:trace_program``) before anything runs. Every node
still carries the user frames that issued it, so findings point at the
Python ``file:line`` that wrote the waste — the static analogue of
JXPerf's ⟨C1,C2⟩ calling contexts.

Rules, each mapped to a paper definition, in PyTorch's idiom:

  dead_store      (Def. 1)  an in-place store into a region of a buffer
                            (``copy_`` into a view, ``index_put_``,
                            ``index_copy_``, ``scatter_``) whose region the
                            next store overwrites before any read, or
                            whose buffer is never read again (and is
                            neither an argument nor returned);
  silent_store    (Def. 2)  a store of a value provably equal to what is
                            resident: a region loaded from the same
                            buffer at the same indices written back, and
                            x+0 / x-0 / x*1 / x/1 identity chains (the
                            stored value IS the operand);
  redundant_load  (Def. 3)  the same unmutated buffer read into a new
                            buffer at identical indices more than once
                            (``index``, ``index_select``, ``gather``,
                            ``embedding``, ``take``, a materialised slice:
                            ``clone`` of a view), including a
                            loop-invariant load that a Python loop
                            re-executes every trip;
  dead_param      (Def. 1 at allocation granularity)  placeholders that
                            reach no output and no store into an
                            argument — a buffer marshalled in and never
                            read.

A view reads nothing (tier 1 records nothing for a view either). Index
chains are compared by hash-consed value numbers: a node's number is
that of its operation over its operands' numbers, a store gives its
buffer's views new numbers, and ``detach``/``alias`` and a ``clone`` of a
whole tensor keep their operand's number — so numbers flow through
``torch.utils.checkpoint`` and ``autograd.Function`` boundaries. Python
loops are unrolled in the trace, so a load repeated by a loop is counted
once per extra trip, the reference's trip-count weighting.

Findings land in the unified ``WasteProfile`` as ``TIER_STATIC = 0``,
mergeable with tiers 1-5 and exportable as SARIF (``core/sarif.py``).
"""
from __future__ import annotations

import operator
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.fx as fx

from repro_torch.core.context import context_of_node
from repro_torch.core.findings import TIER_STATIC, Finding, WasteProfile
from repro_torch.core.graph_trace import Traced, trace_program

aten = torch.ops.aten

# value-transparent aliases: the result IS the operand
_SAME_VALUE = frozenset({aten.detach.default, aten.alias.default,
                         aten.lift_fresh.default})
# ops whose outputs alias an input though their schema does not say so
_UNMARKED_VIEWS = frozenset({aten._unsafe_view.default})
# loads: read a region of a buffer into a new buffer -> region key maker
_LOADS = {
    aten.index.Tensor: lambda a: ("index", a[1]),
    aten.index_select.default: lambda a: ("index_dim", a[1], a[2]),
    aten.gather.default: lambda a: ("gather", a[1], a[2]),
    aten.embedding.default: lambda a: ("index", (a[1],)),
    aten.take.default: lambda a: ("take", a[1]),
}
# overwrite stores: (update argument position, region key maker)
_STORES = {
    aten.copy_.default: (1, lambda a: None),
    aten.index_put_.default: (2, lambda a: ("index", a[1])),
    aten._index_put_impl_.default: (2, lambda a: ("index", a[1])),
    aten.index_copy_.default: (3, lambda a: ("index_dim", a[1], a[2])),
    aten.scatter_.src: (3, lambda a: ("gather", a[1], a[2])),
}
# identity element of x (op) c
_IDENTITY = {"add": 0.0, "sub": 0.0, "mul": 1.0, "div": 1.0}
# factories of a filled constant -> the fill value's argument
_CONST_FACTORIES = {
    aten.zeros.default: lambda a: 0, aten.zeros_like.default: lambda a: 0,
    aten.new_zeros.default: lambda a: 0, aten.ones.default: lambda a: 1,
    aten.ones_like.default: lambda a: 1, aten.new_ones.default: lambda a: 1,
    aten.full.default: lambda a: a[1], aten.full_like.default: lambda a: a[1],
    aten.new_full.default: lambda a: a[2],
    aten.scalar_tensor.default: lambda a: a[0],
}
# ops that carry a constant through
_CONST_CARRY = frozenset({"expand", "_to_copy", "clone", "view", "reshape",
                          "_unsafe_view", "unsqueeze", "squeeze"})


def nbytes(val) -> float:
    """Bytes of a node's value (a tensor, or a tuple/list of them)."""
    if isinstance(val, torch.Tensor):
        return float(val.numel() * val.element_size())
    if isinstance(val, (tuple, list)):
        return float(sum(nbytes(v) for v in val))
    return 0.0


def _shape(node) -> Tuple[int, ...]:
    val = node.meta.get("val") if isinstance(node, fx.Node) else None
    return tuple(val.shape) if isinstance(val, torch.Tensor) else ()


class _Schema:
    __slots__ = ("view", "writes")

    def __init__(self, target):
        s = target._schema
        self.view = (target in _UNMARKED_VIEWS or any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in s.returns))
        self.writes = tuple(i for i, a in enumerate(s.arguments)
                            if a.alias_info is not None
                            and a.alias_info.is_write)


_SCHEMAS: Dict[Any, _Schema] = {}


def schema(target) -> Optional[_Schema]:
    if not isinstance(target, torch._ops.OpOverload):
        return None
    sch = _SCHEMAS.get(target)
    if sch is None:
        sch = _SCHEMAS[target] = _Schema(target)
    return sch


class Numbering:
    """Hash-consed value numbers of a traced graph's nodes, in program
    order. Every node has a storage ``root`` (a view's is its operand's,
    an in-place op's is its destination's); a write bumps its root's
    version, and a node read after its root changed gets a new number."""

    def __init__(self):
        self.table: Dict[Tuple, int] = {}
        self.vn: Dict[fx.Node, int] = {}
        self.root: Dict[fx.Node, fx.Node] = {}
        self.cver: Dict[fx.Node, int] = {}
        self.ver: Dict[fx.Node, int] = {}
        self.const: Dict[int, Any] = {}
        self.region: Dict[fx.Node, Tuple] = {}

    def fresh(self) -> int:
        return self.of_key(("fresh", len(self.table)))

    def of_key(self, key: Tuple) -> int:
        vn = self.table.get(key)
        if vn is None:
            vn = self.table[key] = len(self.table) + 1
        return vn

    def cur(self, node: fx.Node) -> int:
        """The number of ``node``'s value now."""
        root = self.root[node]
        ver = self.ver.get(root, 0)
        if ver == self.cver[node]:
            return self.vn[node]
        return self.of_key(("ver", self.vn[node], ver))

    def key(self, a) -> Any:
        """Hashable key of an argument: a node's current number, a
        literal's value."""
        if isinstance(a, fx.Node):
            return ("n", self.cur(a))
        if isinstance(a, (list, tuple)):
            return tuple(self.key(x) for x in a)
        if isinstance(a, (torch.dtype, torch.device, torch.memory_format,
                          torch.layout)):
            return str(a)
        return ("l", type(a).__name__, repr(a))

    def const_of(self, a) -> Optional[Any]:
        if isinstance(a, fx.Node):
            return self.const.get(self.cur(a))
        if isinstance(a, (bool, int, float)):
            return a
        return None

    def _set(self, node, vn, root):
        self.vn[node] = vn
        self.root[node] = root
        self.cver[node] = self.ver.get(root, 0)

    def number(self, node: fx.Node) -> None:
        """Number ``node`` (its operands already numbered)."""
        if node.op in ("placeholder", "get_attr"):
            self._set(node, self.fresh(), node)
            val = node.meta.get("val")
            if node.op == "get_attr" and val is None:
                val = getattr(node.graph.owning_module, node.target, None)
            if (node.op == "get_attr" and isinstance(val, torch.Tensor)
                    and val.numel() == 1 and not val.is_meta):
                try:
                    self.const[self.vn[node]] = val.item()
                except Exception:     # a fake constant has no value
                    pass
            return
        if node.op != "call_function":
            return
        target = node.target
        if target is operator.getitem:
            src = node.args[0]
            sch = schema(src.target)
            root = self.root[src] if sch is not None and sch.view else node
            self._set(node, self.of_key(("getitem", self.cur(src),
                                         node.args[1])), root)
            self.region[node] = self.region.get(src, ())
            return
        sch = schema(target)
        if sch is None:
            self._set(node, self.fresh(), node)
            return
        args = node.args
        if sch.writes:
            dest = args[sch.writes[0]] if sch.writes[0] < len(args) else None
            if isinstance(dest, fx.Node):
                root = self.root[dest]
                self.ver[root] = self.ver.get(root, 0) + 1
                self._set(node, self.cur(dest), root)
                self.region[node] = self.region.get(dest, ())
                return
            self._set(node, self.fresh(), node)
            return
        if target in _SAME_VALUE and isinstance(args[0], fx.Node):
            self._set(node, self.cur(args[0]), self.root[args[0]])
            self.region[node] = self.region.get(args[0], ())
            return
        key = (str(target), self.key(args),
               tuple(sorted((k, self.key(v)) for k, v in node.kwargs.items())))
        name = target.overloadpacket.__name__
        if sch.view:
            src = next(a for a in args if isinstance(a, fx.Node))
            self._set(node, self.of_key(key), self.root[src])
            self.region[node] = self.region.get(src, ()) + (
                (name,) + tuple(self.key(a) for a in args[1:]),)
        elif (name == "clone" and isinstance(args[0], fx.Node)
                and self.root[args[0]] is args[0]):
            # a clone of a whole buffer: the same value in a new buffer
            self._set(node, self.cur(args[0]), node)
        else:
            self._set(node, self.of_key(key), node)
        vn = self.vn[node]
        fill = _CONST_FACTORIES.get(target)
        if fill is not None:
            c = fill(args)
            if isinstance(c, (bool, int, float)):
                self.const.setdefault(vn, c)
        elif name in _CONST_CARRY and args and isinstance(args[0], fx.Node):
            c = self.const.get(self.cur(args[0]))
            if c is not None:
                self.const.setdefault(vn, c)


class _LoadRec:
    __slots__ = ("node", "vn", "nbytes")

    def __init__(self, node, vn, nbytes):
        self.node, self.vn, self.nbytes = node, vn, nbytes


class _StoreRec:
    __slots__ = ("node", "root", "region", "shape", "nbytes", "read",
                 "dead", "silent")

    def __init__(self, node, root, region, shape, nbytes):
        self.node, self.root, self.region = node, root, region
        self.shape, self.nbytes = shape, nbytes
        self.read = self.dead = self.silent = False


class GraphLinter:
    """Walk a traced graph and emit a tier-0 :class:`WasteProfile`."""

    def __init__(self, subject: str = "fn"):
        self.subject = subject
        self.profile = WasteProfile(tier=TIER_STATIC)
        self.profile.meta["subject"] = subject
        self.num = Numbering()
        # number of a load result -> (source buffer's number, region, shape)
        self._load_src: Dict[int, Tuple[int, Tuple, Tuple[int, ...]]] = {}

    # -- findings -------------------------------------------------------
    def _flag(self, kind: str, node, *, bytes=0.0, count=1, c2_node=None,
              fraction=0.0, **meta) -> None:
        src = node.meta.get("source")
        if src is not None:
            meta.setdefault("file", src[0])
            meta.setdefault("line", src[1])
        meta.setdefault("subject", self.subject)
        self.profile.add(Finding(
            kind=kind, tier=TIER_STATIC, c1=context_of_node(node),
            c2=context_of_node(c2_node) if c2_node is not None else (),
            count=count, bytes=float(bytes), fraction=fraction, meta=meta))

    def _flag_dead_param(self, label: str, node) -> None:
        val = node.meta.get("val")
        self.profile.add(Finding(
            kind="dead_param", tier=TIER_STATIC,
            c1=(f"{self.subject}:{label}",), c2=("top-level graph",),
            bytes=nbytes(val),
            meta={"path": f"{self.subject}:{label}", "subject": self.subject,
                  "shape": str(tuple(getattr(val, "shape", ()))),
                  "rule": "placeholder reaches no output"}))

    # -- entry ----------------------------------------------------------
    def lint(self, traced: Traced,
             arg_labels: Optional[Sequence[str]] = None) -> WasteProfile:
        graph = traced.graph
        num = self.num
        loads: List[_LoadRec] = []
        stores: List[_StoreRec] = []
        unread: Dict[fx.Node, List[_StoreRec]] = {}   # root -> stores
        pending: Dict[fx.Node, Dict[Tuple, _StoreRec]] = {}
        writers: Dict[fx.Node, List[fx.Node]] = {}
        escaping = set()

        def read(a):
            root = num.root.get(a)
            if root is None:
                return
            for rec in unread.pop(root, ()):
                rec.read = True
            pending.pop(root, None)

        for node in graph.nodes:
            if node.op == "output":
                for a in node.all_input_nodes:
                    read(a)
                    escaping.add(num.root[a])
                continue
            if node.op == "placeholder":
                num.number(node)
                escaping.add(node)
                continue
            target = node.target
            sch = schema(target)
            store = _STORES.get(target)
            if store is not None and target in (
                    aten.index_put_.default, aten._index_put_impl_.default):
                acc = (node.args[3] if len(node.args) > 3
                       else node.kwargs.get("accumulate", False))
                if acc:
                    store = None
            # operand reads (a view reads nothing; a store's destination
            # is written, not read)
            if not (sch is not None and (sch.view or target in _SAME_VALUE)) \
                    and target is not operator.getitem:
                skip = node.args[0] if store is not None else None
                for a in node.all_input_nodes:
                    if a is not skip:
                        read(a)
            pre = None
            if store is not None:
                dest, upd = node.args[0], node.args[store[0]]
                pre = (num.root[dest], num.cur(num.root[dest]),
                       num.region.get(dest, ()),
                       num.cur(upd) if isinstance(upd, fx.Node) else None)
            num.number(node)
            if sch is not None and sch.writes:
                writers.setdefault(num.root[node], []).append(node)
            if node.op != "call_function":
                continue
            if store is not None:
                self._store(node, store, pre, stores, unread, pending)
            elif target in _LOADS or (
                    sch is not None and target.overloadpacket.__name__
                    == "clone" and num.root[node.args[0]] is not node.args[0]):
                self._load(node, loads)
            elif sch is not None:
                self._identity(node)

        # ---- unread store results -> dead stores -----------------------
        for rec in stores:
            if rec.dead or rec.read or rec.root in escaping:
                continue
            rec.dead = True
            self._flag("dead_store", rec.node, bytes=rec.nbytes,
                       rule="store result never read")
        for rec in stores:
            self.profile.observe("dead_store", rec.dead)
            self.profile.observe("silent_store", rec.silent)

        # ---- duplicate / loop-invariant loads -------------------------
        by_vn: Dict[int, List[_LoadRec]] = {}
        for rec in loads:
            by_vn.setdefault(rec.vn, []).append(rec)
        for recs in by_vn.values():
            dup = len(recs) > 1
            for j, _ in enumerate(recs):
                self.profile.observe("redundant_load", dup and j > 0)
            if not dup:
                continue
            n = len(recs)
            extra = sum(r.nbytes for r in recs[1:])
            # one calling context with user frames for every copy: a loop
            # re-executing the site (a recompute runs it again from another
            # context; a backward on the autograd engine's thread has none)
            ctxs = {r.node.meta.get("context") for r in recs}
            ctx = next(iter(ctxs))
            if len(ctxs) == 1 and ctx is not None and len(ctx) > 1:
                self._flag("redundant_load", recs[0].node, bytes=extra,
                           count=n - 1, c2_node=recs[1].node,
                           fraction=1.0 - 1.0 / n,
                           rule=f"loop-invariant load re-executed by a "
                                f"loop [trips={n}]")
            else:
                self._flag("redundant_load", recs[0].node, bytes=extra,
                           count=n - 1, c2_node=recs[1].node,
                           rule=f"same buffer loaded at identical indices "
                                f"{n}x in one scope")

        # ---- dead placeholders ------------------------------------------
        self._dead_params(graph, traced, arg_labels, writers)
        return self.profile

    # -- rules ----------------------------------------------------------
    def _load(self, node, loads) -> None:
        num = self.num
        src = node.args[0]
        make = _LOADS.get(node.target)
        region = num.region.get(src, ())
        if make is not None:
            region = region + (num.key(make(node.args)),)
        vn = num.vn[node]
        loads.append(_LoadRec(node, vn, nbytes(node.meta.get("val"))))
        root = num.root[src]
        self._load_src[vn] = (num.cur(root), region, _shape(node))

    def _store(self, node, store, pre, stores, unread, pending) -> None:
        num = self.num
        pos, make = store
        root, dest_vn, region, upd_vn = pre
        extra = make(node.args)
        if extra is not None:
            region = region + (num.key(extra),)
        upd = node.args[pos] if pos < len(node.args) else None
        shape = _shape(upd)
        rec = _StoreRec(node, root, region, shape,
                        nbytes(upd.meta.get("val"))
                        if isinstance(upd, fx.Node) else 0.0)
        stores.append(rec)
        # silent store: the update was loaded from this very buffer at
        # this very region (Def. 2, provable statically)
        if upd_vn is not None:
            src = self._load_src.get(upd_vn)
            if src is not None and src == (dest_vn, region, shape):
                rec.silent = True
                self._flag("silent_store", node, bytes=rec.nbytes,
                           rule="stores the region it loaded from the same "
                                "indices (write-back of resident value)")
        # dead store: this store overwrites the exact region a previous
        # store (that nothing read since) just wrote (Def. 1)
        prev = pending.setdefault(root, {}).get(region)
        if prev is not None and prev.shape == shape and not prev.dead:
            prev.dead = True
            self._flag("dead_store", prev.node, bytes=prev.nbytes,
                       c2_node=node,
                       rule="written region fully overwritten before any "
                            "read")
        pending[root][region] = rec
        unread.setdefault(root, []).append(rec)

    def _identity(self, node) -> None:
        num = self.num
        name = node.target.overloadpacket.__name__
        ident = _IDENTITY.get(name)
        if ident is None or len(node.args) != 2:
            return
        alpha = node.kwargs.get("alpha", 1)
        if alpha != 1:
            return
        out_shape = _shape(node)
        for xi, ci in ((0, 1), (1, 0)):
            if name in ("sub", "div") and ci == 0:
                continue            # 0-x / 1/x are not identities
            x, c = node.args[xi], node.args[ci]
            cval = num.const_of(c)
            if (cval is not None and cval == ident
                    and isinstance(x, fx.Node) and _shape(x) == out_shape
                    and x.meta.get("val") is not None
                    and x.meta["val"].dtype == node.meta["val"].dtype):
                self.profile.observe("silent_store", True)
                self._flag("silent_store", node,
                           bytes=nbytes(node.meta.get("val")),
                           rule=f"identity {name} with {cval!r}: stores a "
                                f"value equal to the resident operand")
                # the result IS the operand: share its value number
                num.vn[node] = num.cur(x)
                return

    def _dead_params(self, graph, traced, arg_labels, writers) -> None:
        num = self.num
        live = set()
        work = []
        for node in graph.nodes:
            if node.op == "output":
                work.extend(node.all_input_nodes)
        for root, ws in writers.items():
            if root.op == "placeholder":     # a store into an argument
                work.extend(ws)
        while work:
            n = work.pop()
            if n in live:
                continue
            live.add(n)
            work.extend(n.all_input_nodes)
            root = num.root.get(n)
            if root is not None:
                if root is not n:
                    work.append(root)
                work.extend(writers.get(root, ()))
        labels = list(arg_labels if arg_labels is not None else traced.labels)
        phs = traced.placeholders()
        if len(labels) != len(phs):
            labels = [f"arg{i}" for i in range(len(phs))]
        for node, label in zip(phs, labels):
            if not isinstance(node.meta.get("val"), torch.Tensor):
                continue
            dead = node not in live
            self.profile.observe("dead_param", dead)
            if dead:
                self._flag_dead_param(label, node)


# ----------------------------------------------------------------------
def lint_graph(traced: Traced, *, subject: str = "fn",
               arg_labels: Optional[Sequence[str]] = None) -> WasteProfile:
    """Lint an abstract trace; returns a tier-0 WasteProfile."""
    prof = GraphLinter(subject).lint(traced, arg_labels=arg_labels)
    prof.meta["trace_s"] = traced.seconds
    prof.meta["nodes"] = traced.nodes
    prof.meta["kernel_nodes"] = dict(sorted(traced.kernel_nodes().items()))
    return prof


def lint_fn(fn, *args, subject: str = "fn",
            arg_labels: Optional[Sequence[str]] = None) -> WasteProfile:
    """``trace_program`` + lint. ``args`` may be fake tensors (no
    allocation at any width) or real ones, in pytrees.

    ``arg_labels`` defaults to the flattened pytree key paths of ``args``
    so dead-parameter findings name the buffer
    (``arg0['main']['b0_moe']['moe']['w_up']``) instead of a position."""
    return lint_graph(trace_program(fn, *args), subject=subject,
                      arg_labels=arg_labels)
