"""Abstract traces of a step on fake tensors: the graphs tiers 0 and 2
read (the counterpart of the reference's ``jax.make_jaxpr`` and
``.lower().compile()``).

``trace_program(fn, *args)`` and ``trace_step(fn, *args)`` run ``fn``
once under a recording dispatch mode above a ``FakeTensorMode`` (what
``make_fx(..., tracing_mode="fake")`` does, with a lighter recorder:
make_fx took ~1.7x the seconds a node on the zoo's steps). Every tensor
is a fake tensor — shape, dtype and device, no storage — so nothing is
allocated on the device and no kernel is built or launched, whatever the
widths. Real tensors passed in (an engine's parameters and cache) are
converted without copying their data. Each aten operation that reaches
the dispatcher becomes one ``torch.fx`` node (a tuple result one
``getitem`` node per tensor), a tensor that no operation made (a
constant) a ``get_attr`` node, and each kernel entry point of
``kernels/ops.py`` one node of its own (``kernels/traced.py``), its
backward another. Every node carries the user frames that dispatched it:
its ``context`` and innermost ``source`` file and line, taken as tier 1
takes them (``core/context.py``).

The two views are one trace, since eager PyTorch has no compiler between
the program as written and the operations that run:

* tier 0 (``core/graph_lint.py``) reads it as written. Nothing is
  functionalised: an in-place store (``index_put_``, ``copy_`` into a
  view, ``scatter_``, ``index_copy_``) stays a store and a view stays a
  view;
* tier 2 (``core/graph_cost.py``, ``core/graph_waste.py``) counts what
  it costs: when ``fn`` takes gradients the graph holds autograd's
  backward, and under remat "full" or "dots" the recompute that
  ``torch.utils.checkpoint`` inserts (no proxy mode is on, so selective
  checkpointing recomputes as it does eagerly).

Python loops are unrolled in the trace, so no node has a trip-count
multiplier. The parameter and state trees for a trace at any width come
from ``models/params.py:abstract_tree``, ``models/lm.py:LM.
abstract_params`` and ``train/state.py:abstract``, made under the mode
``abstract_mode()`` returns.
"""
from __future__ import annotations

import operator
import time
from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.fx as fx
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.context import context_of_frames, user_frames
from repro_torch.kernels import traced as _traced


class _AbstractMode(FakeTensorMode):
    """A fake-tensor mode that keeps no constants: a fake tensor made from
    a Python scalar (``torch.tensor(0.5)``) would otherwise keep its real
    value, and operations on such constants run for real — on the card,
    an allocation there."""

    def may_turn_const(self, t) -> bool:
        return False


def abstract_mode() -> FakeTensorMode:
    """A fresh fake-tensor mode: tensors made under it have no storage,
    and no operation under it runs for real. The trees of one trace must
    come from one mode."""
    return _AbstractMode(allow_non_fake_inputs=True)


def kernel_label(node: fx.Node) -> Optional[str]:
    """``ops.<name>`` (``ops.<name>.bwd``) for a kernel node, else
    None."""
    target = node.target
    if (node.op == "call_function"
            and isinstance(target, torch._ops.OpOverload)
            and target.namespace == _traced.NS):
        return _traced.label(target._opname)
    return None


def op_name(node: fx.Node) -> str:
    """The node's operation as a context ends with it: ``ops.<name>``
    for a kernel node, the aten packet name (``add``, ``index_put_``)
    otherwise."""
    label = kernel_label(node)
    if label is not None:
        return label
    target = node.target
    if isinstance(target, torch._ops.OpOverload):
        return target.overloadpacket.__name__
    return getattr(target, "__name__", str(target))


def arg_tree_labels(args) -> List[str]:
    """Key-path labels of the flattened tensor leaves of ``args``, in the
    order the trace's placeholders take them (``arg0['main']['b0_moe']
    ['moe']['w_up']``)."""
    labels = []
    for i, a in enumerate(args):
        for path, leaf in pytree.tree_flatten_with_path(a)[0]:
            labels.append(f"arg{i}{pytree.keystr(path)}" if path
                          else f"arg{i}")
    return labels


@dataclass
class Traced:
    """One abstract trace: the graph, its placeholders' labels (one per
    tensor leaf of the arguments) and the seconds the trace took."""
    graph: fx.Graph
    labels: List[str]
    seconds: float

    @property
    def nodes(self) -> int:
        return len(self.graph.nodes)

    def kernel_nodes(self) -> Counter:
        """Kernel nodes by ``ops.<name>`` (``ops.<name>.bwd``)."""
        return Counter(label for label in map(kernel_label, self.graph.nodes)
                       if label is not None)

    def placeholders(self) -> List[fx.Node]:
        return [n for n in self.graph.nodes if n.op == "placeholder"]


class _Record(TorchDispatchMode):
    """Above a fake-tensor mode: one node per dispatched operation, with
    the user frames that dispatched it. Tensors are kept alive for the
    trace, so ``id`` names each one."""

    def __init__(self, graph: fx.Graph):
        super().__init__()
        self.graph = graph
        self.node_of: Dict[int, fx.Node] = {}
        self.keep: List[Any] = []

    def bind(self, t: torch.Tensor, node: fx.Node) -> None:
        self.node_of[id(t)] = node
        self.keep.append(t)

    def arg(self, a):
        """An operation's argument as the graph holds it: a tensor's
        node (a new ``get_attr`` node for a constant)."""
        if isinstance(a, torch.Tensor):
            node = self.node_of.get(id(a))
            if node is None:
                node = self.graph.create_node(
                    "get_attr", f"_const{len(self.keep)}")
                node.meta["val"] = a
                self.bind(a, node)
            return node
        if isinstance(a, (list, tuple)):
            return type(a)(self.arg(x) for x in a)
        return a

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not isinstance(out, torch.Tensor) and not (
                isinstance(out, (tuple, list))
                and any(isinstance(t, torch.Tensor) for t in out)):
            return out              # a metadata query (``prim.device``)
        node = self.graph.create_node(
            "call_function", func, tuple(self.arg(a) for a in args),
            {k: self.arg(v) for k, v in kwargs.items()})
        node.meta["val"] = out
        frames = user_frames()
        source = (frames[0][1], frames[0][2]) if frames else None
        node.meta["context"] = context_of_frames(frames, op_name(node))
        node.meta["source"] = source
        if isinstance(out, torch.Tensor):
            self.bind(out, node)
        elif isinstance(out, (tuple, list)):
            for i, t in enumerate(out):
                if isinstance(t, torch.Tensor):
                    item = self.graph.create_node(
                        "call_function", operator.getitem, (node, i))
                    item.meta["val"] = t
                    item.meta["context"] = node.meta["context"]
                    item.meta["source"] = source
                    self.bind(t, item)
        return out


def _trace(fn: Callable, args) -> Traced:
    t0 = time.perf_counter()
    graph = fx.Graph()
    flat, spec = pytree.tree_flatten(args)
    mode = next((t.fake_mode for t in flat if isinstance(t, FakeTensor)),
                None) or abstract_mode()
    rec = _Record(graph)
    fake, labels = [], []
    for label, a in zip(arg_tree_labels(args), flat):
        if isinstance(a, torch.Tensor):
            if not isinstance(a, FakeTensor):
                a = mode.from_tensor(a)
            node = graph.placeholder(f"arg{len(labels)}")
            node.meta["val"] = a
            rec.bind(a, node)
            labels.append(label)
        fake.append(a)
    fargs = pytree.tree_unflatten(fake, spec)

    def _traced():
        with rec:
            return fn(*fargs)

    with mode:
        out = _traced()
    graph.output(tuple(rec.arg(t) for t in pytree.tree_leaves(out)
                       if isinstance(t, torch.Tensor)))
    return Traced(graph=graph, labels=labels,
                  seconds=time.perf_counter() - t0)


def trace_program(fn: Callable, *args) -> Traced:
    """Tier 0's view of ``fn(*args)``: the program as written (stores,
    views, user frames). ``args`` are fake tensors (or real ones, used
    for their shapes) in pytrees."""
    return _trace(fn, args)


def trace_step(fn: Callable, *args) -> Traced:
    """Tier 2's view of ``fn(*args)``: the operations that run, with the
    backward and the recompute when ``fn`` takes gradients."""
    return _trace(fn, args)
