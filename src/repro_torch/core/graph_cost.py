"""Cost model of an abstract trace, held against src/repro/core/
hlo_cost.py.

The reference parses the optimised HLO of a compiled step and multiplies
each while body by its trip count. The port's step is the graph of an
abstract trace (``core/graph_trace.py:trace_step``) in which Python loops
are unrolled, so every node's multiplier is 1 and the totals are the
reference's totals after its multiplication. Per node:

    flops          exact for ``mm``, ``bmm``, ``addmm``, ``baddbmm``,
                   ``mv``, ``dot`` and ``convolution`` (2 per
                   multiply-add, the reference's ``_dot_flops`` /
                   ``_conv_flops``); ~1 per output element for pointwise
                   operations and reductions (transcendentals counted
                   apart as well); 0 for a kernel node, as the reference
                   counts a custom call;
    hbm_bytes      a view is free; a load (``index``, ``gather``, ...)
                   reads and writes its window, an in-place store its
                   update (reference :361-370); a kernel node pays its
                   results and every operand, as a custom call (:371-373);
                   any other operation its result and its operands (eager
                   PyTorch materialises every result: these totals are
                   not the fused reference's);
    collectives    ``_c10d_functional`` operations pay the ring model's
                   wire bytes (``_wire``, reference :216) over their own
                   group's size: the group name's ``/<size>`` suffix
                   (``sharding/comm.py:group_name``), else an int
                   argument that gives it, else the model's
                   ``default_participants``. A broadcast pays what an
                   all-gather of its payload pays (a pipelined ring: each
                   rank but the source receives the payload once).

``GraphCostModel.node_cost`` is what the tier-2 waste analysis reads per
node (``core/graph_waste.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch
import torch.fx as fx

from repro_torch.core.graph_lint import nbytes, schema
from repro_torch.core.graph_trace import Traced, kernel_label, op_name

_DOTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "mv", "dot",
                   "convolution"})
_TRANSCENDENTAL = frozenset({"exp", "exp2", "log", "log2", "tanh", "rsqrt",
                             "sqrt", "sigmoid", "expm1", "log1p", "cos",
                             "sin", "erf", "pow", "silu", "gelu",
                             "softplus", "_softmax", "_log_softmax"})
_REDUCTIONS = frozenset({"sum", "mean", "amax", "amin", "max", "min",
                         "prod", "argmax", "argmin", "norm",
                         "linalg_vector_norm", "var", "var_mean", "std",
                         "logsumexp", "cumsum", "cumprod", "_softmax",
                         "_log_softmax", "all", "any"})
_LOADS = frozenset({"index", "index_select", "gather", "embedding", "take"})
_STORES = frozenset({"copy_", "index_put_", "_index_put_impl_",
                     "index_copy_", "scatter_", "slice_scatter",
                     "select_scatter"})
# values that hold no device bytes of their own
_FREE = frozenset({"empty", "empty_like", "new_empty", "empty_strided",
                   "new_empty_strided", "detach", "alias", "lift_fresh",
                   "_unsafe_view", "wait_tensor", "sym_size", "sym_numel",
                   "sym_stride", "getitem"})
# _c10d_functional ops -> (kind, position of the group size or None,
# position of the group name)
COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", 1, 2),
    "all_reduce": ("all-reduce", None, 2),
    "reduce_scatter_tensor": ("reduce-scatter", 2, 3),
    "all_to_all_single": ("all-to-all", None, 3),
    "broadcast": ("broadcast", None, 2),
}


def _nelems(val) -> int:
    if isinstance(val, torch.Tensor):
        return int(val.numel())
    if isinstance(val, (tuple, list)):
        return sum(_nelems(v) for v in val)
    return 0


def _val(a):
    return a.meta.get("val") if isinstance(a, fx.Node) else None


def _wire(kind: str, result_bytes: float, n: int) -> float:
    """Ring-model wire bytes of one collective over `n` participants
    (reference hlo_cost.py:216)."""
    if kind == "collective-permute":
        return float(result_bytes)       # full payload, any group size
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if kind in ("all-gather", "broadcast"):
        return result_bytes * frac
    if kind == "all-reduce":
        return 2.0 * result_bytes * frac
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-to-all":
        return result_bytes * frac
    return float(result_bytes)


def dot_flops(node: fx.Node) -> float:
    """2 per multiply-add of a matrix product or convolution node, from
    its operands' shapes; 0 for any other node."""
    name = op_name(node)
    out = _val(node)
    if name not in _DOTS or not isinstance(out, torch.Tensor):
        return 0.0
    args = node.args
    if name in ("mm", "bmm", "mv", "dot"):
        k = _val(args[0]).shape[-1]
    elif name in ("addmm", "baddbmm"):
        k = _val(args[1]).shape[-1]
    else:                                           # convolution
        w = _val(args[1])
        transposed = bool(args[6]) if len(args) > 6 else False
        groups = int(args[8]) if len(args) > 8 else 1
        k = (w.shape[0] // groups if transposed else w.shape[1])
        for d in w.shape[2:]:
            k *= d
    return 2.0 * out.numel() * k


@dataclass
class Cost:
    flops: float = 0.0
    dot_flops: float = 0.0
    transcendentals: float = 0.0
    hbm_bytes: float = 0.0
    coll_wire_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = field(default_factory=dict)
    coll_count: float = 0.0

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.dot_flops += other.dot_flops * mult
        self.transcendentals += other.transcendentals * mult
        self.hbm_bytes += other.hbm_bytes * mult
        self.coll_wire_bytes += other.coll_wire_bytes * mult
        self.coll_count += other.coll_count * mult
        for k, v in other.coll_by_kind.items():
            self.coll_by_kind[k] = self.coll_by_kind.get(k, 0.0) + v * mult


def collective_of(node: fx.Node):
    """``(kind, group size or None)`` of a collective node, else None."""
    target = node.target
    if not isinstance(target, torch._ops.OpOverload) or \
            target.namespace != "_c10d_functional":
        return None
    spec = COLLECTIVES.get(target.overloadpacket.__name__)
    if spec is None:
        return None
    kind, pos, _ = spec
    name = group_of(node)
    n = None if name is None else group_size(name)
    if n is None and pos is not None and pos < len(node.args) \
            and isinstance(node.args[pos], int):
        n = int(node.args[pos])
    return kind, n


def group_of(node: fx.Node):
    """The group name a collective node passes (None: not one)."""
    target = node.target
    if not isinstance(target, torch._ops.OpOverload) or \
            target.namespace != "_c10d_functional":
        return None
    spec = COLLECTIVES.get(target.overloadpacket.__name__)
    if spec is None or spec[2] >= len(node.args):
        return None
    name = node.args[spec[2]]
    return name if isinstance(name, str) else None


def group_size(name: str):
    """The size a group name carries after its last slash
    (``"data,model/4"`` -> 4), else None."""
    head, sep, tail = name.rpartition("/")
    return int(tail) if sep and tail.isdigit() else None


class GraphCostModel:
    """Costs of a traced graph's nodes (every multiplier 1)."""

    def __init__(self, traced, default_participants: int = 1):
        self.graph = traced.graph if isinstance(traced, Traced) else traced
        self.default_participants = default_participants

    def node_cost(self, node: fx.Node) -> Cost:
        c = Cost()
        if node.op != "call_function":
            return c
        name = op_name(node)
        out = _val(node)
        rb = nbytes(out)
        operands = [a for a in node.all_input_nodes]
        read = sum(nbytes(_val(a)) for a in operands)
        if kernel_label(node) is not None:
            c.hbm_bytes += rb + read
            return c
        coll = collective_of(node)
        if coll is not None:
            kind, n = coll
            wire = _wire(kind, rb, n or self.default_participants)
            c.coll_wire_bytes += wire
            c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + wire
            c.coll_count += 1
            c.hbm_bytes += rb
            return c
        sch = schema(node.target)
        if name in _FREE or sch is None or (sch.view and not sch.writes):
            return c
        if name in _DOTS:
            f = dot_flops(node)
            c.flops += f
            c.dot_flops += f
            if name in ("addmm", "baddbmm"):
                c.flops += _nelems(out)              # the added input
            c.hbm_bytes += rb + read
            return c
        if name in _LOADS:
            c.hbm_bytes += 2 * rb                    # the window, both ways
            return c
        if name in _STORES:
            pos = {"copy_": 1, "index_put_": 2, "_index_put_impl_": 2,
                   "index_copy_": 3, "scatter_": 3, "slice_scatter": 1,
                   "select_scatter": 1}[name]
            upd = _val(node.args[pos]) if pos < len(node.args) else out
            c.hbm_bytes += 2 * nbytes(upd)
            return c
        n_out = _nelems(out)
        if name in _TRANSCENDENTAL:
            c.flops += n_out
            c.transcendentals += n_out
        elif name in _REDUCTIONS:
            c.flops += n_out
        elif torch.Tag.pointwise in node.target.tags:
            c.flops += n_out
        c.hbm_bytes += rb + read
        return c

    def total(self) -> Cost:
        total = Cost()
        for node in self.graph.nodes:
            total.add(self.node_cost(node))
        return total


def _type_str(val) -> str:
    """``f32[128,128]``-style type of a value (the reference's result
    types)."""
    if isinstance(val, torch.Tensor):
        dt = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.float64: "f64",
              torch.int32: "s32", torch.int64: "s64", torch.int8: "s8",
              torch.uint8: "u8", torch.bool: "pred"}.get(val.dtype,
                                                          str(val.dtype))
        return f"{dt}[{','.join(str(d) for d in val.shape)}]"
    if isinstance(val, (tuple, list)):
        return "(" + ", ".join(_type_str(v) for v in val) + ")"
    return "?"


def node_op_name(node: fx.Node) -> str:
    """The node's provenance as the reference's ``op_name`` metadata: its
    innermost user frame and operation (``layers.py:120:apply_mlp/mm``)."""
    ctx = node.meta.get("context") or ()
    if len(ctx) >= 2:
        return f"{ctx[-2]}/{ctx[-1]}"
    return op_name(node)


def analyze(traced, default_participants: int = 1) -> Cost:
    return GraphCostModel(traced, default_participants).total()
