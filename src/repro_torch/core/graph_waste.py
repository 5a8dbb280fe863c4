"""Tier 2: waste analysis of an abstract trace of a step (DESIGN.md §2),
held against src/repro/core/hlo_waste.py.

The reference scans the optimised HLO of a compiled step; the port scans
the graph of the step that runs eagerly (``core/graph_trace.py:
trace_step``: the forward, autograd's backward and the recompute of
``torch.utils.checkpoint``) for the paper's waste categories:

  redundant collectives — the same source tensor gathered / reduced more
                          than once over the same group (the same kind,
                          group and operand value number: two layers'
                          same-shaped reductions are not one);
  recompute (dead work) — a matrix product or convolution computed more
                          than once on the same operands (the same value
                          numbers: remat's recompute or a missed reuse),
                          and reductions over ``_REDUCE_DUP_FLOOR`` operand
                          bytes computed twice;
  reshard copies        — operations that only move bytes over
                          ``reshard_threshold``: a ``clone`` of a permuted
                          (non-contiguous) view, a ``copy_``;
  padding               — products fed by an explicit ``constant_pad_nd``:
                          the padded rows' flops.

Built on the cost model (``core/graph_cost.py``); every finding carries
its node's provenance (innermost user frame and operation), the same
two-party attribution discipline as the runtime tiers, and lands in the
unified ``WasteProfile`` (tier 2), mergeable with the other tiers.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

import torch
import torch.fx as fx

from repro_torch.core.findings import Finding, WasteProfile
from repro_torch.core.graph_cost import (GraphCostModel, _type_str,
                                         collective_of, dot_flops,
                                         node_op_name)
from repro_torch.core.graph_lint import Numbering, nbytes
from repro_torch.core.graph_trace import Traced, op_name


@dataclass
class WasteReport:
    redundant_collectives: List[Dict] = field(default_factory=list)
    recompute: List[Dict] = field(default_factory=list)
    reshard_copies: List[Dict] = field(default_factory=list)
    padding: List[Dict] = field(default_factory=list)
    totals: Dict[str, float] = field(default_factory=dict)
    # the unified cross-tier view of the same findings (DESIGN.md §2)
    profile: WasteProfile = field(default_factory=lambda: WasteProfile(tier=2))

    def summary(self) -> str:
        out = ["== JXPerf-JAX Tier-2 (traced step waste) =="]
        t = self.totals
        out.append(f"  redundant collective wire bytes/dev: "
                   f"{t.get('redundant_collective_bytes', 0)/1e9:.3f} GB")
        out.append(f"  duplicate-compute flops/dev:          "
                   f"{t.get('recompute_flops', 0)/1e12:.3f} TF")
        out.append(f"  reshard copy bytes/dev:               "
                   f"{t.get('reshard_bytes', 0)/1e9:.3f} GB")
        out.append(f"  padded product flops/dev:             "
                   f"{t.get('padding_flops', 0)/1e12:.3f} TF")
        for r in self.redundant_collectives[:5]:
            out.append(f"  [coll x{r['copies']}] {r['kind']} "
                       f"{r['shape']} wire {r['wire_bytes']/1e9:.2f} GB | "
                       f"{r['op_name'][-60:]}")
        for r in self.recompute[:5]:
            out.append(f"  [dup x{r['copies']}] {r['fingerprint'][:60]} "
                       f"{r['flops']/1e12:.2f} TF")
        for r in self.reshard_copies[:5]:
            out.append(f"  [reshard] {r['op']} {r['shape']} "
                       f"{r['bytes']/1e9:.2f} GB | {r['op_name'][-60:]}")
        for r in self.padding[:5]:
            out.append(f"  [pad] {r['op']} {r['shape']} "
                       f"{r['flops']/1e12:.2f} TF | {r['op_name'][-60:]}")
        return "\n".join(out)


# ops eligible for duplicate-compute detection; reductions join them only
# above _REDUCE_DUP_FLOOR operand bytes (small reductions duplicate all
# over legitimately — epilogues, norms — and cost nothing)
_DUP_OPS = ("mm", "bmm", "addmm", "baddbmm", "mv", "dot", "convolution")
_DUP_REDUCE = ("sum", "mean", "amax", "amin", "prod", "logsumexp")
_REDUCE_DUP_FLOOR = 1e6

# default reshard-copy size floor (bytes)
RESHARD_THRESHOLD = 64e6


def _operand_provenance(node: fx.Node) -> str:
    """Who produced each operand: producer operation + its user frame
    (``arg`` for a placeholder)."""
    parts = []
    for a in node.all_input_nodes:
        if a.op == "placeholder":
            parts.append("arg")
        else:
            parts.append(node_op_name(a))
    return ";".join(parts)


def _is_permuted(val) -> bool:
    return isinstance(val, torch.Tensor) and not val.is_contiguous()


def analyze_waste(traced, top_k: int = 20,
                  reshard_threshold: float = RESHARD_THRESHOLD,
                  default_participants: int = 1) -> WasteReport:
    graph = traced.graph if isinstance(traced, Traced) else traced
    cm = GraphCostModel(graph, default_participants)
    rep = WasteReport()
    num = Numbering()
    costs = {}
    # --- redundant collectives: same (kind, operand fingerprint) ---------
    seen: Dict[tuple, List] = defaultdict(list)
    for node in graph.nodes:
        coll = collective_of(node) if node.op == "call_function" else None
        if coll is not None:
            # the collected VALUE as the collective reads it (value
            # numbers, as for recompute below) and every other argument
            # (the group and its size, the reduction)
            fp = (coll[0], num.key(tuple(node.args)))
        num.number(node)
        costs[node] = cm.node_cost(node)
        if coll is None:
            continue
        seen[fp].append({
            "kind": coll[0], "shape": _type_str(node.meta.get("val")),
            "wire_bytes": costs[node].coll_wire_bytes, "mult": 1.0,
            "op_name": node_op_name(node)})
    red_total = 0.0
    for fp, items in seen.items():
        redundant = len(items) > 1 and items[0]["wire_bytes"] > 0
        rep.profile.observe("redundant_collective", redundant)
        if redundant:
            extra = sum(it["wire_bytes"] for it in items[1:])
            red_total += extra
            rep.redundant_collectives.append({
                "kind": fp[0], "shape": items[0]["shape"],
                "copies": len(items), "wire_bytes": extra,
                "op_name": items[0]["op_name"]})
            rep.profile.add(Finding(
                kind="redundant_collective", tier=2,
                c1=(items[0]["op_name"] or f"{fp[0]} {items[0]['shape']}",),
                count=len(items), bytes=extra,
                meta={"kind": fp[0], "shape": items[0]["shape"]}))
    rep.redundant_collectives.sort(key=lambda r: -r["wire_bytes"])
    rep.redundant_collectives = rep.redundant_collectives[:top_k]

    # --- duplicate compute (remat recompute / missed reuse) ----------------
    dup: Dict[tuple, List] = defaultdict(list)
    first_fp: Dict[tuple, str] = {}
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        name = op_name(node)
        if name not in _DUP_OPS:
            if name not in _DUP_REDUCE:
                continue
            opbytes = sum(nbytes(a.meta.get("val"))
                          for a in node.all_input_nodes)
            if opbytes < _REDUCE_DUP_FLOOR:
                continue
        # the same operation over the same operand VALUES (value numbers,
        # not shapes: two layers' same-shaped products differ)
        key = (str(node.target),
               tuple(num.cur(a) if isinstance(a, fx.Node) else repr(a)
                     for a in node.args))
        fl = dot_flops(node) if name in _DUP_OPS else costs[node].flops
        dup[key].append(fl)
        if key not in first_fp:
            opshapes = ",".join(_type_str(a.meta.get("val"))
                                for a in node.all_input_nodes)
            first_fp[key] = (f"{name} {_type_str(node.meta.get('val'))} <- "
                             f"{opshapes} [{_operand_provenance(node)}]")
    rec_total = 0.0
    for key, fl in dup.items():
        duplicated = len(fl) > 1
        rep.profile.observe("recompute", duplicated)
        if duplicated:
            extra = sum(sorted(fl)[:-1])
            rec_total += extra
            fp = first_fp[key]
            rep.recompute.append({"fingerprint": fp, "copies": len(fl),
                                  "flops": extra})
            rep.profile.add(Finding(kind="recompute", tier=2, c1=(fp,),
                                    count=len(fl), flops=extra))
    rep.recompute.sort(key=lambda r: -r["flops"])
    rep.recompute = rep.recompute[:top_k]

    # --- reshard copies -----------------------------------------------------
    resh_total = 0.0
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        name = op_name(node)
        if name == "copy_":
            b = nbytes(node.args[1].meta.get("val")) \
                if isinstance(node.args[1], fx.Node) else 0.0
        elif name == "clone" and isinstance(node.args[0], fx.Node) \
                and _is_permuted(node.args[0].meta.get("val")):
            b = nbytes(node.meta.get("val"))
        else:
            continue
        large = b >= reshard_threshold
        rep.profile.observe("reshard_copy", large)
        if not large:
            continue
        resh_total += 2 * b
        nm = node_op_name(node)
        shape = _type_str(node.meta.get("val"))
        rep.reshard_copies.append({"op": name, "shape": shape,
                                   "bytes": 2 * b, "op_name": nm})
        rep.profile.add(Finding(
            kind="reshard_copy", tier=2, c1=(nm or f"{name} {shape}",),
            bytes=2 * b, meta={"op": name}))
    rep.reshard_copies.sort(key=lambda r: -r["bytes"])
    rep.reshard_copies = rep.reshard_copies[:top_k]

    # --- padding: products over explicitly padded operands -----------------
    pad_total = 0.0
    for node in graph.nodes:
        if node.op != "call_function" or op_name(node) not in _DUP_OPS:
            continue
        padded = [a for a in node.all_input_nodes
                  if op_name(a) == "constant_pad_nd"]
        rep.profile.observe("dot_padding", bool(padded))
        if not padded:
            continue
        frac = 0.0
        for a in padded:
            src = a.args[0].meta.get("val")
            full = a.meta.get("val")
            frac = max(frac, 1.0 - src.numel() / max(full.numel(), 1))
        fl = dot_flops(node) * frac
        pad_total += fl
        nm = node_op_name(node)
        shape = _type_str(node.meta.get("val"))
        rep.padding.append({"op": op_name(node), "shape": shape,
                            "flops": fl, "fraction": frac, "op_name": nm})
        rep.profile.add(Finding(kind="dot_padding", tier=2, c1=(nm,),
                                flops=fl, fraction=frac,
                                meta={"shape": shape}))
    rep.padding.sort(key=lambda r: -r["flops"])
    rep.padding = rep.padding[:top_k]

    rep.totals = {
        "redundant_collective_bytes": red_total,
        "recompute_flops": rec_total,
        "reshard_bytes": resh_total,
        "padding_flops": pad_total,
    }
    for k, v in rep.totals.items():
        rep.profile.bump_total(k, v)
    rep.profile.meta["collective_nodes"] = {
        kind: sum(len(items) for fp, items in seen.items() if fp[0] == kind)
        for kind in sorted({fp[0] for fp in seen})}
    if isinstance(traced, Traced):
        rep.profile.meta["trace_s"] = traced.seconds
        rep.profile.meta["nodes"] = traced.nodes
        rep.profile.meta["kernel_nodes"] = dict(traced.kernel_nodes())
    return rep
