"""Roofline terms of a traced dry-run cell, for NVIDIA H100 SXM cards.

Port of src/repro/launch/roofline.py, which reads XLA's compiled module
on v5e constants. Here the subject is one rank's abstract trace
(``core/graph_trace.py``) and its costs are ``core/graph_cost.py``'s:

    compute    = flops per rank / PEAK_FLOPS
    memory     = HBM bytes per rank / HBM_BW
    collective = sum over the rank's collectives of wire bytes / the
                 link rate of its group (``link_bw``)

The H100 constants (NVIDIA's data sheet, SXM part, dense rates at the
700 W limit): 989 TFLOP/s bf16 without sparsity (67 TFLOP/s float32
outside the tensor cores, for the kernels' bounds in chip_smoke.py),
3.35 TB/s of HBM3.
The link model: NVLink 4 gives each card 450 GB/s a direction to the
other cards of its 8-card node; a group that spans nodes runs at the
node's network rate, one 400 Gb/s NIC a card (50 GB/s). Ranks fill nodes
in rank order (row-major over the mesh), so on the 16 x 16 mesh every
'model' group (16 consecutive ranks) and every 'data' group spans nodes.

What the memory term holds: every traced node's operands and results
as ``GraphCostModel`` counts them (a view is free; eager PyTorch
materialises every other result, so these are not a fused program's
bytes). A kernel node (B1, B2, B4, B5 and their backwards) already pays
its operands and results there: its ideal traffic
(``ideal_kernel_bytes``, ``ideal_paged_attention_bytes``) is reported
beside it and never added, and nothing is zeroed. The reference's
``KERNEL_SCOPES`` (the flash-attention, SSD and mLSTM regions that ran
in VMEM) have no counterpart: attention is a kernel node, and the SSD
and mLSTM scans are plain torch operations whose bytes count as any
other's. Every term is a model of one rank of the mesh, not a
measurement.
"""
from __future__ import annotations

from typing import Dict, Optional

# H100 SXM (dense, 700 W)
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card
PEAK_FLOPS_F32 = 67e12       # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s a direction, inside one node
NIC_BW = 50e9                # bytes/s a card, between nodes (400 Gb/s)
NODE_CARDS = 8               # cards a node


def link_bw(mesh, axes) -> float:
    """The link rate of the group of ``mesh.rank``'s peers over
    ``axes``: NVLink when they all lie in this rank's node, else the
    network's."""
    nodes = {r // NODE_CARDS for r in mesh.peers(axes)}
    return NVLINK_BW if len(nodes) == 1 else NIC_BW


def ideal_kernel_bytes(cfg, shape) -> float:
    """GLOBAL ideal HBM bytes of the kernel regions per step.

    flash attention: q,k,v reads + out write per invocation; mamba SSD /
    mLSTM chunked: ~4 passes over the (B,S,d_inner) working set. Training
    multiplies by ~4.5 (fwd + remat recompute + flash backward reads/writes);
    prefill by 1. Decode cells never take the flash path, so no
    adjustment applies; the paged-KV decode kernels have their own
    page-granular model (``ideal_paged_attention_bytes``).
    """
    B, S = shape.global_batch, shape.seq_len
    D, Hq, Hkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    bt = 2.0                                   # bf16 activations
    train = shape.kind == "train"
    passes = 4.5 if train else 1.0

    def attn(nlayers, sq, skv):
        fwd = B * (sq * Hq + 2 * skv * Hkv + sq * Hq) * D * bt
        return nlayers * passes * fwd

    total = 0.0
    fam = cfg.family
    if fam in ("dense", "moe"):
        total += attn(cfg.num_layers, S, S)
    elif fam == "vlm":
        p = cfg.cross_attn_period
        total += attn(cfg.num_layers - cfg.num_layers // p, S, S)
        total += attn(cfg.num_layers // p, S, cfg.num_image_tokens)
    elif fam == "audio":
        F = S                                   # stub frames = seq_len
        total += attn(cfg.encoder_layers, F, F)
        total += attn(cfg.num_layers, S, S)     # decoder self
        total += attn(cfg.num_layers, S, F)     # decoder cross
    elif fam == "hybrid":
        n_attn = cfg.num_layers // cfg.attn_period
        total += attn(n_attn, S, S)
        d_inner = cfg.ssm.expand * cfg.d_model
        total += cfg.num_layers * passes * 4 * B * S * d_inner * bt
    elif fam == "ssm":
        d_in = int(cfg.d_model * cfg.xlstm.proj_factor_mlstm)
        total += cfg.num_layers * passes * 4 * B * S * d_in * bt
    return total


def ideal_paged_attention_bytes(*, batch: int, q_len: int,
                                mapped_pages: int, max_pages: int,
                                page_size: int, num_heads: int,
                                num_kv_heads: int, head_dim: int,
                                kv_bytes: float = 2.0,
                                act_bytes: float = 2.0,
                                materialize: bool = False) -> float:
    """Ideal HBM bytes of ONE paged-attention forward (one layer).

    The paged layout's minimal traffic is page-granular: the kernel
    reads the page table (4 bytes/entry over every slot's table), then
    each MAPPED page of K and V exactly once at full page granularity (a
    partially-filled last page still moves page_size rows), plus the q
    read, the new K/V row writes and the output write.

    ``materialize=True`` models the plain composition (``paged_update ->
    paged_gather -> attention``) instead: on top of the kernel traffic it
    WRITES the (batch, max_pages*page_size) logical K/V view to HBM and
    reads it back, the gather materialization the kernel eliminates.

    mapped_pages: total mapped page-table entries across the batch
    (page-granular occupancy, NOT token count); max_pages: per-slot
    table length M.
    """
    Hq, Hkv, D = num_heads, num_kv_heads, head_dim
    pt_read = batch * max_pages * 4.0
    kv_read = mapped_pages * page_size * Hkv * D * 2.0 * kv_bytes
    q_read = batch * q_len * Hq * D * act_bytes
    new_write = batch * q_len * Hkv * D * 2.0 * kv_bytes
    out_write = batch * q_len * Hq * D * act_bytes
    total = pt_read + kv_read + q_read + new_write + out_write
    if materialize:
        # the logical view is dense over the FULL table extent: one
        # write of the view, one read back by the attention
        view = batch * max_pages * page_size * Hkv * D * 2.0 * kv_bytes
        total += 2.0 * view
    return total


def roofline_terms(cost: Dict[str, float], wire_bytes_per_dev: float,
                   chips: int, model_flops: Optional[float] = None,
                   min_bytes_global: float = 0.0,
                   t_collective_s: Optional[float] = None) -> Dict:
    """cost: flops / bytes-accessed dict (per rank). min_bytes_global:
    unavoidable HBM traffic (weights + KV cache for decode): the memory
    leg of the ideal-time roofline. ``t_collective_s``: the collectives'
    time under the link model (``analyze_traced``); None takes every
    wire byte at the network's rate."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = (wire_bytes_per_dev / NIC_BW if t_collective_s is None
              else t_collective_s)
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    out = {
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "wire_bytes_per_device": wire_bytes_per_dev,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "chips": chips,
        "flops_global": flops_dev * chips,
    }
    if model_flops:
        out["model_flops"] = model_flops
        out["useful_flops_ratio"] = model_flops / max(flops_dev * chips, 1.0)
        t_star = max(t_compute, t_memory, t_coll)
        ideal = max(model_flops / (chips * PEAK_FLOPS),
                    min_bytes_global / (chips * HBM_BW))
        out["t_ideal_s"] = ideal
        out["roofline_fraction"] = ideal / t_star if t_star > 0 else 0.0
    return out


def analyze_traced(traced, mesh, model_flops: Optional[float] = None,
                   min_bytes_global: float = 0.0) -> Dict:
    """The roofline record of one rank's trace on ``mesh`` (the
    counterpart of the reference's ``analyze_compiled``): the cost
    model's flops and HBM bytes, each collective's wire bytes over its
    group's link (the group read from the node's name,
    ``sharding/comm.py:group_name``), and the terms of
    ``roofline_terms`` for ``mesh.size`` cards."""
    from repro_torch.core.graph_cost import GraphCostModel, group_of
    cm = GraphCostModel(traced)
    total = cm.total()
    t_coll = 0.0
    for node in cm.graph.nodes:
        name = group_of(node) if node.op == "call_function" else None
        if name is None:
            continue
        # "data,model/4": the axes before the slash
        axes = tuple(name.rpartition("/")[0].split(","))
        bw = link_bw(mesh, axes) if set(axes) <= set(mesh.shape) else NIC_BW
        t_coll += cm.node_cost(node).coll_wire_bytes / bw
    terms = roofline_terms({"flops": total.flops,
                            "bytes accessed": total.hbm_bytes},
                           total.coll_wire_bytes, mesh.size, model_flops,
                           min_bytes_global, t_collective_s=t_coll)
    terms["dot_flops_per_device"] = total.dot_flops
    terms["collectives"] = dict(total.coll_by_kind)
    terms["num_collectives"] = total.coll_count
    terms["transcendentals"] = total.transcendentals
    return terms

