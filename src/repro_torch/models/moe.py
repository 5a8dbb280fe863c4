"""Mixture-of-Experts layer: token-choice top-k routing with capacity.

Two dispatch paths share one routing front-end (``_route``):

* ``dispatch="scatter"`` (default): capacity-mask scatter. Routed tokens
  are written into their (expert, group, slot) row of the experts' input
  rows; dropped tokens go to one spare row that the experts never read,
  so only routed rows of the (B, E, C, d) expert buffer are ever written
  (the dead-expert-store fraction is 0 by construction). The combine
  gathers each token's expert rows back, 0 for the dropped ones (the
  reference's ``mode="fill"``), and weights them by the kept gates.
* ``dispatch="einsum"``: the GShard/Switch one-hot einsum dispatch kept
  as the A/B reference. It materializes every (e, c) row: rows no token
  routed to are Def.-1 dead stores (``dispatch_stats`` counts them).

Tokens are regrouped into groups of ``min(GROUP, tokens)``; routing and
capacity are per group, with every k = 0 choice ahead of every k = 1
choice (GShard priority). Where a training strategy splits the batch's
rows over ranks, a rank routes its tokens as the whole batch's
(``_route_rows``): the ranks' top-K choices are gathered, so the groups,
capacity slots and aux loss are the unsharded layer's, while each rank
dispatches and combines its own tokens. ``jax.lax.top_k`` breaks ties toward the lower
index and the order of the K choices sets that priority, so the top-K is
a stable descending sort. For K >= 2 the combine contracts over k where
the einsum contracts over (e, c): the two paths agree to ~1 ulp in
float32, not bit for bit. The expert FFN's three batched products are
plain batched matmuls: the reference runs them outside any Pallas
kernel.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.sharding import comm


def decl_moe(cfg: ModelConfig) -> Dict[str, Any]:
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff, m.num_experts
    decl = {
        "router": P.ParamDecl((d, e), ("embed", None), "normal", 0.02),
        "w_up": P.ParamDecl((e, d, f), ("experts", "embed", "ffn"),
                            "normal", 1.0 / math.sqrt(d)),
        "w_gate": P.ParamDecl((e, d, f), ("experts", "embed", "ffn"),
                              "normal", 1.0 / math.sqrt(d)),
        "w_down": P.ParamDecl((e, f, d), ("experts", "ffn", "embed"),
                              "normal", 1.0 / math.sqrt(f)),
    }
    if m.shared_expert:
        decl["shared"] = {
            "up": P.linear(d, f, "embed", "ffn"),
            "gate": P.linear(d, f, "embed", "ffn"),
            "down": P.linear(f, d, "ffn", "embed"),
        }
    return decl


GROUP = 256  # tokens per dispatch group; keeps the (g,E,C) tensors small


def capacity(cfg: ModelConfig, group: int) -> int:
    m = cfg.moe
    c = int(math.ceil(m.experts_per_token * group * m.capacity_factor
                      / m.num_experts))
    # rounded up to a multiple of 8, as the reference lane-aligns it
    return max(8, -(-c // 8) * 8)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of the last dim and their indices, ties
    toward the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``F.one_hot(idx, n)`` in ``dtype``, without its range check, which
    reads the indices back to the host (a device sync per call)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _gates(p, cfg: ModelConfig, x: torch.Tensor, layout=None):
    """(probs, renormalized top-K gates, top-K experts) of tokens x
    (..., d): the router in float32, gathered whole on each dim that
    ``layout`` (the layer's spec tree) shards (``comm.gather_from``: each
    rank routes every token, so the backward keeps its block)."""
    m = cfg.moe
    router = p["router"]
    for dim, axes in enumerate(() if layout is None else layout["router"]):
        if axes is not None:
            from repro_torch.sharding.ctx import current_sharder
            router = comm.gather_from(router, axes, current_sharder().mesh,
                                      dim=dim)
    logits = x.float() @ router.float()                               # (...,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, m.experts_per_token)           # (...,K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, gate_idx


def _aux(cfg: ModelConfig, probs: torch.Tensor, gate_idx: torch.Tensor,
         rows=None) -> torch.Tensor:
    """The Switch load-balance auxiliary loss, E * mean(mean_prob *
    mean_assign1), the means over every token of probs (..., E) and
    gate_idx (..., K). With ``rows`` ((mesh, axes): these are one rank's
    tokens of a batch split over ``axes``, each rank as many) the two
    E-vectors are the means over the ranks of the ranks' means
    (``comm.mean_over``: its backward of g/n, with the step's one sum of
    the gradients over the batch axes, gives the whole batch's)."""
    m = cfg.moe
    E = m.num_experts
    lead = tuple(range(probs.ndim - 1))
    assign1 = _one_hot(gate_idx[..., 0], E, torch.float32)
    mean_p, mean_a = probs.mean(dim=lead), assign1.mean(dim=lead)
    if rows is not None:
        mean_p, mean_a = comm.mean_over(torch.stack([mean_p, mean_a]),
                                        rows[1], rows[0]).unbind(0)
    return E * torch.mean(mean_p * mean_a) * m.aux_loss_coef


def _slots(cfg: ModelConfig, gate_idx: torch.Tensor) -> torch.Tensor:
    """The capacity slot of each choice of grouped tokens' expert choices
    gate_idx (B, S, K) in its expert's queue of its group: all k = 0
    choices first, then k = 1, ... (GShard priority), in token order.
    The running count runs along the last (contiguous) dim: a scan over
    the choices with the experts innermost is a slow kernel."""
    B, S, K = gate_idx.shape
    E = cfg.moe.num_experts
    choice = gate_idx.transpose(1, 2).reshape(B, 1, K * S)
    flat = (choice == torch.arange(E, device=gate_idx.device)[:, None]).to(
        torch.int32)                                                  # (B,E,KS)
    pos = torch.cumsum(flat, dim=-1, dtype=torch.int32) - flat
    pos = pos.reshape(B, E, K, S).permute(0, 3, 2, 1)                 # (B,S,K,E)
    return pos.gather(-1, gate_idx[..., None].long()).squeeze(-1)     # (B,S,K)


def _route(p, cfg: ModelConfig, x: torch.Tensor, layout=None):
    """Routing front-end shared by both dispatch paths.

    x: (B, S, d) grouped tokens, ``layout`` the layer's spec tree. Returns
    (gate_idx, gate_keep, pos_in_e, keep, C, aux): expert choice and
    capacity slot per (row, token, k), the kept (renormalized,
    capacity-masked) gates, and the Switch load-balance auxiliary loss."""
    C = capacity(cfg, x.shape[1])
    probs, gate_vals, gate_idx = _gates(p, cfg, x, layout)            # (B,S,K)
    aux = _aux(cfg, probs, gate_idx)
    pos_in_e = _slots(cfg, gate_idx)
    keep = pos_in_e < C                            # dropped beyond capacity
    gate_keep = gate_vals * keep.float()
    return gate_idx, gate_keep, pos_in_e, keep, C, aux


def group_size(tokens: int) -> int:
    """The dispatch group of a batch of ``tokens`` tokens, min(GROUP,
    tokens), as the reference reshapes it: a token count that is not a
    multiple of it raises (no padding)."""
    G = min(GROUP, tokens)
    if tokens % G:
        raise ValueError(f"MoE dispatch groups {tokens} tokens in groups "
                         f"of {G}: {tokens} is not a multiple of {G}")
    return G


def _route_rows(p, cfg: ModelConfig, x: torch.Tensor, mesh, axes,
                layout=None):
    """``_route`` for one rank's rows x (Bo, So, d) of a batch split over
    ``axes`` (each rank as many rows, in rank order: the train step's
    ``rank_batch``), routed as the unsharded layer routes the whole
    batch: the rank's probabilities and top-K here, the int32 choices
    all-gathered over ``axes`` (the whole batch's, in token order), the
    batch grouped as ``_regroup`` groups it and the capacity slots of
    each group the rank's tokens fall in counted over the whole group,
    the aux loss over the batch (``_aux``). Rows never move: the rank's
    tokens sit at offset ``lo`` of a slab of its groups' (Bg, G) token
    positions, the other ranks' positions 0 and never kept. Returns the
    slab (Bg, G, d), lo, then gate_idx ... aux of ``_route`` on it."""
    Bo, So, d = x.shape
    T_l = Bo * So
    xt = x.reshape(T_l, d)
    probs, gate_vals, gate_idx = _gates(p, cfg, xt, layout)           # (T_l,K)
    aux = _aux(cfg, probs, gate_idx, (mesh, axes))
    whole = comm.all_gather(gate_idx.to(torch.int32), axes, mesh, dim=0)
    T, K = whole.shape
    G = group_size(T)
    first = mesh.index(axes) * T_l
    g0, g1 = first // G, -(-(first + T_l) // G)
    Bg, lo = g1 - g0, first - g0 * G
    idx = whole[g0 * G:g1 * G].view(Bg, G, K)
    pos, C = _slots(cfg, idx), capacity(cfg, G)
    pad = (lo, Bg * G - lo - T_l)
    if any(pad):
        own = torch.zeros(Bg * G, dtype=torch.bool, device=x.device)
        own[lo:lo + T_l] = True
        own = own.view(Bg, G, 1)
        xt = torch.cat([xt.new_zeros(pad[0], d), xt,
                        xt.new_zeros(pad[1], d)])
        gate_vals = torch.cat([gate_vals.new_zeros(pad[0], K), gate_vals,
                               gate_vals.new_zeros(pad[1], K)])
        pos = torch.where(own, pos, C)
    keep = pos < C
    gate_keep = gate_vals.view(Bg, G, K) * keep.float()
    return (xt.view(Bg, G, d), lo, idx.long(), gate_keep, pos, keep, C,
            aux)


def _expert_ffn(p, xe: torch.Tensor, dt) -> torch.Tensor:
    """(E, N, d) -> (E, N, d) gated-silu expert FFN: per expert, one
    batched product over its N = B*C rows of every group."""
    up = torch.bmm(xe, p["w_up"].to(dt))
    gt = torch.bmm(xe, p["w_gate"].to(dt))
    h = F.silu(gt) * up
    return torch.bmm(h, p["w_down"].to(dt))


def _regroup(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(Bo, So, d) -> (tokens // G, G, d) with G = ``group_size(tokens)``."""
    Bo, So, d = x.shape
    G = group_size(Bo * So)
    return x.reshape(Bo * So // G, G, d)


def _expert_block(p, layout):
    """(mesh, first expert, experts) of this rank's experts when
    ``layout`` (the layer's spec tree under tp_serve or dp_tp) shards the
    expert leaves over 'model' (sharding/rules.py), else None. On their
    experts dim a rank holds a block of the experts; on their ffn dim
    (experts that do not divide over the ranks) it holds every expert's
    block of the ffn, and its products are partial sums just the same."""
    if layout is None or not any(layout["w_up"]):
        return None
    from repro_torch.models.layers import tp_mesh
    mesh = tp_mesh()
    El = p["w_up"].shape[0]
    if layout["w_up"][0] is None:
        return mesh, 0, El
    return mesh, mesh.index("model") * El, El


def apply_moe(p, cfg: ModelConfig, x: torch.Tensor, *, layout=None,
              rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss f32 scalar).

    Tokens are regrouped to (n_groups, GROUP, d); capacity is per group
    (GShard), so routing bookkeeping never crosses a group.

    With ``rows`` ((mesh, axes): x is this rank's block of the rows of a
    batch split over ``axes``, as a training strategy splits it) the
    tokens are routed as the whole batch's (``_route_rows``): the groups,
    capacity slots and aux are the unsharded layer's, and each rank
    dispatches and combines its own tokens only.

    With the experts over 'model' (``layout``, ``_expert_block``) every
    rank routes every token with the whole router, exactly as unsharded,
    and runs its own experts on the dispatch rows routed to them; its
    combine is a partial sum (the other experts' rows 0), which, with the
    shared expert's row-parallel partial, is summed over 'model' once in
    f32 (``comm.reduce_from``). For the backward the rows that enter the
    dispatch and the kept gates enter the rank's experts through
    ``comm.copy_to``, so that the input's and the router's gradients sum
    every rank's experts; the router and the aux are replicated compute
    and take no sum."""
    m = cfg.moe
    Bo, So, d = x.shape
    E, K = m.num_experts, m.experts_per_token
    xl = x.reshape(Bo * So, d)
    dt = x.dtype

    lo = 0
    if rows is None or rows[0].axis_size(rows[1]) == 1:
        x = _regroup(cfg, x)
        gate_idx, gate_keep, pos_in_e, keep, C, aux = _route(p, cfg, x, layout)
    else:
        x, lo, gate_idx, gate_keep, pos_in_e, keep, C, aux = _route_rows(
            p, cfg, x, *rows, layout)
    B, S = x.shape[:2]
    block = _expert_block(p, layout)
    if block is not None:
        x = comm.copy_to(x, "model", block[0])
        gate_keep = comm.copy_to(gate_keep, "model", block[0])
        # this rank's experts only: a choice of another rank's expert is
        # dropped here (its rows and gate 0), kept on its owner's rank
        e0, E = block[1], block[2]
        mine = (gate_idx >= e0) & (gate_idx < e0 + E)
        keep = keep & mine
        pos_in_e = torch.where(mine, pos_in_e, C)
        gate_keep = gate_keep * mine.float()
        gate_idx = (gate_idx - e0).clamp(0, E - 1)

    if m.dispatch == "einsum":
        # reference path: one-hot dispatch/combine einsums over the
        # whole (B,E,C,d) buffer; unrouted rows are dead stores
        onehot = _one_hot(gate_idx, E, torch.float32)                 # (B,S,K,E)
        slot_oh = _one_hot(pos_in_e, C, torch.float32)                # (B,S,K,C)
        disp = torch.einsum("bske,bskc->bsec", onehot, slot_oh)
        comb = torch.einsum("bske,bskc,bsk->bsec", onehot, slot_oh,
                            gate_keep)
        xin = torch.einsum("bsec,bsd->ebcd", disp.to(dt), x)          # (E,B,C,d)
        eout = _expert_ffn(p, xin.reshape(E, B * C, d), dt)
        out = torch.einsum("bsec,ebcd->bsd", comb.to(dt),
                           eout.view(E, B, C, d))                     # (B,S,d)
    else:
        # masked scatter: routed tokens land in their exact (expert,
        # group, slot) row of the experts' (E, B*C) input rows, dropped
        # ones in one spare row past them. The routed rows are unique
        # (top-K experts are distinct per token, slots distinct per
        # expert), so only routed rows are written.
        b_idx = torch.arange(B, device=x.device)[:, None, None]
        slot = (gate_idx * B + b_idx) * C + pos_in_e                  # (B,S,K)
        drop = ~keep
        buf = x.new_zeros((E * B * C + 1, d))
        buf.index_copy_(0, slot.masked_fill(drop, E * B * C).reshape(-1),
                        x[:, :, None, :].expand(B, S, K, d).reshape(-1, d))
        eout = _expert_ffn(p, buf[:-1].view(E, B * C, d), dt)
        # combine: gather each token's expert rows back (0 for the
        # dropped ones, the reference's mode="fill") and weight them by
        # the kept gates
        eg = eout.view(-1, d).index_select(
            0, slot.masked_fill(drop, 0).reshape(-1)).view(B, S, K, d)
        eg = eg.masked_fill(drop[..., None], 0)
        out = torch.matmul(gate_keep.to(dt)[..., None, :], eg).squeeze(-2)
    out = out.reshape(B * S, d)[lo:lo + Bo * So]           # this rank's tokens

    shared = None
    if m.shared_expert:
        sh = p["shared"]
        tp = None
        if layout is not None and any(layout["shared"]["down"]["w"]):
            # the shared expert's ffn is a block (column- then
            # row-parallel): its product is a partial sum, reduced with
            # the experts' one
            from repro_torch.models.layers import tp_mesh
            tp = tp_mesh()
            xl = comm.copy_to(xl, "model", tp)
        hs = F.silu(xl @ sh["gate"]["w"].to(dt)) * (xl @ sh["up"]["w"].to(dt))
        shared = hs @ sh["down"]["w"].to(dt)
        if tp is not None:
            if block is None:
                shared = comm.reduce_from(shared, "model", tp)
            else:
                out, shared = out + shared, None
    if block is not None:
        out = comm.reduce_from(out, "model", block[0])
    if shared is not None:
        out = out + shared

    return out.reshape(Bo, So, d), aux.float()


def dispatch_stats(p, cfg: ModelConfig, x: torch.Tensor) -> Dict[str, Any]:
    """The dead-expert-store waste of the dispatch buffer.

    Runs the routing front-end on real activations and counts (expert,
    slot) rows of the (B, E, C, d) dispatch buffer. Under
    ``dispatch="einsum"`` every row is stored, so unrouted rows are
    Def.-1 dead stores; under ``dispatch="scatter"`` only routed rows are
    written, so the dead fraction is exactly 0. Bytes are the activation
    dtype's itemsize x d_model per row."""
    m = cfg.moe
    d = x.shape[-1]
    xg = _regroup(cfg, x)
    B = xg.shape[0]
    _, _, _, keep, C, _ = _route(p, cfg, xg)

    rows_total = B * m.num_experts * C
    rows_routed = int(keep.sum())
    row_bytes = d * x.element_size()
    stored = rows_total if m.dispatch == "einsum" else rows_routed
    dead = stored - rows_routed
    return {
        "dispatch": m.dispatch,
        "rows_total": rows_total,
        "rows_routed": rows_routed,
        "rows_stored": stored,
        "dead_rows": dead,
        "dead_bytes": dead * row_bytes,
        "stored_bytes": stored * row_bytes,
        "dead_fraction": (dead / stored) if stored else 0.0,
    }
