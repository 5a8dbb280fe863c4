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
choice (GShard priority). ``jax.lax.top_k`` breaks ties toward the lower
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


def _route(p, cfg: ModelConfig, x: torch.Tensor):
    """Routing front-end shared by both dispatch paths.

    x: (B, S, d) grouped tokens. Returns (gate_idx, gate_keep, pos_in_e,
    keep, C, aux): expert choice and capacity slot per (row, token, k),
    the kept (renormalized, capacity-masked) gates, and the Switch
    load-balance auxiliary loss."""
    m = cfg.moe
    B, S = x.shape[:2]
    E, K = m.num_experts, m.experts_per_token
    C = capacity(cfg, S)

    logits = x.float() @ p["router"].float()                          # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)                             # (B,S,K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance auxiliary loss (Switch): E * sum(mean_prob * mean_assign)
    assign1 = _one_hot(gate_idx[..., 0], E, torch.float32)
    aux = E * torch.mean(probs.mean(dim=(0, 1))
                         * assign1.mean(dim=(0, 1))) * m.aux_loss_coef

    # capacity slot of each choice in its expert's queue: all k = 0
    # choices first, then k = 1, ... (GShard priority), in token order.
    # The running count runs along the last (contiguous) dim: a scan
    # over the choices with the experts innermost is a slow kernel
    choice = gate_idx.transpose(1, 2).reshape(B, 1, K * S)
    flat = (choice == torch.arange(E, device=x.device)[:, None]).to(
        torch.int32)                                                  # (B,E,KS)
    pos = torch.cumsum(flat, dim=-1, dtype=torch.int32) - flat
    pos = pos.reshape(B, E, K, S).permute(0, 3, 2, 1)                 # (B,S,K,E)
    pos_in_e = pos.gather(-1, gate_idx[..., None]).squeeze(-1)        # (B,S,K)
    keep = pos_in_e < C                            # dropped beyond capacity

    gate_keep = gate_vals * keep.float()
    return gate_idx, gate_keep, pos_in_e, keep, C, aux


def _expert_ffn(p, xe: torch.Tensor, dt) -> torch.Tensor:
    """(E, N, d) -> (E, N, d) gated-silu expert FFN: per expert, one
    batched product over its N = B*C rows of every group."""
    up = torch.bmm(xe, p["w_up"].to(dt))
    gt = torch.bmm(xe, p["w_gate"].to(dt))
    h = F.silu(gt) * up
    return torch.bmm(h, p["w_down"].to(dt))


def _regroup(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(Bo, So, d) -> (tokens // G, G, d) with G = min(GROUP, tokens), as
    the reference reshapes it: a token count that is not a multiple of G
    raises (no padding)."""
    Bo, So, d = x.shape
    tokens = Bo * So
    G = min(GROUP, tokens)
    if tokens % G:
        raise ValueError(f"MoE dispatch groups {tokens} tokens in groups "
                         f"of {G}: {tokens} is not a multiple of {G}")
    return x.reshape(tokens // G, G, d)


def apply_moe(p, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss f32 scalar).

    Tokens are regrouped to (n_groups, GROUP, d); capacity is per group
    (GShard), so routing bookkeeping never crosses a group."""
    m = cfg.moe
    Bo, So, d = x.shape
    E, K = m.num_experts, m.experts_per_token
    x = _regroup(cfg, x)
    B, S = x.shape[:2]
    dt = x.dtype

    gate_idx, gate_keep, pos_in_e, keep, C, aux = _route(p, cfg, x)

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
        rows = (gate_idx * B + b_idx) * C + pos_in_e                  # (B,S,K)
        drop = ~keep
        buf = x.new_zeros((E * B * C + 1, d))
        buf.index_copy_(0, rows.masked_fill(drop, E * B * C).reshape(-1),
                        x[:, :, None, :].expand(B, S, K, d).reshape(-1, d))
        eout = _expert_ffn(p, buf[:-1].view(E, B * C, d), dt)
        # combine: gather each token's expert rows back (0 for the
        # dropped ones, the reference's mode="fill") and weight them by
        # the kept gates
        eg = eout.view(-1, d).index_select(
            0, rows.masked_fill(drop, 0).reshape(-1)).view(B, S, K, d)
        eg = eg.masked_fill(drop[..., None], 0)
        out = torch.matmul(gate_keep.to(dt)[..., None, :], eg).squeeze(-2)

    if m.shared_expert:
        sh = p["shared"]
        hs = F.silu(x @ sh["gate"]["w"].to(dt)) * (x @ sh["up"]["w"].to(dt))
        out = out + hs @ sh["down"]["w"].to(dt)

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
