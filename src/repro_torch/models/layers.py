"""Core transformer layers: norms, RoPE, GQA attention (qk-norm, per-slot
dense or paged KV cache), gated/plain MLP. Functional style: ``decl_*``
builds the parameter declaration tree, ``apply_*`` consumes the
materialized parameters (nested dicts of tensors).

Every weight is cast to the activation dtype at its use, as in the
reference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import params as P


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------
def apply_rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (S,) or (B, S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)      # (D/2,)
    ang = positions.float()[..., None] * freqs            # (..., S, D/2)
    if ang.ndim == 2:                                     # (S, D/2) -> (1, S, D/2)
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]                   # (B|1, S, 1, D/2)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------
def decl_attention(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    decl = {
        "wq": P.linear(d, cfg.q_dim, "embed", "q_feat"),
        "wk": P.linear(d, cfg.kv_dim, "embed", "kv_feat"),
        "wv": P.linear(d, cfg.kv_dim, "embed", "kv_feat"),
        "wo": P.linear(cfg.q_dim, d, "q_feat", "embed"),
    }
    if cfg.qk_norm:
        decl["q_norm"] = P.norm(cfg.head_dim, None)
        decl["k_norm"] = P.norm(cfg.head_dim, None)
    return decl


def apply_attention(p, cfg: ModelConfig, x: torch.Tensor, *,
                    cache: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Self-attention of S new tokens against a KV cache.

    cache (one layer's views of the stacked cache), one of:
      paged — {"k","v": (P,page,Hkv,D) pool, "pt": (B,M) page table,
               "idx": (B,) write positions[, "kcnt": (B,3) counters]}:
               stores go through the page table (idle/unmapped drop),
               S == 1 runs the paged decode kernel, S > 1 the paged
               window kernel in store mode;
      dense — {"k","v": (B,Smax,Hkv,D), "idx": scalar or (B,)}: each
               row writes its S rows at its own offset (clamped into the
               cache like the reference's dynamic_update_slice) and
               attends [0, idx+S).
    The cache tensors are written IN PLACE (they are views of the stacked
    cache); the returned cache holds the same tensors and idx + S.
    """
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype

    q = (x @ p["wq"]["w"].to(dt)).reshape(B, S, H, D)
    k = (x @ p["wk"]["w"].to(dt)).reshape(B, S, Hkv, D)
    v = (x @ p["wv"]["w"].to(dt)).reshape(B, S, Hkv, D)
    if cfg.qk_norm:
        q = apply_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = apply_rmsnorm(p["k_norm"], k, cfg.norm_eps)

    idx = cache["idx"]
    ar = torch.arange(S, device=x.device, dtype=idx.dtype)
    pos_q = idx[:, None] + ar[None, :] if idx.ndim == 1 else (idx + ar)[None]
    q = apply_rope(q, pos_q, cfg.rope_theta)
    k = apply_rope(k, pos_q, cfg.rope_theta)

    if "pt" in cache:
        counters = "kcnt" in cache
        if S == 1:
            out, ck, cv, cnt = ops.paged_decode(
                q, k, v, cache["k"], cache["v"], cache["pt"], idx,
                counters=counters)
        else:
            out, ck, cv, cnt = ops.paged_window(
                q, k, v, cache["k"], cache["v"], cache["pt"], idx,
                store=True, counters=counters)
        new_cache = {**cache, "k": ck, "v": cv, "idx": idx + S}
        if counters:
            new_cache["kcnt"] = cnt
    else:
        ck, cv = cache["k"], cache["v"]
        start = idx.clamp(0, ck.shape[1] - S).expand(B)
        rows = start[:, None].long() + ar[None, :].long()           # (B,S)
        bidx = torch.arange(B, device=x.device)[:, None]
        ck[bidx, rows] = k.to(ck.dtype)
        cv[bidx, rows] = v.to(cv.dtype)
        new_cache = {**cache, "idx": idx + S}
        out = ops.attention(q, ck.to(dt), cv.to(dt), causal=True,
                            q_offset=idx, kv_len=idx + S)
    out = out.reshape(B, S, H * D) @ p["wo"]["w"].to(dt)
    return out, new_cache


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------
def decl_mlp(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, Any]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    decl = {
        "up": P.linear(d, f, "embed", "ffn"),
        "down": P.linear(f, d, "ffn", "embed"),
    }
    if cfg.gated_mlp:
        decl["gate"] = P.linear(d, f, "embed", "ffn")
    return decl


def apply_mlp(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["up"]["w"].to(dt)
    if cfg.gated_mlp:
        h = F.silu(x @ p["gate"]["w"].to(dt)) * h
    else:
        h = F.gelu(h, approximate="tanh")       # jax.nn.gelu's default
    return h @ p["down"]["w"].to(dt)


# ----------------------------------------------------------------------
# Standard decoder block: (rmsnorm -> attn -> +res) (rmsnorm -> mlp -> +res)
# ----------------------------------------------------------------------
def decl_dense_block(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": P.norm(cfg.d_model),
        "attn": decl_attention(cfg),
        "ln2": P.norm(cfg.d_model),
        "mlp": decl_mlp(cfg),
    }


def apply_dense_block(p, cfg: ModelConfig, x: torch.Tensor, *, cache):
    h, new_cache = apply_attention(
        p["attn"], cfg, apply_rmsnorm(p["ln1"], x, cfg.norm_eps),
        cache=cache)
    x = x + h
    x = x + apply_mlp(p["mlp"], cfg, apply_rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x, new_cache
