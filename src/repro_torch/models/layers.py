"""Core transformer layers: norms, RoPE, GQA attention (qk-norm; self-
or cross-attention; cache-free, or a per-slot dense or paged KV cache),
gated/plain MLP, the LM head. Functional style: ``decl_*`` builds the
parameter declaration tree, ``apply_*`` consumes the materialized
parameters (nested dicts of tensors).

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
    return ops.rmsnorm(x, p["scale"], eps)


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
def decl_attention(cfg: ModelConfig, cross: bool = False) -> Dict[str, Any]:
    """Attention projections; a cross-attention (``cross``) declares the
    same leaves, its K/V projections reading the source instead."""
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
                    kv_src: Optional[torch.Tensor] = None,
                    positions: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    use_rope: bool = True,
                    spec: Optional[str] = None,
                    kv_valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Attention of S tokens: cache-free (the training forward, the
    encoder) or self-attention against a KV cache.

    cache None: the K/V come from the tokens themselves or, for a
      cross-attention, from ``kv_src`` (B,Skv,d); RoPE (``use_rope``, self-
      attention only) at ``positions`` (default 0..S-1); ``causal``
      applies to self-attention only; ``kv_valid`` ((B,Skv) bool) masks
      keys out, so rows of valid keys do not depend on how far the keys
      were padded. Unmasked, this is the flash kernel (causal or not,
      Sq != Skv for a cross-attention); masked, the plain composition,
      as in the reference. Returns (out, None).
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

    ``spec`` marks a speculative verify window (``LM.verify``):
      "overwrite" — all S window rows are stored, bounded: on the dense
          cache rows past the extent drop instead of clamping the window
          back onto committed history (paged stores drop past the table
          anyway); rows past the accept point are the Def.-1 dead stores
          ``rejected_draft_store`` measures;
      "defer" (paged) — the window kernel in defer mode: the pool is
          untouched, the counters are zero, and the window K/V ride in
          ``win_k``/``win_v`` for ``LM.commit_verify`` to store only the
          accepted prefix (rollback).
    """
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = x.dtype

    q = (x @ p["wq"]["w"].to(dt)).reshape(B, S, H, D)
    src = x if kv_src is None else kv_src
    Bk, Skv = src.shape[:2]
    k = (src @ p["wk"]["w"].to(dt)).reshape(Bk, Skv, Hkv, D)
    v = (src @ p["wv"]["w"].to(dt)).reshape(Bk, Skv, Hkv, D)
    if cfg.qk_norm:
        q = apply_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = apply_rmsnorm(p["k_norm"], k, cfg.norm_eps)

    if cache is None:
        if use_rope and kv_src is None:
            pos = (positions if positions is not None
                   else torch.arange(S, device=x.device))
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        out = ops.attention(q, k, v, causal=causal and kv_src is None,
                            kv_valid=kv_valid)
        return out.reshape(B, S, H * D) @ p["wo"]["w"].to(dt), None

    idx = cache["idx"]
    ar = torch.arange(S, device=x.device, dtype=idx.dtype)
    pos_q = idx[:, None] + ar[None, :] if idx.ndim == 1 else (idx + ar)[None]
    q = apply_rope(q, pos_q, cfg.rope_theta)
    k = apply_rope(k, pos_q, cfg.rope_theta)

    if "pt" in cache:
        counters = "kcnt" in cache
        if spec == "defer":
            # the pool is not written: the window rows are spliced into
            # the history after their pool-dtype round trip, so the
            # logits equal overwrite mode's bit for bit
            out, _, _, cnt = ops.paged_window(
                q, k, v, cache["k"], cache["v"], cache["pt"], idx,
                store=False, counters=counters)
            new_cache = {**cache, "idx": idx + S, "win_k": k, "win_v": v}
        else:
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
        bidx = torch.arange(B, device=x.device)[:, None].expand(B, S)
        if spec is not None and idx.ndim == 1:
            # a verify window: rows past the extent drop (only rejected
            # drafts and padding reach there), no clamp onto history
            pos = idx[:, None].long() + ar[None, :].long()         # (B,S)
            keep = (pos >= 0) & (pos < ck.shape[1])
            ck[bidx[keep], pos[keep]] = k[keep].to(ck.dtype)
            cv[bidx[keep], pos[keep]] = v[keep].to(cv.dtype)
        else:
            start = idx.clamp(0, ck.shape[1] - S).expand(B)
            rows = start[:, None].long() + ar[None, :].long()       # (B,S)
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


def apply_dense_block(p, cfg: ModelConfig, x: torch.Tensor, *,
                      causal: bool = True, cache=None,
                      positions: Optional[torch.Tensor] = None,
                      use_rope: bool = True, spec: Optional[str] = None,
                      kv_valid: Optional[torch.Tensor] = None):
    h, new_cache = apply_attention(
        p["attn"], cfg, apply_rmsnorm(p["ln1"], x, cfg.norm_eps),
        causal=causal, cache=cache, positions=positions, use_rope=use_rope,
        spec=spec, kv_valid=kv_valid)
    x = x + h
    x = x + apply_mlp(p["mlp"], cfg, apply_rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x, new_cache


# ----------------------------------------------------------------------
# LM head: x (B,S,d) against the vocab-major (V,d) weight -> (B,S,V)
# ----------------------------------------------------------------------
def lm_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.T
