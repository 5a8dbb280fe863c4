"""Core transformer layers: norms, RoPE, GQA attention (qk-norm; self-
or cross-attention; cache-free, or a per-slot dense or paged KV cache),
gated/plain MLP, the dense and the gated cross-attention blocks, the LM
head. Functional style: ``decl_*`` builds the
parameter declaration tree, ``apply_*`` consumes the materialized
parameters (nested dicts of tensors).

Every weight is cast to the activation dtype at its use, as in the
reference.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import params as P
from repro_torch.sharding import comm
from repro_torch.sharding.ctx import current_sharder, shard


# ----------------------------------------------------------------------
# Tensor parallelism (tp_serve, and dp_tp training). Each rank holds the
# slice of every leaf that its spec gives it (sharding/rules.py); the
# reference lets GSPMD place the collectives, here each sits where GSPMD
# puts one: a column-parallel projection (a block of the output
# features) is all-gathered over 'model' where the next op needs every
# feature, a row-parallel one (a block of the input features) takes its
# block of the input and all-reduces its partial sum. A leaf's layout
# shows in its shape: a sharded dim is smaller than the config's. The
# collectives are the differentiable ones of sharding/comm.py, so the
# same branches train: a replicated input of a column block is copied
# into the region (its gradient all-reduced), a gathered output's
# gradient is cut to the rank's block. Without an active strategy of
# more than one 'model' rank, or under fsdp ('model' a batch axis: the
# weights are gathered whole and the compute is data-parallel), none of
# this runs.
# ----------------------------------------------------------------------
def tp_mesh():
    """The active sharder's mesh when it has more than one 'model' rank
    and 'model' is no batch axis, else None."""
    s = current_sharder()
    if (s is None or s.mesh.shape.get("model", 1) == 1
            or "model" in s.batch_axes):
        return None
    return s.mesh


def gather_cols(parts, mesh):
    """Full tensors from column blocks: each of ``parts`` (..., w_i) is
    this rank's block of a (..., n*w_i) tensor; one all-gather over
    'model' for all of them."""
    n = mesh.shape["model"]
    widths = [t.shape[-1] for t in parts]
    packed = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    g = comm.gather_from(packed, "model", mesh, dim=-1)
    g = g.reshape(g.shape[:-1] + (n, sum(widths)))
    outs = g.split(widths, dim=-1)
    return [o.reshape(o.shape[:-2] + (n * w,)) for o, w in zip(outs, widths)]


def tp_row(h: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """h (..., f) @ w for a w that may hold a block of its f input rows
    (row-parallel): the block's partial product all-reduced over
    'model'; a whole w is a plain product."""
    f, blk = h.shape[-1], w.shape[-2]
    if blk == f:
        return h @ w.to(h.dtype)
    y = comm.block_of(h, "model", mesh, dim=-1) @ w.to(h.dtype)
    return comm.reduce_from(y, "model", mesh)


def tp_cols(x: torch.Tensor, ws, fulls, mesh):
    """x @ w for each column-parallel w of ``ws`` (a w may hold a block of
    its ``fulls`` output features, or a block of its input rows), whole
    outputs, the blocks gathered in one collective."""
    outs, blocks, xc = [], [], None
    for w, full in zip(ws, fulls):
        if w.shape[-2] != x.shape[-1]:
            outs.append(tp_row(x, w, mesh))
            continue
        if w.shape[-1] != full:
            xc = comm.copy_to(x, "model", mesh) if xc is None else xc
            blocks.append(len(outs))
            outs.append(xc @ w.to(x.dtype))
        else:
            outs.append(x @ w.to(x.dtype))
    if blocks:
        whole = gather_cols([outs[i] for i in blocks], mesh)
        for i, t in zip(blocks, whole):
            outs[i] = t
    return outs


def tp_heads(x: torch.Tensor, ws, heads, head_dim: int, mesh):
    """This rank's block of the heads of x @ w for each w of ``ws`` (the
    Megatron layout: (B, S, heads // n, D) each): a block of w's output
    features is used as it is (x copied into the region), a whole or
    row-parallel w's output is cut to the rank's heads."""
    n = mesh.shape["model"]
    B, S, _ = x.shape
    outs, xc = [], None
    for w, h in zip(ws, heads):
        if w.shape[-2] == x.shape[-1] and w.shape[-1] != h * head_dim:
            xc = comm.copy_to(x, "model", mesh) if xc is None else xc
            y = xc @ w.to(x.dtype)
        else:
            y = comm.block_of(tp_row(x, w, mesh), "model", mesh, dim=-1)
        outs.append(y.reshape(B, S, h // n, head_dim))
    return outs


def whole_leaves(p, layout, mesh):
    """``p`` with every leaf that ``layout`` (the sub-block's spec tree,
    ``lm._layer_layout``) says is a block gathered whole: the recurrent
    blocks, which have no tensor-parallel branch, run on whole weights
    under tp_serve and dp_tp, each rank the whole block on its rows.
    The gather is ``comm.gather_from``: every 'model' rank runs the
    whole block on the same rows, so the whole gradient is the same on
    each and the backward keeps the rank's block with no sum. Its
    forward is the plain all-gather, so serving (no gradient) takes it
    too."""
    def leaf(t, spec):
        dims = [i for i, e in enumerate(spec) if e is not None]
        if not dims:
            return t
        return comm.gather_from(t, spec[dims[0]], mesh, dim=dims[0])
    from repro_torch.sharding.rules import map2
    return map2(leaf, p, layout)


# ----------------------------------------------------------------------
# Serving over more than one 'data' rank (tp_serve). The reference shards
# the slot batch over 'data' and keeps the KV cache replicated over it
# (sharding/rules.py: TpServe.cache_specs, paged_cache_specs). Here
# ``LM.decode_step`` runs the engine families' forward on this data
# rank's block of the slots inside ``data_rows``: an attention layer
# takes its slots' rows of the page tables, indices and dense K/V rows
# (the pool is whole), runs as it would on a batch of that size, then
# gathers the new K/V rows over 'data' and stores the other data ranks'
# rows too, so every rank's copy of the cache holds every slot's rows in
# the same step; an MoE layer routes the rows of every slot
# (``gather_rows``), since its capacity is per group of the whole
# batch's tokens, and a router's product of a few rows rounds otherwise
# than the whole batch's, whose bits the engine's must equal.
# ----------------------------------------------------------------------
_DATA_ROWS: contextvars.ContextVar = contextvars.ContextVar(
    "data_rows", default=None)


@contextlib.contextmanager
def data_rows(split):
    """Within: ``split`` = (mesh, data axes, first slot, slots a rank) of
    the forward that runs on this rank's block of the slots (None: the
    whole batch)."""
    tok = _DATA_ROWS.set(split)
    try:
        yield
    finally:
        _DATA_ROWS.reset(tok)


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The whole batch's rows of t (this data rank's block on dim 0),
    gathered over 'data' in rank order; t itself without a split."""
    split = _DATA_ROWS.get()
    if split is None:
        return t
    mesh, axes = split[0], split[1]
    return comm.all_gather(t.contiguous(), axes, mesh, dim=0)


def batch_rows():
    """(mesh, batch axes) when the active sharder's forward runs on this
    rank's block of the rows of a batch split over more than one rank
    without gathering them (the train and eval steps:
    ``Sharder.rank_rows``), else None. The MoE layer then routes the
    rank's tokens as the whole batch's."""
    s = current_sharder()
    if (s is None or not s.rank_rows
            or s.mesh.axis_size(s.batch_axes) == 1):
        return None
    return s.mesh, s.batch_axes


def local_rows(t: torch.Tensor) -> torch.Tensor:
    """This data rank's block of the rows of a whole-batch t."""
    split = _DATA_ROWS.get()
    if split is None:
        return t
    lo, n = split[2], split[3]
    return t[lo:lo + n]


def _local_cache(cache, lo: int, n: int):
    """One layer's cache as a batch of this rank's slots: its rows of the
    page table, the indices and the counters, and a dense cache's rows
    (views: stores land in the whole cache); the pool stays whole."""
    out = dict(cache)
    keys = ("pt", "idx", "kcnt") if "pt" in cache else ("k", "v", "idx")
    for key in keys:
        if key in cache and cache[key].ndim >= 1:
            out[key] = cache[key][lo:lo + n]
    return out


def _store_other_rows(full, k, v, S: int, spec, split) -> None:
    """Store the other data ranks' new K/V rows into this rank's copy of
    the cache (``full``: the layer's whole-batch cache, stores in place):
    one all-gather of k and v over 'data', then the rows of every slot
    but this rank's through the same rule the kernels store by (paged:
    the page table, localized to this rank's chunk of a chunked pool;
    dense: the rows at the index, clamped or, for a verify window,
    dropped past the extent; a chunked dense cache takes the rows of its
    positions)."""
    mesh, axes, lo, n = split
    kv = comm.all_gather(torch.stack([k, v]), axes, mesh, dim=1)
    idx = full["idx"].expand(kv.shape[1]).clone()      # every slot's
    mine = torch.zeros(idx.shape[0], dtype=torch.bool, device=idx.device)
    mine[lo:lo + n] = True
    if "pt" in full:
        pt = full["pt"]
        plan = _paged_plan(pt.shape[0], full)
        if plan is not None:
            from repro_torch.serve.flash_decode import _localize
            chunk = full["k"].shape[0]
            pt, _ = _localize(pt, mesh.index(plan[1]) * chunk, chunk)
        # this rank's slots take the idle sentinel: their stores drop
        idx = torch.where(mine, -(S + 1), idx)
        ops.paged_update(full["k"], full["v"], kv[0], kv[1], pt, idx)
        return
    from repro_torch.serve.flash_decode import store_dense_rows
    plan = _dense_plan(idx.shape[0])
    ck = full["k"]
    total, off = ck.shape[1], 0
    if plan is not None:
        total = ck.shape[1] * mesh.axis_size(plan[1])
        off = mesh.index(plan[1]) * ck.shape[1]
    store_dense_rows(ck, full["v"], kv[0], kv[1], idx, off=off, total=total,
                     spec=spec, rows=~mine)


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------
def apply_rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    scale = p["scale"]
    if scale.shape[-1] != x.shape[-1]:          # a rank's block (tp)
        scale = gather_cols([scale], tp_mesh())[0]
    return ops.rmsnorm(x, scale, eps)


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

    src = x if kv_src is None else kv_src
    Bk, Skv = src.shape[:2]
    tp = tp_mesh()
    if (tp is not None and cache is None and kv_src is None
            and H % tp.shape["model"] == 0
            and Hkv % tp.shape["model"] == 0):
        return _tp_self_attention(p, cfg, x, positions, causal, use_rope,
                                  kv_valid, tp), None
    if tp is None:
        q = (x @ p["wq"]["w"].to(dt)).reshape(B, S, H, D)
        k = (src @ p["wk"]["w"].to(dt)).reshape(Bk, Skv, Hkv, D)
        v = (src @ p["wv"]["w"].to(dt)).reshape(Bk, Skv, Hkv, D)
    elif kv_src is None:
        # q and the new K/V rows gathered whole (the reference's q_spec
        # keeps the heads whole: the chunked attention takes them all)
        q, k, v = tp_cols(x, [p[n]["w"] for n in ("wq", "wk", "wv")],
                          [H * D, Hkv * D, Hkv * D], tp)
        q, k, v = (q.reshape(B, S, H, D), k.reshape(B, S, Hkv, D),
                   v.reshape(B, S, Hkv, D))
    else:
        (q,) = tp_cols(x, [p["wq"]["w"]], [H * D], tp)
        k, v = tp_cols(src, [p["wk"]["w"], p["wv"]["w"]], [Hkv * D] * 2, tp)
        q = q.reshape(B, S, H, D)
        k, v = k.reshape(Bk, Skv, Hkv, D), v.reshape(Bk, Skv, Hkv, D)
    if cfg.qk_norm:
        q = apply_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = apply_rmsnorm(p["k_norm"], k, cfg.norm_eps)

    if cache is None:
        if use_rope and kv_src is None:
            pos = (positions if positions is not None
                   else torch.arange(S, device=x.device))
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        q, k, v = shard(q, "bshd"), shard(k, "bskv"), shard(v, "bskv")
        out = ops.attention(q, k, v, causal=causal and kv_src is None,
                            kv_valid=kv_valid)
        return _out_proj(out.reshape(B, S, H * D), p, tp), None

    full, split = None, _DATA_ROWS.get()
    if split is not None:
        full, cache = cache, _local_cache(cache, split[2], split[3])
    idx = cache["idx"]
    ar = torch.arange(S, device=x.device, dtype=idx.dtype)
    pos_q = idx[:, None] + ar[None, :] if idx.ndim == 1 else (idx + ar)[None]
    q = apply_rope(q, pos_q, cfg.rope_theta)
    k = apply_rope(k, pos_q, cfg.rope_theta)

    if "pt" in cache:
        counters = "kcnt" in cache
        plan = _paged_plan(full["pt"].shape[0] if full else B, cache)
        if plan is not None:
            # the pool is chunked by pages over the ranks: flash-decoding
            # (serve/flash_decode.py), B1 for a decode, B2's store mode
            # for a window (admission, overwrite verify), its defer mode
            # on a chunk for a rollback verify; the counters stay this
            # rank's (LM.decode_step makes them the pool's)
            from repro_torch.serve import flash_decode as FD
            kw = dict(mesh=current_sharder().mesh, batch_axes=plan[0],
                      seq_axes=plan[1])
            if spec == "defer":
                out = FD.defer_paged_attention_sharded(
                    q, k, v, cache["k"], cache["v"], cache["pt"], idx, **kw)
                new_cache = {**cache, "idx": idx + S, "win_k": k,
                             "win_v": v}
                if counters:
                    new_cache["kcnt"] = torch.zeros_like(cache["kcnt"])
            else:
                fn = (FD.decode_paged_attention_sharded if S == 1
                      else FD.verify_paged_attention_sharded)
                out, ck, cv, cnt = fn(q, k, v, cache["k"], cache["v"],
                                      cache["pt"], idx, tol=ops.COUNTER_TOL,
                                      **kw)
                new_cache = {**cache, "k": ck, "v": cv, "idx": idx + S}
                if counters:
                    new_cache["kcnt"] = cnt
        elif spec == "defer":
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
        if counters and plan is None:
            new_cache["kcnt"] = cnt
    elif _dense_plan(full["k"].shape[0] if full else B) is not None:
        # the dense cache is chunked by positions over the ranks
        from repro_torch.serve.flash_decode import decode_attention_sharded
        plan = _dense_plan(full["k"].shape[0] if full else B)
        out, _, _ = decode_attention_sharded(
            q, k, v, cache["k"], cache["v"], idx,
            mesh=current_sharder().mesh, batch_axes=plan[0],
            seq_axes=plan[1], spec=spec if idx.ndim == 1 else None)
        new_cache = {**cache, "idx": idx + S}
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
    if full is not None:
        # the layer's whole-batch cache back, with this rank's counters
        # and deferred window (LM.decode_step and commit_verify gather
        # them over 'data')
        if spec != "defer":
            _store_other_rows(full, k, v, S, spec, split)
        new_cache = {**full, **{key: new_cache[key] for key in
                                ("kcnt", "win_k", "win_v")
                                if key in new_cache},
                     "idx": full["idx"] + S}
    return _out_proj(out.reshape(B, S, H * D), p, tp), new_cache


def _tp_self_attention(p, cfg: ModelConfig, x: torch.Tensor, positions,
                       causal: bool, use_rope: bool, kv_valid, tp
                       ) -> torch.Tensor:
    """Cache-free self-attention on this rank's heads (the training
    forward under tp: the reference's Megatron layout, whose head
    sharding spreads from the column-sharded projections): q, k and v
    are never gathered, the q/k-norms, RoPE and the attention kernel run
    on the rank's Hq/n query heads over its Hkv/n kv heads (G as
    unsharded), and ``wo`` takes the rank's rows of its input features,
    its partial sum all-reduced."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = tp_heads(x, [p[n]["w"] for n in ("wq", "wk", "wv")],
                       [H, Hkv, Hkv], D, tp)
    if cfg.qk_norm:
        def norm(name, t):
            # a replicated scale applied to the rank's heads only: its
            # gradient is the sum of the ranks'
            scale = comm.copy_to(p[name]["scale"], "model", tp)
            return apply_rmsnorm({"scale": scale}, t, cfg.norm_eps)
        q, k = norm("q_norm", q), norm("k_norm", k)
    if use_rope:
        pos = (positions if positions is not None
               else torch.arange(S, device=x.device))
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = ops.attention(q, k, v, causal=causal, kv_valid=kv_valid)
    out = out.reshape(B, S, q.shape[2] * D)
    wo = p["wo"]["w"]
    if wo.shape[-2] != out.shape[-1]:           # a whole wo: its rows
        wo = comm.block_of(wo, "model", tp, dim=-2)
    return shard(comm.reduce_from(out @ wo.to(out.dtype), "model", tp),
                 "btd")


def _out_proj(out: torch.Tensor, p, tp) -> torch.Tensor:
    """The attention's output projection (row-parallel under tp)."""
    if tp is None:
        return out @ p["wo"]["w"].to(out.dtype)
    return shard(tp_row(out, p["wo"]["w"], tp), "btd")


def _paged_plan(B: int, cache):
    """flash_decode.paged_shard_plan of the pool allocated under the
    active sharder (its global page count), or None."""
    s = current_sharder()
    if s is None or s.pool_pages is None:
        return None
    from repro_torch.serve.flash_decode import paged_shard_plan
    return paged_shard_plan(s, B, s.pool_pages, cache["k"].shape[1])


def _dense_plan(B: int):
    """flash_decode.decode_shard_plan of the dense cache allocated under
    the active sharder (its global extent), or None."""
    s = current_sharder()
    if s is None or s.seq_len is None:
        return None
    from repro_torch.serve.flash_decode import decode_shard_plan
    return decode_shard_plan(s, B, s.seq_len)


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
    tp = tp_mesh()
    if tp is not None:
        return _tp_mlp(p, cfg, x, tp)
    h = x @ p["up"]["w"].to(dt)
    if cfg.gated_mlp:
        h = F.silu(x @ p["gate"]["w"].to(dt)) * h
    else:
        h = F.gelu(h, approximate="tanh")       # jax.nn.gelu's default
    return h @ p["down"]["w"].to(dt)


def _tp_mlp(p, cfg: ModelConfig, x: torch.Tensor, tp) -> torch.Tensor:
    """apply_mlp under tp: up and gate column-parallel, down row-parallel
    (its partial all-reduced), the activation on this rank's block of
    the hidden features; a whole leaf is used whole."""
    dt = x.dtype
    f = cfg.d_ff
    names = ("up", "gate") if cfg.gated_mlp else ("up",)
    ws = [p[n]["w"] for n in names]
    blockwise = (all(w.shape[-1] != f and w.shape[-2] == x.shape[-1]
                     for w in ws) and p["down"]["w"].shape[-2] != f)
    if blockwise:
        xc = comm.copy_to(x, "model", tp)
        hs = [xc @ w.to(dt) for w in ws]
    else:
        hs = tp_cols(x, ws, [f] * len(ws), tp)
    h = F.silu(hs[1]) * hs[0] if cfg.gated_mlp else \
        F.gelu(hs[0], approximate="tanh")
    if blockwise:
        return shard(comm.reduce_from(h @ p["down"]["w"].to(dt), "model",
                                      tp), "btd")
    return shard(tp_row(h, p["down"]["w"], tp), "btd")


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
# Cross-attention block (the vlm family's image layers): (rmsnorm ->
# cross-attn -> tanh-gated +res) (rmsnorm -> mlp -> tanh-gated +res)
# ----------------------------------------------------------------------
def decl_xattn_block(cfg: ModelConfig) -> Dict[str, Any]:
    """The gates are scalars initialised to zero, as in the reference: a
    freshly initialised block passes x through unchanged."""
    return {
        "ln1": P.norm(cfg.d_model),
        "xattn": decl_attention(cfg, cross=True),
        "gate_attn": P.ParamDecl((), (), "zeros"),
        "ln2": P.norm(cfg.d_model),
        "mlp": decl_mlp(cfg),
        "gate_mlp": P.ParamDecl((), (), "zeros"),
    }


def gated_residual(x: torch.Tensor, gate: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """x + tanh(gate) * h, the gate cast to x's dtype first."""
    return x + torch.tanh(gate.to(x.dtype)) * h


def apply_xattn_block(p, cfg: ModelConfig, x: torch.Tensor,
                      kv_src: torch.Tensor) -> torch.Tensor:
    """Cache-free: the tokens x (B,S,d) attend the image tokens kv_src
    (B,Skv,d), non-causal, without RoPE."""
    h, _ = apply_attention(p["xattn"], cfg,
                           apply_rmsnorm(p["ln1"], x, cfg.norm_eps),
                           kv_src=kv_src, causal=False, use_rope=False)
    x = gated_residual(x, p["gate_attn"], h)
    h = apply_mlp(p["mlp"], cfg, apply_rmsnorm(p["ln2"], x, cfg.norm_eps))
    return gated_residual(x, p["gate_mlp"], h)


# ----------------------------------------------------------------------
# LM head: x (B,S,d) against the vocab-major (V,d) weight -> (B,S,V)
# ----------------------------------------------------------------------
def lm_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.T


def tp_embed(w: torch.Tensor, tokens: torch.Tensor, dt, mesh,
             vocab: int) -> torch.Tensor:
    """Embedding lookup of a (V, d) table that may hold a block of its
    ``vocab`` rows (vocab-parallel: a masked local lookup, all-reduced
    over 'model', the one owner's row its only term)."""
    if w.shape[0] == vocab:
        return w[tokens.long()].to(dt)
    lo = mesh.index("model") * w.shape[0]
    t = tokens.long() - lo
    mine = (t >= 0) & (t < w.shape[0])
    rows = w[t.clamp(0, w.shape[0] - 1)].to(dt)
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return comm.reduce_from(rows, "model", mesh)


def tp_logits(x: torch.Tensor, w: torch.Tensor, mesh,
              vocab: int) -> torch.Tensor:
    """lm_head of a (V, d) head that may hold a block of its ``vocab``
    rows: this rank's logits block, all-gathered over 'model' (every
    logit whole before argmax and the detectors)."""
    if w.shape[0] != vocab:
        return gather_cols([lm_head(x, w)], mesh)[0]
    return lm_head(x, w)
