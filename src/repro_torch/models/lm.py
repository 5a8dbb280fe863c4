"""Decoder LM assembly, dense, moe, hybrid, ssm and audio families:
parameter declaration and init, the cache-free training forward and
loss, per-slot dense and paged KV caches (and the hybrid family's Mamba2
states, the ssm family's mLSTM and sLSTM states, the audio family's
cross-attention K/V), and the cached decode step that the serving
engine's prefill and tick and the token-loop serving driver run.

Parameters and caches keep the reference's stacked per-layer storage,
``(n_layers, ...)`` under ``"main"``, so reference trees load 1:1; a
Python loop over the layers takes the place of the reference's
``lax.scan``. Each layer works on views of the stacked cache and writes
its K/V (dense rows or paged pool) in place — the reference's functional
update would cost a cache copy per call. The training forward takes each
stacked leaf apart once with ``unbind``, so autograd assembles a stacked
leaf's gradient from its layers in one stack. Under ``remat`` "full"
or "dots" each superblock of the training forward runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` around
its scanned superblock). The hybrid family (zamba2) runs `attn_period`
Mamba2 blocks and one use of a SHARED dense block per superblock, then
the leftover Mamba2 blocks as an un-checkpointed tail (``"tail"``); the
shared block has one parameter set (``"shared"``, its gradient summed
over its uses) and one K/V cache per use. The ssm family (xlstm) runs
superblocks of mLSTM blocks and one sLSTM block. The audio family
(whisper) runs an encoder over the frame embeddings (``"enc"``, never
checkpointed, as in the reference), then decoder blocks that attend
their own tokens and, across, the encoder's output; a decode reads the
cross-attention K/V that ``init_cache`` precomputed per layer.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import params as P
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL


def _mask_pad_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """-1e30 on the padded vocab tail (in place) so sampling never picks it."""
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name ("bfloat16", "float32") -> torch dtype."""
    return getattr(torch, name)


# ----------------------------------------------------------------------
# Schedule
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class Schedule:
    pattern: Tuple[str, ...]      # sub-block types within one superblock
    n_super: int
    tail: Tuple[str, ...] = ()    # leftover blocks after the superblocks
    has_shared: bool = False
    has_encoder: bool = False


def make_schedule(cfg: ModelConfig) -> Schedule:
    if cfg.family == "dense":
        return Schedule(("dense",), cfg.num_layers)
    if cfg.family == "moe":
        return Schedule(("moe",), cfg.num_layers)
    if cfg.family == "hybrid":
        p = cfg.attn_period
        n, r = divmod(cfg.num_layers, p)
        return Schedule(("mamba",) * p + ("shared",), n,
                        tail=("mamba",) * r, has_shared=True)
    if cfg.family == "ssm":
        sp = cfg.xlstm.slstm_period
        if cfg.num_layers % sp:
            raise ValueError(f"ssm layers ({cfg.num_layers}) must be a "
                             f"multiple of the sLSTM period ({sp})")
        return Schedule(("mlstm",) * (sp - 1) + ("slstm",),
                        cfg.num_layers // sp)
    if cfg.family == "audio":
        return Schedule(("encdec",), cfg.num_layers, has_encoder=True)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (dense, moe, hybrid, "
        f"ssm and audio only; the vlm blocks are ROADMAP A7)")


# ----------------------------------------------------------------------
# Sub-blocks
# ----------------------------------------------------------------------
def decl_moe_block(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": P.norm(cfg.d_model),
        "attn": L.decl_attention(cfg),
        "ln2": P.norm(cfg.d_model),
        "moe": M.decl_moe(cfg),
    }


def decl_encdec_block(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": P.norm(cfg.d_model),
        "attn": L.decl_attention(cfg),
        "lnx": P.norm(cfg.d_model),
        "xattn": L.decl_attention(cfg, cross=True),
        "ln2": P.norm(cfg.d_model),
        "mlp": L.decl_mlp(cfg),
    }


def _decl_sub(cfg: ModelConfig, typ: str) -> Dict[str, Any]:
    if typ == "dense":
        return L.decl_dense_block(cfg)
    if typ == "moe":
        return decl_moe_block(cfg)
    if typ == "mamba":
        return SSM.decl_mamba(cfg)
    if typ == "mlstm":
        return XL.decl_mlstm(cfg)
    if typ == "slstm":
        return XL.decl_slstm(cfg)
    if typ == "encdec":
        return decl_encdec_block(cfg)
    if typ == "shared":
        return {}                     # params live outside the superblocks
    raise ValueError(typ)


def _cached_xattn(p_attn, cfg: ModelConfig, x: torch.Tensor,
                  c: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Cross-attention of x (B,S,d) against one layer's precomputed
    cross K/V (``xk``/``xv``, masked by ``xvalid`` where the frames were
    right-padded). Unsharded: the sequence-sharded branch is ROADMAP
    A11."""
    B, S, _ = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    q = (x @ p_attn["wq"]["w"].to(x.dtype)).reshape(B, S, H, D)
    if cfg.qk_norm:
        q = L.apply_rmsnorm(p_attn["q_norm"], q, cfg.norm_eps)
    out = ops.attention(q, c["xk"].to(x.dtype), c["xv"].to(x.dtype),
                        causal=False, kv_valid=c.get("xvalid"))
    return out.reshape(B, S, H * D) @ p_attn["wo"]["w"].to(x.dtype)


def _apply_sub(p, cfg: ModelConfig, typ: str, x: torch.Tensor, *,
               cache=None, spec: Optional[str] = None,
               enc: Optional[torch.Tensor] = None):
    """One sub-block, cache-free or cached (as ``L.apply_attention``):
    (x, new cache, moe_aux or None). A moe block is attention, then the
    MoE layer on ln2; a mamba, mlstm or slstm block writes a given state
    in place; a shared block is a dense block on the shared parameters;
    an encdec block attends its tokens, then across to the encoder's
    output ``enc`` (cache-free) or to the cache's cross K/V, then runs
    its MLP."""
    if typ in ("dense", "shared"):
        x, nc = L.apply_dense_block(p, cfg, x, cache=cache, spec=spec)
        return x, nc, None
    if typ == "moe":
        h, nc = L.apply_attention(
            p["attn"], cfg, L.apply_rmsnorm(p["ln1"], x, cfg.norm_eps),
            cache=cache, spec=spec)
        x = x + h
        h, aux = M.apply_moe(p["moe"], cfg,
                             L.apply_rmsnorm(p["ln2"], x, cfg.norm_eps))
        return x + h, nc, aux
    if typ == "mamba":
        x, nc = SSM.apply_mamba(p, cfg, x, state=cache)
        return x, nc, None
    if typ == "mlstm":
        x, nc = XL.apply_mlstm(p, cfg, x, state=cache)
        return x, nc, None
    if typ == "slstm":
        x, nc = XL.apply_slstm(p, cfg, x, state=cache)
        return x, nc, None
    if typ == "encdec":
        h, nc = L.apply_attention(
            p["attn"], cfg, L.apply_rmsnorm(p["ln1"], x, cfg.norm_eps),
            cache=cache)
        x = x + h
        h = L.apply_rmsnorm(p["lnx"], x, cfg.norm_eps)
        if cache is None:
            h, _ = L.apply_attention(p["xattn"], cfg, h, kv_src=enc,
                                     causal=False, use_rope=False)
        else:
            h = _cached_xattn(p["xattn"], cfg, h, cache)
        x = x + h
        x = x + L.apply_mlp(p["mlp"], cfg,
                            L.apply_rmsnorm(p["ln2"], x, cfg.norm_eps))
        return x, nc, None
    raise ValueError(typ)


def _layer(tree, li: int):
    """Layer ``li`` of a stacked tree: views, no copies."""
    return P.tree_map(lambda t: t[li], tree)


def _save_dots(ctx, op, *args, **kwargs):
    """The "dots" policy, counterpart of the reference's
    ``checkpoint_dots_with_no_batch_dims``: keep the outputs of the 2-D
    projection matmuls, recompute everything else (norms, attention,
    activations: batched products and the kernels' own calls)."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


# ----------------------------------------------------------------------
# Model
# ----------------------------------------------------------------------
class LM:
    """Functional LM: holds config + schedule, params passed explicitly."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.sched = make_schedule(cfg)
        # activation checkpointing for each superblock of the training
        # forward: "none" | "full" | "dots" (set by the train-step factory)
        self.remat = "none"

    def _superblock(self, p_l, shared, x: torch.Tensor, aux: torch.Tensor,
                    enc: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        for i, typ in enumerate(self.sched.pattern):
            p = shared if typ == "shared" else p_l[f"b{i}_{typ}"]
            x, _, a = _apply_sub(p, self.cfg, typ, x, enc=enc)
            if a is not None:
                aux = aux + a
        return x, aux

    def _maybe_remat(self, p_l, shared, x: torch.Tensor, aux: torch.Tensor,
                     enc: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One superblock (with the encoder's output ``enc`` for the
        audio family's cross-attention), recomputed in the backward under
        "full" (saves nothing inside) or "dots" (saves the projection
        matmuls)."""
        if self.remat == "none" or not torch.is_grad_enabled():
            return self._superblock(p_l, shared, x, aux, enc)
        if self.remat == "full":
            ctx = ckpt.noop_context_fn
        elif self.remat == "dots":
            ctx = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                    _save_dots)
        else:
            raise ValueError(f"remat={self.remat!r}: none, full or dots")
        return ckpt.checkpoint(self._superblock, p_l, shared, x, aux, enc,
                               use_reentrant=False, context_fn=ctx)

    # -------------------------- declarations -------------------------
    def decl(self) -> Dict[str, Any]:
        cfg, sch = self.cfg, self.sched
        d = {
            "embed": P.ParamDecl((cfg.padded_vocab, cfg.d_model),
                                 ("vocab", "embed"), "normal", 0.02),
            "final_norm": P.norm(cfg.d_model),
            "main": P.stack_decls(
                {f"b{i}_{t}": _decl_sub(cfg, t)
                 for i, t in enumerate(sch.pattern) if t != "shared"},
                sch.n_super),
        }
        if not cfg.tie_embeddings:
            d["head"] = P.ParamDecl((cfg.padded_vocab, cfg.d_model),
                                    ("vocab", "embed"), "normal",
                                    1.0 / (cfg.d_model ** 0.5))
        if sch.tail:
            d["tail"] = P.stack_decls(_decl_sub(cfg, sch.tail[0]),
                                      len(sch.tail))
        if sch.has_shared:
            d["shared"] = L.decl_dense_block(cfg)
        if sch.has_encoder:
            d["enc"] = {
                "blocks": P.stack_decls(L.decl_dense_block(cfg),
                                        cfg.encoder_layers),
                "norm": P.norm(cfg.d_model),
            }
        return d

    def init(self, seed: int = 0, *, device, dtype=None) -> Any:
        """Random parameters on ``device`` from a seeded generator there
        (in ``cfg.param_dtype`` unless ``dtype`` is given)."""
        dtype = dtype or torch_dtype(self.cfg.param_dtype)
        gen = torch.Generator(device=device).manual_seed(seed)
        return P.init_tree(self.decl(), generator=gen, dtype=dtype,
                           device=device)

    def decode_params(self, params) -> Any:
        """The decode-path view of ``params``: without the encoder and
        each cross-attention's ``wk``/``wv``/``k_norm``, which only
        ``init_cache``'s cross-K/V precompute reads (the reference's
        view). Families without cross-attention get ``params`` back."""
        if not self.sched.has_encoder:
            return params
        out = {k: v for k, v in params.items() if k != "enc"}
        main = dict(out["main"])
        for name in (f"b{i}_{t}" for i, t in enumerate(self.sched.pattern)
                     if t == "encdec"):
            blk = dict(main[name])
            blk["xattn"] = {k: v for k, v in blk["xattn"].items()
                            if k not in ("wk", "wv", "k_norm")}
            main[name] = blk
        out["main"] = main
        return out

    def head_weight(self, params) -> torch.Tensor:
        """(V_padded, d) vocab-major head weight (embedding when tied)."""
        return (params["embed"] if self.cfg.tie_embeddings
                else params["head"])

    # ----------------------------- encoder ---------------------------
    def encode(self, params, frames: torch.Tensor,
               frame_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The audio family's encoder over frame embeddings (B,F,d):
        non-causal self-attention with RoPE in every block, then the
        encoder's norm. With ``frame_lengths`` ((B,) true frame counts of
        right-padded frames) padded keys are masked out of every
        self-attention, so rows below each true length do not depend on
        how far the batch was padded (what lets serving bucket the
        extent)."""
        cfg = self.cfg
        x = frames.to(torch_dtype(cfg.dtype))
        valid = None
        if frame_lengths is not None:
            valid = (torch.arange(x.shape[1], device=x.device)[None, :]
                     < frame_lengths.to(x.device)[:, None])
        blocks = P.tree_map(lambda t: t.unbind(0), params["enc"]["blocks"])
        for li in range(cfg.encoder_layers):
            x, _ = L.apply_dense_block(
                P.tree_map(lambda ts: ts[li], blocks), cfg, x, causal=False,
                kv_valid=valid)
        return L.apply_rmsnorm(params["enc"]["norm"], x, cfg.norm_eps)

    # ----------------------------- forward ---------------------------
    def backbone(self, params, tokens: torch.Tensor, *,
                 frames: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Everything up to (and incl.) the final norm, cache-free:
        (hidden (B,S,d), moe_aux f32 scalar: the MoE layers' aux losses
        summed over the layers, 0 for the dense family). The audio family
        needs ``frames`` (B,F,d), which its encoder runs over first."""
        cfg, sch = self.cfg, self.sched
        dt = torch_dtype(cfg.dtype)
        x = params["embed"][tokens.long()].to(dt)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        enc = None
        if sch.has_encoder:
            if frames is None:
                raise ValueError("the audio family needs frame embeddings")
            enc = self.encode(params, frames)
        layers = P.tree_map(lambda t: t.unbind(0), params["main"])
        shared = params.get("shared")
        for li in range(sch.n_super):
            x, aux = self._maybe_remat(
                P.tree_map(lambda ts: ts[li], layers), shared, x, aux, enc)
        if sch.tail:
            # the tail is not checkpointed, as in the reference
            tail = P.tree_map(lambda t: t.unbind(0), params["tail"])
            for li in range(len(sch.tail)):
                x, _, _ = _apply_sub(P.tree_map(lambda ts: ts[li], tail),
                                     cfg, sch.tail[li], x)
        x = L.apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return x, aux

    def forward(self, params, tokens: torch.Tensor, *,
                frames: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train/prefill forward: (logits (B,S,V_padded) with the padded
        vocab masked, moe_aux)."""
        x, aux = self.backbone(params, tokens, frames=frames)
        logits = L.lm_head(x, self.head_weight(params).to(x.dtype))
        return _mask_pad_vocab(logits, self.cfg), aux

    def loss(self, params, batch: Dict[str, torch.Tensor], *,
             z_loss: float = 0.0) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """LM loss of a batch {"tokens", "labels"} (B,S) int tensors (and
        "frames" (B,F,d) for the audio family): (nll + moe_aux, {"nll",
        "moe_aux"})."""
        from repro_torch.train.fused_xent import lm_loss
        x, aux = self.backbone(params, batch["tokens"],
                               frames=batch.get("frames"))
        w = self.head_weight(params)
        nll = lm_loss(x, w.to(x.dtype), batch["labels"], z_loss=z_loss)
        return nll + aux, {"nll": nll, "moe_aux": aux}

    # ------------------------------ caches ---------------------------
    def _init_sub_cache(self, typ: str, n: int, batch: int, max_len: int,
                        kv_dtype, dev) -> Dict[str, torch.Tensor]:
        """One sub-block's cache, stacked over ``n`` layers: K/V rows and
        a write index (attention blocks, one per use of the shared
        block; an encdec block's self-attention), or the Mamba2 conv and
        SSM states, or the mLSTM or sLSTM states."""
        init_state = {"mamba": functools.partial(SSM.init_mamba_state,
                                                 dtype=kv_dtype),
                      "mlstm": XL.init_mlstm_state,
                      "slstm": XL.init_slstm_state}.get(typ)
        if init_state is not None:
            st = init_state(self.cfg, batch, device=dev)
            return {k: t.expand((n,) + t.shape).clone()
                    for k, t in st.items()}
        Hkv, D = self.cfg.num_kv_heads, self.cfg.head_dim
        return {
            "k": torch.zeros((n, batch, max_len, Hkv, D), dtype=kv_dtype,
                             device=dev),
            "v": torch.zeros((n, batch, max_len, Hkv, D), dtype=kv_dtype,
                             device=dev),
            "idx": torch.zeros((n,), dtype=torch.int32, device=dev)}

    def init_cache(self, params, batch: int, max_len: int, *,
                   frames: Optional[torch.Tensor] = None,
                   frame_lengths: Optional[torch.Tensor] = None,
                   kv_dtype=torch.bfloat16) -> Any:
        """Dense per-slot decode cache: per layer (n_layers, batch,
        max_len, Hkv, D) K/V rows and a write index, or a recurrent
        block's states (``"tail"`` for the tail's).

        The audio family's blocks also carry the cross-attention K/V
        (``xk``/``xv``, (n_layers, batch, F, Hkv, D)), computed here
        from the encoder's output over ``frames`` (zeros of the
        capacity extent without frames). With ``frame_lengths`` ((B,)
        true counts of right-padded frames) the encoder masks padded
        keys and the cache carries ``xvalid`` ((n_layers, batch, F)), so
        a decode's cross-attention ignores them too."""
        sch = self.sched
        dev = params["embed"].device
        cache = {"main": {
            f"b{i}_{t}": self._init_sub_cache(t, sch.n_super, batch,
                                              max_len, kv_dtype, dev)
            for i, t in enumerate(sch.pattern)}}
        if sch.tail:
            cache["tail"] = self._init_sub_cache(
                sch.tail[0], len(sch.tail), batch, max_len, kv_dtype, dev)
        if sch.has_encoder:
            if frames is None:
                cfg = self.cfg
                shape = (sch.n_super, batch, cfg.encoder_frames,
                         cfg.num_kv_heads, cfg.head_dim)
                for sub in cache["main"].values():
                    sub["xk"] = torch.zeros(shape, dtype=kv_dtype, device=dev)
                    sub["xv"] = torch.zeros(shape, dtype=kv_dtype, device=dev)
            else:
                enc = self.encode(params, frames, frame_lengths)
                self._fill_cross_kv(params, cache, enc, frame_lengths,
                                    kv_dtype)
        return cache

    def _fill_cross_kv(self, params, cache, src: torch.Tensor,
                       src_lengths: Optional[torch.Tensor], kv_dtype
                       ) -> None:
        """Every encdec layer's cross K/V of ``src`` (B,F,d) into
        ``cache`` (a loop over the stacked layers in place of the
        reference's ``vmap``), and ``xvalid`` when ``src_lengths`` is
        given."""
        cfg, sch = self.cfg, self.sched
        Hkv, D = cfg.num_kv_heads, cfg.head_dim
        B, Skv = src.shape[:2]
        for i, t in enumerate(sch.pattern):
            if t != "encdec":
                continue
            name = f"b{i}_{t}"
            ap = params["main"][name]["xattn"]
            sub = cache["main"][name]
            xk = torch.empty((sch.n_super, B, Skv, Hkv, D), dtype=kv_dtype,
                             device=src.device)
            xv = torch.empty_like(xk)
            for li in range(sch.n_super):
                k = (src @ ap["wk"]["w"][li].to(src.dtype)).reshape(
                    B, Skv, Hkv, D)
                if cfg.qk_norm:
                    k = L.apply_rmsnorm(_layer(ap["k_norm"], li), k,
                                        cfg.norm_eps)
                xk[li] = k
                xv[li] = (src @ ap["wv"]["w"][li].to(src.dtype)).reshape(
                    B, Skv, Hkv, D)
            sub["xk"], sub["xv"] = xk, xv
            if src_lengths is not None:
                valid = (torch.arange(Skv, device=src.device)[None, :]
                         < src_lengths.to(src.device)[:, None])
                sub["xvalid"] = valid.expand((sch.n_super,) + valid.shape)

    def init_paged_cache(self, params, num_slots: int, max_len: int, *,
                         page_size: int = 16,
                         num_pages: Optional[int] = None,
                         kv_dtype=torch.bfloat16,
                         kernel_counters: bool = False) -> Any:
        """Block-paged decode cache (serve/kv_cache.py): per layer, one
        flat pool of `num_pages` pages of `page_size` K/V rows shared by
        all slots, plus a per-slot page table (-1 = unmapped) and per-slot
        write indices.

        ``kernel_counters=True`` adds a per-layer ``kcnt`` leaf
        ((num_slots, 3) int32 [stored, silent, dropped] element counts)
        that every paged attention forward overwrites with its store-site
        waste counters."""
        cfg, sch = self.cfg, self.sched
        dev = params["embed"].device
        n, Hkv, D = sch.n_super, cfg.num_kv_heads, cfg.head_dim
        max_pages = -(-max_len // page_size)
        if num_pages is None:
            num_pages = num_slots * max_pages
        main = {}
        for i, t in enumerate(sch.pattern):
            if t not in ("dense", "moe"):
                raise ValueError(
                    f"paged cache needs indexed KV in every sub-block; "
                    f"{t!r} blocks are unsupported")
            sub = {
                "k": torch.zeros((n, num_pages, page_size, Hkv, D),
                                 dtype=kv_dtype, device=dev),
                "v": torch.zeros((n, num_pages, page_size, Hkv, D),
                                 dtype=kv_dtype, device=dev),
                "idx": torch.zeros((n, num_slots), dtype=torch.int32,
                                   device=dev),
                "pt": torch.full((n, num_slots, max_pages), -1,
                                 dtype=torch.int32, device=dev),
            }
            if kernel_counters:
                sub["kcnt"] = torch.zeros((n, num_slots, 3),
                                          dtype=torch.int32, device=dev)
            main[f"b{i}_{t}"] = sub
        return {"main": main}

    @staticmethod
    def kernel_counters(cache) -> Optional[Dict[str, torch.Tensor]]:
        """The kernel-tier waste counters of the last paged forward, per
        sub-block name: (n_layers, num_slots, 3) int32 — or None when the
        cache was built without ``kernel_counters=True``."""
        out = {name: sub["kcnt"] for name, sub in cache["main"].items()
               if "kcnt" in sub}
        return out or None

    @staticmethod
    def cache_is_paged(cache) -> bool:
        return any("pt" in sub for sub in cache["main"].values())

    def _set_leaf(self, cache, key: str, value) -> Any:
        dev = next(iter(next(iter(cache["main"].values())).values())).device
        value = torch.as_tensor(value, dtype=torch.int32, device=dev)
        n = self.sched.n_super
        return {**cache, "main": {
            name: ({**sub, key: value.expand((n,) + value.shape)}
                   if key in sub else sub)
            for name, sub in cache["main"].items()}}

    def with_page_table(self, cache, pt) -> Any:
        """Return `cache` with every paged sub-block's page table replaced
        by `pt` ((num_slots, max_pages) int32, -1 = unmapped)."""
        return self._set_leaf(cache, "pt", pt)

    def cache_index(self, cache) -> torch.Tensor:
        """Current write index of the cache: scalar, or (B,) when the cache
        has per-slot positions (serving engine)."""
        for sub in cache["main"].values():
            if "idx" in sub:
                return sub["idx"][0]
        raise ValueError("cache has no indexed KV sub-block")

    def with_cache_index(self, cache, idx) -> Any:
        """Return `cache` with every KV sub-block's write index replaced by
        `idx` (scalar, or (B,) for per-slot serving positions)."""
        return self._set_leaf(cache, "idx", idx)

    # ------------------------------ decode ---------------------------
    def prefill(self, params, cache, tokens: torch.Tensor, *,
                lengths: Optional[torch.Tensor] = None):
        """Single-pass batched cache fill: one cached forward over the
        whole (B, P) prompt window. With ``lengths`` the write index is
        set per row. Returns (logits (B,P,V), cache)."""
        logits, cache = self.decode_step(params, cache, tokens)
        if lengths is not None:
            cache = self.with_cache_index(cache, lengths)
        return logits, cache

    # ------------------------- speculative verify --------------------
    def verify(self, params, cache, tokens: torch.Tensor, *,
               commit: bool = True):
        """Width-W speculative verify forward: tokens (B, W) = [last
        accepted token, draft_1 .. draft_{W-1}] at each slot's write
        index. One call gives the logits of all W positions (position j
        attends the committed history and window rows <= j).

        commit=True ("overwrite"): all W K/V rows are stored (bounded:
        rows past the extent drop); rows past the accept point are the
        Def.-1 dead stores ``rejected_draft_store`` measures.
        commit=False ("defer", paged caches): the pool is untouched and
        each sub-block carries the window K/V as ``win_k``/``win_v``
        for ``commit_verify`` to store only the accepted prefix."""
        return self.decode_step(params, cache, tokens,
                                spec="overwrite" if commit else "defer")

    def commit_verify(self, cache, start: torch.Tensor,
                      length: torch.Tensor) -> Any:
        """Store a deferred verify window's accepted prefix in the paged
        pool (in place): rows [0, length[b]) of each sub-block's
        win_k/win_v land at positions start[b]+s through the page table
        (length 0 = idle slot, nothing stored), all layers in one store.
        With kernel counters on, ``kcnt`` becomes this commit's
        [stored, silent, dropped] counts, measured against the pool
        before the store. Drops the win_* leaves."""
        new_main = {}
        for name, sub in cache["main"].items():
            if "win_k" not in sub:
                new_main[name] = sub
                continue
            n, P = sub["k"].shape[:2]
            B = sub["win_k"].shape[1]
            # every layer's pool as one pool of n*P pages, its table
            # shifted to the layer's pages
            pt = sub["pt"].long()
            off = (torch.arange(n, device=pt.device) * P)[:, None, None]
            pt_all = torch.where(pt >= 0, pt + off, -1).reshape(n * B, -1)
            pools = [sub[key].view((n * P,) + sub[key].shape[2:])
                     for key in ("k", "v")]
            wins = [sub[key].reshape((n * B,) + sub[key].shape[2:])
                    for key in ("win_k", "win_v")]
            start_all = start.repeat(n)
            length_all = torch.as_tensor(length, device=pt.device).repeat(n)
            out = {key: t for key, t in sub.items()
                   if key not in ("win_k", "win_v")}
            if "kcnt" in sub:
                # the rollback path's stores happen here, so here they
                # are counted: only accepted rows are ever stored
                out["kcnt"] = ops.paged_store_counts(
                    *pools, *wins, pt_all, start_all, length=length_all,
                    tol=ops.COUNTER_TOL).reshape(n, B, 3)
            ops.paged_update(*pools, *wins, pt_all, start_all,
                             length=length_all)
            new_main[name] = out
        return {**cache, "main": new_main}

    def decode_step(self, params, cache, tokens: torch.Tensor, *,
                    spec: Optional[str] = None):
        """One cached forward of tokens (B, S) at each row's write index.
        Returns (logits (B, S, V_padded), new cache); the new cache shares
        the K/V tensors of `cache` (written in place) and carries the
        advanced indices and, when enabled, this forward's counters.
        ``spec`` marks a speculative verify window (see ``verify``)."""
        cfg, sch = self.cfg, self.sched
        dt = torch_dtype(cfg.dtype)
        x = params["embed"][tokens.long()].to(dt)
        main = cache["main"]
        per_layer = {name: {} for name in main}
        for li in range(sch.n_super):
            p_l = _layer(params["main"], li)
            for i, typ in enumerate(sch.pattern):
                name = f"b{i}_{typ}"
                c = {key: t[li] for key, t in main[name].items()}
                p = params["shared"] if typ == "shared" else p_l[name]
                x, nc, _ = _apply_sub(p, cfg, typ, x, cache=c, spec=spec)
                for key in _PER_LAYER:
                    if key in nc:
                        per_layer[name].setdefault(key, []).append(nc[key])
        new_cache = {"main": {
            name: {**sub, **{key: torch.stack(ts) for key, ts in
                             per_layer[name].items()}}
            for name, sub in main.items()}}
        if sch.tail:
            # the tail's Mamba2 states are written in place
            for li, typ in enumerate(sch.tail):
                x, _, _ = _apply_sub(
                    _layer(params["tail"], li), cfg, typ, x,
                    cache={key: t[li] for key, t in cache["tail"].items()})
            new_cache["tail"] = cache["tail"]

        x = L.apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = L.lm_head(x, self.head_weight(params).to(dt))
        return _mask_pad_vocab(logits, cfg), new_cache


# the leaves a cached forward returns per layer, restacked over the
# layers: write indices, kernel counters, a deferred verify window's K/V
_PER_LAYER = ("idx", "kcnt", "win_k", "win_v")
