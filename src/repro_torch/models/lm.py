"""Decoder LM assembly, dense, moe, vlm, hybrid, ssm and audio families:
parameter declaration and init, the cache-free training forward and
loss, per-slot dense and paged KV caches (and the hybrid family's Mamba2
states, the ssm family's mLSTM and sLSTM states, the vlm and audio
families' cross-attention K/V), and the cached decode step that the
serving engine's prefill and tick and the token-loop serving driver run.

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
cross-attention K/V that ``init_cache`` precomputed per layer. The vlm
family (llama-3.2-vision) runs superblocks of `cross_attn_period - 1`
dense blocks and one gated cross-attention block over the image tokens
(``img``, stubbed patch embeddings); its cross K/V are precomputed the
same way, and its cache holds nothing else for those blocks.
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
from repro_torch.sharding import comm
from repro_torch.sharding.ctx import current_sharder, shard, sharding_ctx


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
    if cfg.family == "vlm":
        p = cfg.cross_attn_period
        if p < 1 or cfg.num_layers % p:
            raise ValueError(f"vlm layers ({cfg.num_layers}) must be a "
                             f"multiple of the cross-attention period ({p})")
        return Schedule(("dense",) * (p - 1) + ("xattn",),
                        cfg.num_layers // p)
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
    raise ValueError(f"unknown family {cfg.family!r}")


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
    if typ == "xattn":
        return L.decl_xattn_block(cfg)
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
    right-padded). Where the cross K/V were filled in chunks over the
    ranks (``_fill_cross_kv``: a plan of ``decode_shard_plan`` for the
    whole extent, and no ``xvalid``), each rank attends its chunk and the
    partials combine (``flash_decode.cross_attention_sharded``, plain
    PyTorch as the reference's body is), as the reference does; the
    projections are tensor-parallel where their leaves are blocks."""
    B, S, _ = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    tp = L.tp_mesh()
    if tp is None:
        q = x @ p_attn["wq"]["w"].to(x.dtype)
    else:
        (q,) = L.tp_cols(x, [p_attn["wq"]["w"]], [H * D], tp)
    q = q.reshape(B, S, H, D)
    if cfg.qk_norm:
        q = L.apply_rmsnorm(p_attn["q_norm"], q, cfg.norm_eps)
    s = current_sharder()
    plan = None
    if s is not None and s.cross_len is not None and "xvalid" not in c:
        from repro_torch.serve.flash_decode import decode_shard_plan
        plan = decode_shard_plan(s, B, s.cross_len)
    if plan is not None:
        from repro_torch.serve.flash_decode import cross_attention_sharded
        out = cross_attention_sharded(q, c["xk"], c["xv"], mesh=s.mesh,
                                      batch_axes=plan[0], seq_axes=plan[1])
    else:
        out = ops.attention(q, c["xk"].to(x.dtype), c["xv"].to(x.dtype),
                            causal=False, kv_valid=c.get("xvalid"))
    return L._out_proj(out.reshape(B, S, H * D), p_attn, tp)


def _layer_layout(*path):
    """The spec tree of one layer of the stacked params at ``path`` (as
    ("main", "b0_moe")) as the steps hold them: the tree that
    ``serve.decode.shard_params`` or the train and eval step factories
    bound on the sharder, its layer dim dropped; None without one
    (unsharded, no tensor-parallel 'model', or a strategy that bound
    none)."""
    s = current_sharder()
    if s is None or s.param_specs is None or L.tp_mesh() is None:
        return None
    tree = s.param_specs
    for key in path:
        tree = tree[key]
    return P.tree_map(lambda spec: tuple(spec)[1:], tree)


def _apply_sub(p, cfg: ModelConfig, typ: str, x: torch.Tensor, *,
               cache=None, spec: Optional[str] = None,
               src: Optional[torch.Tensor] = None, layout=None):
    """One sub-block, cache-free or cached (as ``L.apply_attention``):
    (x, new cache, moe_aux or None). A moe block is attention, then the
    MoE layer on ln2; a mamba, mlstm or slstm block writes a given state
    in place; a shared block is a dense block on the shared parameters;
    an encdec block attends its tokens, then across to the encoder's
    output ``src`` (cache-free) or to the cache's cross K/V, then runs
    its MLP; an xattn block attends across to the image tokens ``src``
    (cache-free) or to the cache's cross K/V, each half behind its tanh
    gate, and leaves the cache as it was. ``layout`` is the sub-block's
    spec tree under tp_serve or dp_tp (``_layer_layout``): the MoE layer
    runs a rank's block of the experts, a recurrent block gathers its
    blocks whole. Where each rank's forward holds its block of the
    batch's rows (``L.batch_rows``) the MoE layer routes them as the
    whole batch's."""
    if typ in ("dense", "shared"):
        x, nc = L.apply_dense_block(p, cfg, x, cache=cache, spec=spec)
        return x, nc, None
    if typ == "moe":
        h, nc = L.apply_attention(
            p["attn"], cfg, L.apply_rmsnorm(p["ln1"], x, cfg.norm_eps),
            cache=cache, spec=spec)
        x = x + h
        # a serving 'data' rank routes every slot's rows (L.data_rows), a
        # train or eval step its own as the whole batch's (L.batch_rows)
        h, aux = M.apply_moe(p["moe"], cfg, L.gather_rows(
            L.apply_rmsnorm(p["ln2"], x, cfg.norm_eps)),
            layout=None if layout is None else layout["moe"],
            rows=L.batch_rows())
        return x + L.local_rows(h), nc, aux
    if typ == "xattn":
        if cache is None:
            return L.apply_xattn_block(p, cfg, x, src), None, None
        h = _cached_xattn(p["xattn"], cfg,
                          L.apply_rmsnorm(p["ln1"], x, cfg.norm_eps), cache)
        x = L.gated_residual(x, p["gate_attn"], h)
        h = L.apply_mlp(p["mlp"], cfg,
                        L.apply_rmsnorm(p["ln2"], x, cfg.norm_eps))
        return L.gated_residual(x, p["gate_mlp"], h), cache, None
    if typ in ("mamba", "mlstm", "slstm") and layout is not None:
        p = L.whole_leaves(p, layout, L.tp_mesh())
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
            h, _ = L.apply_attention(p["xattn"], cfg, h, kv_src=src,
                                     causal=False, use_rope=False)
        else:
            h = _cached_xattn(p["xattn"], cfg, h, cache)
        x = x + h
        x = x + L.apply_mlp(p["mlp"], cfg,
                            L.apply_rmsnorm(p["ln2"], x, cfg.norm_eps))
        return x, nc, None
    raise ValueError(typ)


def _fsdp_mesh():
    """The active sharder's mesh when its weights are fsdp-sharded
    ('model' a batch axis: each rank computes on whole weights, gathered
    at use) over more than one rank, else None."""
    s = current_sharder()
    if s is None or "model" not in s.batch_axes or s.mesh.size == 1:
        return None
    return s.mesh


def _gather_leaf(t: torch.Tensor, spec, whole, mesh) -> torch.Tensor:
    """A rank's block of a fsdp-sharded leaf gathered whole (each sharded
    dim with ``comm.gather_weight``: the backward reduce-scatters its
    gradient); a leaf that is whole already is returned as it is."""
    if tuple(t.shape) == tuple(whole):
        return t
    for dim, entry in enumerate(tuple(spec)):
        if entry is not None:
            t = comm.gather_weight(t, entry, mesh, dim)
    return t


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
                    src: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        for i, typ in enumerate(self.sched.pattern):
            name = f"b{i}_{typ}"
            p, layout = ((shared, None) if typ == "shared" else
                         (p_l[name], _layer_layout("main", name)))
            x, _, a = _apply_sub(p, self.cfg, typ, x, src=src,
                                 layout=layout)
            if a is not None:
                aux = aux + a
        return x, aux

    def _maybe_remat(self, p_l, shared, x: torch.Tensor, aux: torch.Tensor,
                     src: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One superblock (with its cross-attention's source ``src``: the
        audio family's encoder output, the vlm family's image tokens),
        recomputed in the backward under "full" (saves nothing inside) or
        "dots" (saves the projection matmuls)."""
        if self.remat == "none" or not torch.is_grad_enabled():
            return self._superblock(p_l, shared, x, aux, src)
        if self.remat == "full":
            ctx = ckpt.noop_context_fn
        elif self.remat == "dots":
            ctx = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                    _save_dots)
        else:
            raise ValueError(f"remat={self.remat!r}: none, full or dots")
        return ckpt.checkpoint(self._superblock, p_l, shared, x, aux, src,
                               use_reentrant=False, context_fn=_keep(ctx))

    # ---------------------------- fsdp ---------------------------------
    def _fsdp_plan(self, mesh):
        """Under fsdp on ``mesh``, each leaf's (spec, whole shape)
        (sharding/rules.py ``leaf_spec_fsdp``), and the same for one
        layer's views of the stacked leaves; cached per mesh shape."""
        key = tuple(sorted(mesh.shape.items()))
        plans = self.__dict__.setdefault("_fsdp_plans", {})
        if key not in plans:
            from repro_torch.sharding.rules import PS, Fsdp, map2
            plan = map2(lambda s, d: (s, d.shape),
                        Fsdp(mesh).param_specs(self), self.decl())
            layer = P.tree_map(lambda sw: (PS(*sw[0][1:]), sw[1][1:]),
                               plan["main"])
            plans[key] = plan, layer
        return plans[key]

    def gather_params(self, params, layer: bool = False):
        """Under fsdp, ``params`` with every top-level leaf except the
        stacked layers (``"main"``) gathered whole (the embedding, the
        head, the final norm, a tail, a shared block, an encoder); with
        ``layer`` and ``params`` one layer's views of the stacked leaves,
        that layer's leaves gathered (the layer loop does so just before
        each superblock). Otherwise ``params`` as they are."""
        mesh = _fsdp_mesh()
        if mesh is None:
            return params
        from repro_torch.sharding.rules import map2
        plan, layer_plan = self._fsdp_plan(mesh)

        def gather(tree, plan):
            return map2(lambda t, sw: _gather_leaf(t, *sw, mesh), tree, plan)
        if layer:
            return gather(params, layer_plan)
        return {k: v if k == "main" else gather(v, plan[k])
                for k, v in params.items()}

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

    def abstract_params(self, *, device, mode, dtype=None) -> Any:
        """Fake-tensor parameters matching ``init`` (``P.abstract_tree``,
        made under the fake-tensor ``mode``): the tree an abstract trace
        of a step takes at any width."""
        dtype = dtype or torch_dtype(self.cfg.param_dtype)
        return P.abstract_tree(self.decl(), dtype=dtype, device=device,
                               mode=mode)

    def param_axes(self) -> Any:
        """Logical axes of every parameter leaf (the spec trees' input)."""
        return P.axes_tree(self.decl())

    def _cross_blocks(self):
        """Names of the sub-blocks that attend across (encdec, xattn)."""
        return [f"b{i}_{t}" for i, t in enumerate(self.sched.pattern)
                if t in ("encdec", "xattn")]

    def decode_params(self, params) -> Any:
        """The decode-path view of ``params``: without the encoder and
        each cross-attention's ``wk``/``wv``/``k_norm``, which only
        ``init_cache``'s cross-K/V precompute reads (the reference's
        view). Families without cross-attention get ``params`` back."""
        cross = self._cross_blocks()
        if not cross and not self.sched.has_encoder:
            return params
        out = {k: v for k, v in params.items() if k != "enc"}
        main = dict(out["main"])
        for name in cross:
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

    def _embed(self, params, tokens: torch.Tensor, dt) -> torch.Tensor:
        """Token embeddings in ``dt``: vocab-parallel under tp."""
        tp = L.tp_mesh()
        if tp is None:
            return params["embed"][tokens.long()].to(dt)
        return L.tp_embed(params["embed"], tokens, dt, tp,
                          self.cfg.padded_vocab)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """The head's (B,S,V_padded) logits, every one whole (all-gathered
        over 'model' under tp); the padded vocab not yet masked."""
        w = self.head_weight(params).to(x.dtype)
        tp = L.tp_mesh()
        if tp is None:
            return L.lm_head(x, w)
        return L.tp_logits(x, w, tp, self.cfg.padded_vocab)

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
                 img: Optional[torch.Tensor] = None,
                 frames: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Everything up to (and incl.) the final norm, cache-free:
        (hidden (B,S,d), moe_aux f32 scalar: the MoE layers' aux losses
        summed over the layers, 0 for the dense family). The audio family
        needs ``frames`` (B,F,d), which its encoder runs over first; the
        vlm family needs ``img`` (B,N_img,d), cast to the activation
        dtype."""
        cfg, sch = self.cfg, self.sched
        dt = torch_dtype(cfg.dtype)
        params = self.gather_params(params)
        x = shard(self._embed(params, tokens, dt), "btd")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        src = None
        if sch.has_encoder:
            if frames is None:
                raise ValueError("the audio family needs frame embeddings")
            src = self.encode(params, frames)
        if cfg.family == "vlm":
            if img is None:
                raise ValueError("the vlm family needs image patch "
                                 "embeddings")
            src = img.to(dt)
        layers = P.tree_map(lambda t: t.unbind(0), params["main"])
        shared = params.get("shared")
        for li in range(sch.n_super):
            p_l = self.gather_params(P.tree_map(lambda ts: ts[li], layers),
                                     layer=True)
            x, aux = self._maybe_remat(p_l, shared, x, aux, src)
        if sch.tail:
            # the tail is not checkpointed, as in the reference
            tail = P.tree_map(lambda t: t.unbind(0), params["tail"])
            layout = _layer_layout("tail")
            for li in range(len(sch.tail)):
                x, _, _ = _apply_sub(P.tree_map(lambda ts: ts[li], tail),
                                     cfg, sch.tail[li], x, layout=layout)
        x = L.apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return x, aux

    def forward(self, params, tokens: torch.Tensor, *,
                img: Optional[torch.Tensor] = None,
                frames: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train/prefill forward: (logits (B,S,V_padded) with the padded
        vocab masked, moe_aux)."""
        params = self.gather_params(params)
        x, aux = self.backbone(params, tokens, img=img, frames=frames)
        logits = self._logits(params, x)
        return shard(_mask_pad_vocab(logits, self.cfg), "btv"), aux

    def loss(self, params, batch: Dict[str, torch.Tensor], *,
             z_loss: float = 0.0) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """LM loss of a batch {"tokens", "labels"} (B,S) int tensors (and
        "frames" (B,F,d) for the audio family, "img" (B,N_img,d) for the
        vlm family): (nll + moe_aux, {"nll", "moe_aux"}). Under a strategy
        (the active sharder) each rank passes its batch and its weights,
        and the loss is the whole batch's on every rank
        (``train/fused_xent.py:lm_loss``)."""
        from repro_torch.train.fused_xent import lm_loss
        params = self.gather_params(params)
        x, aux = self.backbone(params, batch["tokens"],
                               img=batch.get("img"),
                               frames=batch.get("frames"))
        w = self.head_weight(params)
        nll = lm_loss(x, w.to(x.dtype), batch["labels"], z_loss=z_loss,
                      sharder=current_sharder(), vocab=self.cfg.padded_vocab)
        return nll + aux, {"nll": nll, "moe_aux": aux}

    # ------------------------------ caches ---------------------------
    def _init_sub_cache(self, typ: str, n: int, batch: int, max_len: int,
                        kv_dtype, dev) -> Dict[str, torch.Tensor]:
        """One sub-block's cache, stacked over ``n`` layers: K/V rows and
        a write index (attention blocks, one per use of the shared
        block; an encdec block's self-attention), or the Mamba2 conv and
        SSM states, or the mLSTM or sLSTM states, or nothing for an
        xattn block (``init_cache`` adds its cross K/V)."""
        if typ == "xattn":
            return {}
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
                   img: Optional[torch.Tensor] = None,
                   frames: Optional[torch.Tensor] = None,
                   frame_lengths: Optional[torch.Tensor] = None,
                   kv_dtype=torch.bfloat16) -> Any:
        """Dense per-slot decode cache: per layer (n_layers, batch,
        max_len, Hkv, D) K/V rows and a write index, or a recurrent
        block's states (``"tail"`` for the tail's).

        The audio and vlm families' cross blocks also carry the
        cross-attention K/V (``xk``/``xv``, (n_layers, batch, F, Hkv,
        D)), computed here from the encoder's output over ``frames`` or
        from the image tokens ``img`` (B,N_img,d), cast to the activation
        dtype (zeros of the capacity extent without them). With
        ``frame_lengths`` ((B,) true counts of right-padded frames) the
        encoder masks padded keys and the cache carries ``xvalid``
        ((n_layers, batch, F)), so a decode's cross-attention ignores
        them too. The vlm family has no ``xvalid``: every image token is
        a key."""
        cfg, sch = self.cfg, self.sched
        dev = params["embed"].device
        _, local_len = self._cache_chunk(batch, max_len)
        cache = {"main": {
            f"b{i}_{t}": self._init_sub_cache(t, sch.n_super, batch,
                                              local_len, kv_dtype, dev)
            for i, t in enumerate(sch.pattern)}}
        if sch.tail:
            cache["tail"] = self._init_sub_cache(
                sch.tail[0], len(sch.tail), batch, max_len, kv_dtype, dev)
        src = None
        if sch.has_encoder and frames is not None:
            src = self.encode(params, frames, frame_lengths)
        elif cfg.family == "vlm" and img is not None:
            src = img.to(device=dev, dtype=torch_dtype(cfg.dtype))
        if src is not None:
            self._fill_cross_kv(params, cache, src, frame_lengths, kv_dtype)
        else:
            extent = (cfg.encoder_frames if sch.has_encoder
                      else cfg.num_image_tokens)
            _, extent = self._cache_chunk(batch, extent, "cross_len")
            shape = (sch.n_super, batch, extent, cfg.num_kv_heads,
                     cfg.head_dim)
            for name in self._cross_blocks():
                sub = cache["main"][name]
                sub["xk"] = torch.zeros(shape, dtype=kv_dtype, device=dev)
                sub["xv"] = torch.zeros(shape, dtype=kv_dtype, device=dev)
        return cache

    def _cache_chunk(self, batch: int, max_len: int, attr: str = "seq_len"
                     ) -> Tuple[int, int]:
        """(offset, positions) of a dense cache's extent ``max_len`` that
        this rank holds: under a strategy whose cache spec chunks the
        sequence (TpServe.cache_specs, the plan of
        flash_decode.decode_shard_plan) its chunk, else all of it; the
        whole extent is recorded on the sharder as ``attr``. Every
        attention sub-block's K/V (dense, moe, the hybrid's shared block,
        encdec self-attention, with ``attr`` "cross_len" the cross K/V)
        chunks so; recurrent states stay whole, as cache_specs leaves
        them."""
        s = current_sharder()
        if s is None:
            return 0, max_len
        from repro_torch.serve.flash_decode import decode_shard_plan
        plan = decode_shard_plan(s, batch, max_len)
        if plan is None:
            return 0, max_len
        s.bind_extent(attr, max_len)
        n = max_len // s.mesh.axis_size(plan[1])
        return s.mesh.index(plan[1]) * n, n

    def _fill_cross_kv(self, params, cache, src: torch.Tensor,
                       src_lengths: Optional[torch.Tensor], kv_dtype
                       ) -> None:
        """Every cross block's (encdec or xattn) cross K/V of ``src``
        (B,F,d) into ``cache`` (a loop over the stacked layers in place of
        the reference's ``vmap``), and ``xvalid`` when ``src_lengths`` is
        given."""
        cfg, sch = self.cfg, self.sched
        Hkv, D = cfg.num_kv_heads, cfg.head_dim
        B, Skv = src.shape[:2]
        mine = src
        if src_lengths is None:
            # a chunked cross cache: this rank's chunk of the frames or
            # image tokens (_cached_xattn attends it and combines)
            off, n = self._cache_chunk(B, Skv, "cross_len")
            mine = src[:, off:off + n]
        Sl = mine.shape[1]
        tp = L.tp_mesh()
        for name in self._cross_blocks():
            ap = params["main"][name]["xattn"]
            sub = cache["main"][name]
            xk = torch.empty((sch.n_super, B, Sl, Hkv, D), dtype=kv_dtype,
                             device=src.device)
            xv = torch.empty_like(xk)
            for li in range(sch.n_super):
                ws = [ap["wk"]["w"][li], ap["wv"]["w"][li]]
                if tp is None:
                    k, v = (mine @ w.to(src.dtype) for w in ws)
                else:
                    k, v = L.tp_cols(mine, ws, [Hkv * D] * 2, tp)
                k = k.reshape(B, Sl, Hkv, D)
                if cfg.qk_norm:
                    k = L.apply_rmsnorm(_layer(ap["k_norm"], li), k,
                                        cfg.norm_eps)
                xk[li] = k
                xv[li] = v.reshape(B, Sl, Hkv, D)
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
        # under a strategy that chunks the pool by pages (paged_cache_specs)
        # this rank holds its chunk, num_pages // n pages
        local = num_pages
        s = current_sharder()
        if s is not None:
            from repro_torch.serve.flash_decode import paged_shard_plan
            plan = paged_shard_plan(s, num_slots, num_pages, page_size)
            if plan is not None:
                s.bind_extent("pool_pages", num_pages)
                local = num_pages // s.mesh.axis_size(plan[1])
        main = {}
        for i, t in enumerate(sch.pattern):
            if t not in ("dense", "moe"):
                raise ValueError(
                    f"paged cache needs indexed KV in every sub-block; "
                    f"{t!r} blocks are unsupported")
            sub = {
                "k": torch.zeros((n, local, page_size, Hkv, D),
                                 dtype=kv_dtype, device=dev),
                "v": torch.zeros((n, local, page_size, Hkv, D),
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
        s = current_sharder()
        new_main = {}
        for name, sub in cache["main"].items():
            if "win_k" not in sub:
                new_main[name] = sub
                continue
            n, P = sub["k"].shape[:2]
            B = sub["pt"].shape[1]
            wins = {key: sub[key] for key in ("win_k", "win_v")}
            if sub["win_k"].shape[1] != B:
                # a data rank's window rows: every rank's copy of the pool
                # stores every slot's accepted rows (L.data_rows)
                both = comm.all_gather(torch.stack(list(wins.values())),
                                       s.batch_axes, s.mesh, dim=2)
                wins = {"win_k": both[0], "win_v": both[1]}
            pt = sub["pt"]
            plan = self._pool_plan(sub)
            if plan is not None:
                # a chunked pool: each rank stores the rows of its pages
                # through its localized table (flash_decode._localize)
                from repro_torch.serve.flash_decode import _localize
                pt, _ = _localize(pt, s.mesh.index(plan[1]) * P, P)
            # every layer's pool as one pool of n*P pages, its table
            # shifted to the layer's pages
            pt = pt.long()
            off = (torch.arange(n, device=pt.device) * P)[:, None, None]
            pt_all = torch.where(pt >= 0, pt + off, -1).reshape(n * B, -1)
            pools = [sub[key].view((n * P,) + sub[key].shape[2:])
                     for key in ("k", "v")]
            wins = [t.reshape((n * B,) + t.shape[2:])
                    for t in wins.values()]
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
                if plan is not None:
                    from repro_torch.serve.flash_decode import global_counts
                    out["kcnt"] = global_counts(
                        out["kcnt"], sub["pt"][0], start,
                        wins[0].shape[1], sub["k"].shape[2],
                        2 * sub["k"].shape[3] * sub["k"].shape[4], plan[1],
                        s.mesh, length=length_all[:B])
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
        split = self._data_split(tokens.shape[0])
        if split is not None:
            tokens = tokens[split[2]:split[2] + split[3]]
        x = shard(self._embed(params, tokens, dt), "btd_dec")
        main = cache["main"]
        per_layer = {name: {} for name in main}
        layouts = {name: None if name.endswith("_shared") else
                   _layer_layout("main", name) for name in main}
        with L.data_rows(split):
            for li in range(sch.n_super):
                p_l = _layer(params["main"], li)
                for i, typ in enumerate(sch.pattern):
                    name = f"b{i}_{typ}"
                    c = {key: t[li] for key, t in main[name].items()}
                    p = params["shared"] if typ == "shared" else p_l[name]
                    x, nc, _ = _apply_sub(p, cfg, typ, x, cache=c,
                                          spec=spec, layout=layouts[name])
                    for key in _PER_LAYER:
                        if key in nc:
                            per_layer[name].setdefault(key, []).append(
                                nc[key])
        new_cache = {"main": {
            name: {**sub, **{key: torch.stack(ts) for key, ts in
                             per_layer[name].items()}}
            for name, sub in main.items()}}
        self._pool_counts(cache, new_cache, tokens.shape[1], spec, split)
        if sch.tail:
            # the tail's Mamba2 states are written in place
            layout = _layer_layout("tail")
            for li, typ in enumerate(sch.tail):
                x, _, _ = _apply_sub(
                    _layer(params["tail"], li), cfg, typ, x,
                    cache={key: t[li] for key, t in cache["tail"].items()},
                    layout=layout)
            new_cache["tail"] = cache["tail"]

        x = L.apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = self._logits(params, x)
        if split is not None:
            logits = comm.all_gather(logits, split[1], split[0], dim=0)
        return _mask_pad_vocab(logits, cfg), new_cache

    def _data_split(self, B: int):
        """(mesh, data axes, first slot, slots a rank) when the active
        sharder serves the slot batch over more than one 'data' rank (the
        reference's batch spec: tp_serve with the batch divisible): the
        engine families' forward then runs on this rank's block of the
        slots (``L.data_rows``). None otherwise: the token-loop families,
        whose recurrent and cross states are whole-batch tensors, and a
        batch that does not divide, run the whole batch on every rank."""
        s = current_sharder()
        if (s is None or self.cfg.family not in ("dense", "moe")
                or "model" in s.batch_axes):
            return None
        n = s.mesh.axis_size(s.batch_axes)
        if n == 1 or B % n:
            return None
        return (s.mesh, s.batch_axes, s.mesh.index(s.batch_axes) * (B // n),
                B // n)

    def _pool_plan(self, sub):
        """flash_decode.paged_shard_plan of one paged sub-block's pool
        under the active sharder, or None when the pool is whole."""
        s = current_sharder()
        if s is None or s.pool_pages is None:
            return None
        from repro_torch.serve.flash_decode import paged_shard_plan
        return paged_shard_plan(s, sub["pt"].shape[1], s.pool_pages,
                                sub["k"].shape[2])

    def _pool_counts(self, cache, new_cache, S: int, spec, split) -> None:
        """Make ``kcnt`` the whole pool's, in place of new_cache's: over
        'data' ranks each counted its own slots (one all-gather), and
        under a page-chunked pool each rank's kernels counted their own
        chunk's stores (one all-reduce a forward, flash_decode.
        global_counts)."""
        s = current_sharder()
        if s is None or spec == "defer":
            return
        from repro_torch.serve.flash_decode import global_counts
        for name, sub in cache["main"].items():
            nsub = new_cache["main"][name]
            if "kcnt" not in nsub:
                continue
            if split is not None:
                nsub["kcnt"] = comm.all_gather(nsub["kcnt"], split[1],
                                               split[0], dim=1)
            plan = self._pool_plan(sub)
            if plan is None:
                continue
            ps = sub["k"].shape[2]
            row = 2 * sub["k"].shape[3] * sub["k"].shape[4]
            nsub["kcnt"] = global_counts(nsub["kcnt"], sub["pt"][0],
                                         sub["idx"][0], S, ps, row, plan[1],
                                         s.mesh)


# the leaves a cached forward returns per layer, restacked over the
# layers: write indices, kernel counters, a deferred verify window's K/V
_PER_LAYER = ("idx", "kcnt", "win_k", "win_v")


def _keep(context_fn):
    """A checkpoint's ``context_fn`` whose recompute also runs under the
    sharder active at the forward: autograd runs the backward of CUDA
    tensors on a device thread of its own, which does not see this
    thread's context variables, so a recomputed sharded superblock would
    take the unsharded branches."""
    import contextlib
    sharder = current_sharder()

    @contextlib.contextmanager
    def recompute(ctx):
        with ctx, sharding_ctx(sharder):
            yield

    def contexts():
        fwd, rec = context_fn()
        return fwd, recompute(rec)
    return contexts
