"""Decoder LM assembly, dense, moe and hybrid families: parameter
declaration and init, the cache-free training forward and loss, per-slot
dense and paged KV caches (and the hybrid family's Mamba2 states), and
the cached decode step that the serving engine's prefill and tick and the
token-loop serving driver run.

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
over its uses) and one K/V cache per use.
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
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (dense, moe and hybrid "
        f"only; the other block types are ROADMAP A7)")


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


def _decl_sub(cfg: ModelConfig, typ: str) -> Dict[str, Any]:
    if typ == "dense":
        return L.decl_dense_block(cfg)
    if typ == "moe":
        return decl_moe_block(cfg)
    if typ == "mamba":
        return SSM.decl_mamba(cfg)
    if typ == "shared":
        return {}                     # params live outside the superblocks
    raise ValueError(typ)


def _apply_sub(p, cfg: ModelConfig, typ: str, x: torch.Tensor, *,
               cache=None, spec: Optional[str] = None):
    """One sub-block, cache-free or cached (as ``L.apply_attention``):
    (x, new cache, moe_aux or None). A moe block is attention, then the
    MoE layer on ln2; a mamba block writes a given state in place; a
    shared block is a dense block on the shared parameters."""
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

    def _superblock(self, p_l, shared, x: torch.Tensor, aux: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        for i, typ in enumerate(self.sched.pattern):
            p = shared if typ == "shared" else p_l[f"b{i}_{typ}"]
            x, _, a = _apply_sub(p, self.cfg, typ, x)
            if a is not None:
                aux = aux + a
        return x, aux

    def _maybe_remat(self, p_l, shared, x: torch.Tensor, aux: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One superblock, recomputed in the backward under "full" (saves
        nothing inside) or "dots" (saves the projection matmuls)."""
        if self.remat == "none" or not torch.is_grad_enabled():
            return self._superblock(p_l, shared, x, aux)
        if self.remat == "full":
            ctx = ckpt.noop_context_fn
        elif self.remat == "dots":
            ctx = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                    _save_dots)
        else:
            raise ValueError(f"remat={self.remat!r}: none, full or dots")
        return ckpt.checkpoint(self._superblock, p_l, shared, x, aux,
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
        return d

    def init(self, seed: int = 0, *, device, dtype=None) -> Any:
        """Random parameters on ``device`` from a seeded generator there
        (in ``cfg.param_dtype`` unless ``dtype`` is given)."""
        dtype = dtype or torch_dtype(self.cfg.param_dtype)
        gen = torch.Generator(device=device).manual_seed(seed)
        return P.init_tree(self.decl(), generator=gen, dtype=dtype,
                           device=device)

    def decode_params(self, params) -> Any:
        """The decode-path view of ``params``: the reference strips the
        encoder and cross-attention K/V leaves that only its cache
        precompute reads; no ported family has them, so ``params`` comes
        back unchanged."""
        return params

    def head_weight(self, params) -> torch.Tensor:
        """(V_padded, d) vocab-major head weight (embedding when tied)."""
        return (params["embed"] if self.cfg.tie_embeddings
                else params["head"])

    # ----------------------------- forward ---------------------------
    def backbone(self, params, tokens: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Everything up to (and incl.) the final norm, cache-free:
        (hidden (B,S,d), moe_aux f32 scalar: the MoE layers' aux losses
        summed over the layers, 0 for the dense family)."""
        cfg, sch = self.cfg, self.sched
        dt = torch_dtype(cfg.dtype)
        x = params["embed"][tokens.long()].to(dt)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        layers = P.tree_map(lambda t: t.unbind(0), params["main"])
        shared = params.get("shared")
        for li in range(sch.n_super):
            x, aux = self._maybe_remat(
                P.tree_map(lambda ts: ts[li], layers), shared, x, aux)
        if sch.tail:
            # the tail is not checkpointed, as in the reference
            tail = P.tree_map(lambda t: t.unbind(0), params["tail"])
            for li in range(len(sch.tail)):
                x, _, _ = _apply_sub(P.tree_map(lambda ts: ts[li], tail),
                                     cfg, sch.tail[li], x)
        x = L.apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return x, aux

    def forward(self, params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Train/prefill forward: (logits (B,S,V_padded) with the padded
        vocab masked, moe_aux)."""
        x, aux = self.backbone(params, tokens)
        logits = L.lm_head(x, self.head_weight(params).to(x.dtype))
        return _mask_pad_vocab(logits, self.cfg), aux

    def loss(self, params, batch: Dict[str, torch.Tensor], *,
             z_loss: float = 0.0) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """LM loss of a batch {"tokens", "labels"} (B,S) int tensors:
        (nll + moe_aux, {"nll", "moe_aux"})."""
        from repro_torch.train.fused_xent import lm_loss
        x, aux = self.backbone(params, batch["tokens"])
        w = self.head_weight(params)
        nll = lm_loss(x, w.to(x.dtype), batch["labels"], z_loss=z_loss)
        return nll + aux, {"nll": nll, "moe_aux": aux}

    # ------------------------------ caches ---------------------------
    def _init_sub_cache(self, typ: str, n: int, batch: int, max_len: int,
                        kv_dtype, dev) -> Dict[str, torch.Tensor]:
        """One sub-block's cache, stacked over ``n`` layers: K/V rows and
        a write index (attention blocks, one per use of the shared
        block), or the Mamba2 conv and SSM states."""
        if typ == "mamba":
            st = SSM.init_mamba_state(self.cfg, batch, kv_dtype, device=dev)
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
                   kv_dtype=torch.bfloat16) -> Any:
        """Dense per-slot decode cache: per layer (n_layers, batch,
        max_len, Hkv, D) K/V rows and a write index, or a Mamba2 block's
        states (``"tail"`` for the tail's)."""
        sch = self.sched
        dev = params["embed"].device
        cache = {"main": {
            f"b{i}_{t}": self._init_sub_cache(t, sch.n_super, batch,
                                              max_len, kv_dtype, dev)
            for i, t in enumerate(sch.pattern)}}
        if sch.tail:
            cache["tail"] = self._init_sub_cache(
                sch.tail[0], len(sch.tail), batch, max_len, kv_dtype, dev)
        return cache

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
