"""Decoder LM assembly, dense family: parameter declaration and init,
per-slot dense and paged KV caches, and the cached decode step that the
serving engine's prefill and tick run.

Parameters and caches keep the reference's stacked per-layer storage,
``(n_layers, ...)`` under ``"main"``, so reference trees load 1:1; a
Python loop over the layers takes the place of the reference's
``lax.scan``. Each layer works on views of the stacked cache and writes
its K/V (dense rows or paged pool) in place — the reference's functional
update would cost a cache copy per call.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import params as P


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


def make_schedule(cfg: ModelConfig) -> Schedule:
    if cfg.family == "dense":
        return Schedule(("dense",), cfg.num_layers)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (dense only)")


def _layer(tree, li: int):
    """Layer ``li`` of a stacked tree: views, no copies."""
    return P.tree_map(lambda t: t[li], tree)


# ----------------------------------------------------------------------
# Model
# ----------------------------------------------------------------------
class LM:
    """Functional LM: holds config + schedule, params passed explicitly."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.sched = make_schedule(cfg)

    # -------------------------- declarations -------------------------
    def decl(self) -> Dict[str, Any]:
        cfg, sch = self.cfg, self.sched
        d = {
            "embed": P.ParamDecl((cfg.padded_vocab, cfg.d_model),
                                 ("vocab", "embed"), "normal", 0.02),
            "final_norm": P.norm(cfg.d_model),
            "main": P.stack_decls(
                {f"b{i}_{t}": L.decl_dense_block(cfg)
                 for i, t in enumerate(sch.pattern)}, sch.n_super),
        }
        if not cfg.tie_embeddings:
            d["head"] = P.ParamDecl((cfg.padded_vocab, cfg.d_model),
                                    ("vocab", "embed"), "normal",
                                    1.0 / (cfg.d_model ** 0.5))
        return d

    def init(self, seed: int = 0, *, device, dtype=None) -> Any:
        """Random parameters on ``device`` from a seeded generator there
        (in ``cfg.param_dtype`` unless ``dtype`` is given)."""
        dtype = dtype or torch_dtype(self.cfg.param_dtype)
        gen = torch.Generator(device=device).manual_seed(seed)
        return P.init_tree(self.decl(), generator=gen, dtype=dtype,
                           device=device)

    def head_weight(self, params) -> torch.Tensor:
        """(V_padded, d) vocab-major head weight (embedding when tied)."""
        return (params["embed"] if self.cfg.tie_embeddings
                else params["head"])

    # ------------------------------ caches ---------------------------
    def init_cache(self, params, batch: int, max_len: int, *,
                   kv_dtype=torch.bfloat16) -> Any:
        """Dense per-slot decode cache: (n_layers, batch, max_len, Hkv, D)
        K/V rows and a write index per layer."""
        cfg, sch = self.cfg, self.sched
        dev = params["embed"].device
        n, Hkv, D = sch.n_super, cfg.num_kv_heads, cfg.head_dim
        main = {f"b{i}_{t}": {
            "k": torch.zeros((n, batch, max_len, Hkv, D), dtype=kv_dtype,
                             device=dev),
            "v": torch.zeros((n, batch, max_len, Hkv, D), dtype=kv_dtype,
                             device=dev),
            "idx": torch.zeros((n,), dtype=torch.int32, device=dev)}
            for i, t in enumerate(sch.pattern)}
        return {"main": main}

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
        dev = next(iter(cache["main"].values()))["k"].device
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

    def decode_step(self, params, cache, tokens: torch.Tensor):
        """One cached forward of tokens (B, S) at each row's write index.
        Returns (logits (B, S, V_padded), new cache); the new cache shares
        the K/V tensors of `cache` (written in place) and carries the
        advanced indices and, when enabled, this forward's counters."""
        cfg, sch = self.cfg, self.sched
        dt = torch_dtype(cfg.dtype)
        x = params["embed"][tokens.long()].to(dt)
        main = cache["main"]
        idxs = {name: [] for name in main}
        cnts = {name: [] for name in main if "kcnt" in main[name]}
        for li in range(sch.n_super):
            p_l = _layer(params["main"], li)
            for i, typ in enumerate(sch.pattern):
                name = f"b{i}_{typ}"
                c = {key: t[li] for key, t in main[name].items()}
                x, nc = L.apply_dense_block(p_l[name], cfg, x, cache=c)
                idxs[name].append(nc["idx"])
                if name in cnts:
                    cnts[name].append(nc["kcnt"])
        new_main = {}
        for name, sub in main.items():
            new_main[name] = {**sub, "idx": torch.stack(idxs[name])}
            if name in cnts:
                new_main[name]["kcnt"] = torch.stack(cnts[name])

        x = L.apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = x @ self.head_weight(params).to(dt).T
        return _mask_pad_vocab(logits, cfg), {"main": new_main}
