"""Serve-step factories: the greedy one-token step over a dense cache
(the token-loop serving driver's), and the continuous-batching engine's
steps: one decode tick over the whole slot batch, one speculative verify
tick and the grouped admission prefill, over the dense or the paged KV
layout. The reference jits these factories; here they are plain calls
that queue the device work (the engine synchronizes once per step when
it reads the tokens back).

Every factory takes a ``strategy`` (sharding/rules.py) and runs the model
under its sharder (``sharding_ctx``), so ``ServeEngine`` composes with
``tp_serve``: the same steps, each rank running them on its own slices
of the weights and the cache.
"""
from __future__ import annotations

import torch

from repro_torch.sharding.ctx import sharding_ctx


def _sharder(strategy):
    return strategy.sharder() if strategy is not None else None


class StepCache:
    """The engine's steps, built once per (kind, paged, rollback) for one
    model, so engines serving the same model share them."""

    def __init__(self, model, strategy=None):
        self.model = model
        self.strategy = strategy
        self._fns = {}

    def get(self, kind: str, *, paged: bool = False,
            rollback: bool = False):
        key = (kind, bool(paged), bool(rollback))
        fn = self._fns.get(key)
        if fn is None:
            st = self.strategy
            if kind == "tick":
                fn = make_engine_tick(self.model, st, paged=paged)
            elif kind == "verify":
                fn = make_engine_verify(self.model, st, paged=paged,
                                        rollback=rollback)
            elif kind == "prefill":
                fn = make_engine_prefill(self.model, st, paged=paged)
            elif kind == "page_copy":
                from repro_torch.serve.kv_cache import make_page_copy
                fn = make_page_copy(_sharder(st))
            else:
                raise ValueError(f"unknown step kind {kind!r}")
            self._fns[key] = fn
        return fn


def shard_params(model, strategy, params):
    """(this rank's slice of every leaf of the full tree ``params`` as the
    strategy's spec tree says, copies so the full tree may go; the params
    the steps run on). The serving layers keep the residual stream whole
    on every rank and run blocks only of feature dims, so a leaf the spec
    shards on its 'embed' axis (the stacked norm scales, an MoE router)
    is gathered whole once for the steps. The steps' layout (the spec
    tree with those leaves whole) is bound on the strategy's sharder,
    where the layers read which of their leaves are blocks
    (``Sharder.param_specs``)."""
    from repro_torch.models.params import tree_map
    from repro_torch.sharding import comm
    from repro_torch.sharding.rules import PS, map2, shard_tree
    specs = strategy.param_specs(model)
    mesh = strategy.mesh
    local = tree_map(torch.clone, shard_tree(params, specs, mesh))

    def embed_dim(axes, spec):
        return next((i for i, (a, e) in enumerate(zip(axes, spec))
                     if a == "embed" and e is not None), None)

    def run(t, axes, spec):
        dim = embed_dim(axes, spec)
        if dim is None:
            return t
        return comm.all_gather(t, spec[dim], mesh, dim=dim)
    axes = model.param_axes()
    strategy.sharder().bind_params(map2(
        lambda ax, sp: sp if embed_dim(ax, sp) is None else PS(), axes,
        specs))
    return local, map2(run, local, axes, specs)


def make_serve_step(model, strategy=None):
    """serve_step(params, cache, tokens (B,1) int32) -> (greedy next
    tokens (B,1) int32, new cache): one cached forward, no gradient."""
    sharder = _sharder(strategy)

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        with sharding_ctx(sharder):
            logits, new_cache = model.decode_step(params, cache, tokens)
        nxt = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        return nxt, new_cache
    return serve_step


def make_engine_tick(model, strategy=None, *, paged: bool = False):
    """One decode tick over the whole slot batch.

    Dense layout: idle slots freeze token AND write index, so every tick
    rewrites the same K/V site with the same value — the serving-tier
    dead/silent store the detectors trap on. Paged layout: idle slots'
    write positions drop to a sentinel (-2) below the page-table extent,
    so their store is dropped — the detected waste, eliminated."""
    sharder = _sharder(strategy)

    def tick(params, cache, tokens, active):
        idx0 = model.cache_index(cache)            # (B,)
        stepped = cache
        if paged:
            stepped = model.with_cache_index(
                cache, torch.where(active, idx0, -2))
        with sharding_ctx(sharder):
            logits, new_cache = model.decode_step(params, stepped, tokens)
        nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
        nxt = torch.where(active[:, None], nxt[:, None], tokens)
        new_cache = model.with_cache_index(
            new_cache, torch.where(active, idx0 + 1, idx0))
        return nxt, new_cache
    return tick


def make_engine_verify(model, strategy=None, *, paged: bool = False,
                       rollback: bool = False):
    """One speculative verify tick over the whole slot batch.

    tokens: (B, W) = [last accepted token, draft_1 .. draft_{W-1}] per
    slot (unused draft positions are padding); active: (B,) bool;
    draft_len: (B,) number of real drafts per row (0 = plain decode).

    Greedy acceptance on the device: draft j+1 is accepted iff it equals
    the verify forward's own greedy token at position j and every
    earlier draft was accepted, so the emitted chain g[:, 0..m] is what
    plain one-token decode would produce. Returns (g (B,W) greedy
    tokens, m (B,) accepted-draft counts, next tokens (B,1) = the bonus
    token g[:, m], the cache with each live slot's index advanced by
    1+m).

    Paged: idle slots get the sentinel index -(W+1), so their window
    stores all drop. rollback=True (paged): the verify forward defers
    its stores and ``LM.commit_verify`` stores the accepted 1+m rows, so
    rejected drafts never reach the pool. rollback=False: all W rows are
    stored and the index rolls back over the rejected tail, which the
    next window overwrites (the dead stores ``rejected_draft_store``
    counts)."""
    sharder = _sharder(strategy)

    def verify(params, cache, tokens, active, draft_len):
        B, W = tokens.shape
        idx0 = model.cache_index(cache)            # (B,)
        stepped = cache
        if paged:
            stepped = model.with_cache_index(
                cache, torch.where(active, idx0, -(W + 1)))
        with sharding_ctx(sharder):
            logits, new_cache = model.verify(params, stepped, tokens,
                                             commit=not rollback)
        g = logits.argmax(dim=-1).to(torch.int32)               # (B, W)
        ok = ((tokens[:, 1:] == g[:, :-1])
              & (torch.arange(W - 1, device=tokens.device)[None, :]
                 < draft_len[:, None]))
        m = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
        m = torch.where(active, m, 0).to(torch.int32)
        if rollback:
            with sharding_ctx(sharder):
                new_cache = model.commit_verify(
                    new_cache, idx0, torch.where(active, 1 + m, 0))
        nxt = torch.gather(g, 1, m[:, None].long())
        nxt = torch.where(active[:, None], nxt, tokens[:, :1])
        new_cache = model.with_cache_index(
            new_cache, torch.where(active, idx0 + 1 + m, idx0))
        return g, m, nxt, new_cache
    return verify


def make_engine_prefill(model, strategy=None, *, paged: bool = False):
    """Grouped admission prefill.

    toks: (B,P) right-padded prompts — full prompts in dense mode, the
    uncached suffixes (prompt minus the reused prefix) in paged mode;
    admit: (B,) bool; start: (B,) cached-prefix lengths (all zero in
    dense mode); lengths: (B,) full prompt lengths; prev_tokens: (B,1)
    tokens of non-admitted rows, passed through untouched.

    Dense: every row's cache is refilled from position 0 and the rows of
    non-admitted slots are restored afterwards (the reference merges the
    refilled cache back under the admit mask). Paged: non-admitted rows
    get the sentinel index -(P+1), so their stores all drop; only the
    write indices are restored."""
    sharder = _sharder(strategy)

    def prefill(params, cache, toks, admit, start, lengths, prev_tokens):
        B, P = toks.shape
        idx0 = model.cache_index(cache)
        saved = None
        if paged:
            fresh = model.with_cache_index(
                cache, torch.where(admit, start, -(P + 1)))
        else:
            fresh = model.with_cache_index(
                cache, torch.zeros((B,), dtype=torch.int32,
                                   device=toks.device))
            saved = {name: {key: sub[key].clone() for key in ("k", "v")}
                     for name, sub in cache["main"].items()}
        with sharding_ctx(sharder):
            logits, filled = model.prefill(params, fresh, toks)
        if saved is not None:
            keep = admit.view(1, -1, 1, 1, 1)
            for name, sub in filled["main"].items():
                for key in ("k", "v"):
                    sub[key].copy_(torch.where(keep, sub[key],
                                               saved[name][key]))
        merged = model.with_cache_index(
            filled, torch.where(admit, lengths, idx0))
        sel_pos = (lengths - start - 1).clamp(0, P - 1).long()
        rows = torch.arange(B, device=toks.device)
        first = logits[rows, sel_pos].argmax(dim=-1).to(torch.int32)
        toks_out = torch.where(admit[:, None], first[:, None], prev_tokens)
        return toks_out, merged
    return prefill
