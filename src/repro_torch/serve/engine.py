"""Continuous-batching serving engine (DESIGN.md §2, serving tier).

Production-shaped serving over a fixed-size decode batch:

  * **Batched prefill** — an admission group's prompts fill their KV in
    ONE cached forward (`LM.prefill`), not `prompt_len` decode steps.
  * **Per-slot positions** — the cache write index is a (B,) vector, so
    every slot sits at its own sequence offset: requests arrive, finish
    (EOS / max-new-tokens) and recycle their slot independently while
    the batch keeps stepping.
  * **Honest accounting** — prefill and decode token counts/times are
    tracked separately, decode throughput is measured over *live* slots
    only, and the padded prefill tokens burned by power-of-two prompt
    bucketing are counted in `stats`. Each timed step ends in a device
    synchronization.
  * **Waste detection → elimination** — in the dense layout the decode
    batch writes K/V for every slot every tick and every duplicated
    prompt prefix is recomputed; `core.detectors.ServingDetectors`
    traps exactly that waste. With ``kv_layout="paged"`` the engine
    eliminates it (serve/kv_cache.py): a refcounted page pool with
    per-slot page tables, idle slots writing nothing, recycling freeing
    pages, and a prefix index mapping a duplicated prefix's pages into
    the new slot (copy-on-write for partial pages). With
    ``kernel_counters=True`` the paged kernels also count every store
    at the store site (tier 4).
  * **Speculative decoding** — pass a ``drafter`` (serve/spec.py) and
    every decode tick becomes draft, verify, accept: the drafter proposes
    up to ``spec_k`` tokens per live slot, ONE width-(k+1) verify forward
    (``serve.decode.make_engine_verify`` over ``LM.verify``) scores them
    all, and the greedy-consistent prefix plus a bonus token are emitted:
    the same tokens as plain decode, up to k+1 of them per slot per tick.
    Rejected drafts are Def.-1 dead KV stores
    (``ServingDetectors.rejected_draft_store``); with ``spec_rollback``
    on the paged layout only the accepted prefix is stored
    (``LM.commit_verify``) and they never reach the pool.
  * **Tensor-parallel serving** — with ``strategy`` (``tp_serve`` on a
    (1, n) mesh of n ranks, one engine per rank, sharding/rules.py) each
    rank holds its slice of every weight as the strategy's spec tree
    says and its chunk of the KV cache (a paged pool's pages, a long
    dense cache's positions); the steps run under the strategy's sharder
    (serve/decode.py), so every attention is flash-decoding over the
    chunks (serve/flash_decode.py). The scheduler, page allocator,
    detectors and drafter run identically on every rank; a page copied
    on write crosses ranks when its source and destination lie on two,
    a detector's read of a site comes from its owner, and after every
    step the ranks' token ids are compared (a mismatch raises at once).
  * **Fleet and object hooks** — a request may carry a ``prefix_hint``
    (pages of this pool leased by the fleet router, serve/router.py);
    with a ``registry`` (core/objects.py) every allocated page and the
    drafter's window register as live objects under ``owner``; with
    ``content_dedup`` a same-burst duplicate prefix waits one tick and
    admits as a prefix hit.

The engine serves the dense and moe families (every block carries an
indexed KV cache). An MoE layer routes with capacity per group of up to
256 tokens across the whole batch, so a slot's drops depend on its batch
mates: idle slots and padded prefill positions feed the reference's
tokens.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.detectors import (ServingDetectors, SlotWrite,
                                        VerifyWrite)
from repro_torch.serve.decode import (make_engine_prefill, make_engine_tick,
                                      make_engine_verify, shard_params)
from repro_torch.serve.kv_cache import (PagedKV, PoolExhausted, _digest,
                                        make_page_copy)
from repro_torch.sharding import comm
from repro_torch.sharding.ctx import sharding_ctx

ENGINE_FAMILIES = ("dense", "moe")
KV_LAYOUTS = ("dense", "paged")


@dataclass
class Request:
    """One serving request: prompt in, greedy continuation out."""
    rid: str
    tokens: np.ndarray                 # (L,) int32 prompt
    max_new_tokens: int = 16
    arrival: int = 0                   # earliest engine step for admission
    # (length, pages) of this prompt's prefix in THIS replica's pool,
    # leased by the fleet router from the global prefix tier at dispatch
    # (serve/global_prefix.py); the engine consumes it at admission and
    # releases the lease
    prefix_hint: Optional[Any] = None
    # filled by the engine:
    generated: List[int] = field(default_factory=list)
    prefill_step: int = -1
    finish_step: int = -1
    reuse_len: int = 0                 # cached-prefix tokens mapped in

    @property
    def done(self) -> bool:
        return self.finish_step >= 0


class MonotonicStats(dict):
    """Engine counters that can only grow: a decrement raises instead of
    corrupting aggregation by snapshot deltas."""

    def __setitem__(self, key, value):
        cur = self.get(key)
        if (cur is not None and isinstance(cur, (int, float))
                and isinstance(value, (int, float)) and value < cur):
            raise ValueError(
                f"engine stat {key!r} may not decrease ({cur} -> {value})")
        super().__setitem__(key, value)


def _bucket(n: int, lo: int = 8) -> int:
    """Pad prompt groups to power-of-two lengths."""
    p = lo
    while p < n:
        p *= 2
    return p


class ServeEngine:
    """Fixed-size decode batch + waiting queue + slot recycling."""

    def __init__(self, model, params, *, num_slots: int = 4,
                 max_len: int = 128, eos_id: Optional[int] = None,
                 detectors: Optional[ServingDetectors] = None,
                 kv_dtype=torch.float32, kv_layout: str = "dense",
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefix_window: int = 32,
                 drafter=None, spec_k: int = 4,
                 spec_rollback: bool = True,
                 kernel_counters: bool = False,
                 step_cache=None,
                 registry=None, owner: str = "engine",
                 content_dedup: bool = False, strategy=None):
        if model.cfg.family not in ENGINE_FAMILIES:
            raise ValueError(
                f"ServeEngine needs an indexed KV cache in every block; "
                f"family {model.cfg.family!r} is not served here")
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}")
        self.model = model
        self.strategy = strategy
        self._sharder = None
        # the params the steps run on (under a strategy: this rank's
        # slices, those sharded on 'embed' whole: decode.shard_params)
        self._step_params = params
        if strategy is not None:
            self._sharder = self._serving_sharder(strategy)
            params, self._step_params = shard_params(model, strategy,
                                                     params)
        self.params = params
        self.device = params["embed"].device
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.detectors = detectors
        self.kv_layout = kv_layout
        self.paged = kv_layout == "paged"
        # speculative decoding: up to spec_k drafts per slot per tick, one
        # width-(k+1) verify forward; rollback (paged only) stores only
        # the accepted rows, dense always overwrites
        self.drafter = drafter
        self.spec = drafter is not None
        if self.spec and spec_k < 1:
            raise ValueError("spec_k must be >= 1 when drafting")
        self.spec_k = spec_k
        self.spec_rollback = bool(spec_rollback) and self.paged
        # kernel tier: in-kernel store-site waste counters (paged layout
        # only — the counters ride the paged store path)
        if kernel_counters and not self.paged:
            raise ValueError("kernel_counters needs kv_layout='paged'")
        self.kernel_counters = bool(kernel_counters)
        # object tier (DESIGN.md § Object tier): every allocated page
        # registers as a live kv_page object under this engine's owner
        # name, so the fleet's ReplicaDetector can content-hash pools
        # across replicas
        self.registry = registry
        self.owner = owner
        # same-burst content dedup: an admission group member whose
        # page-aligned prefix duplicates an earlier member's is deferred
        # one tick, so the leader's register_prefix turns the duplicate
        # into an ordinary PrefixIndex hit (see _admit)
        self.content_dedup = bool(content_dedup) and self.paged

        if self.paged:
            max_pages = -(-max_len // page_size)
            if num_pages is None:
                num_pages = num_slots * max_pages
            self.kv = PagedKV(num_slots, page_size, num_pages, max_pages,
                              prefix_window=prefix_window,
                              registry=registry, owner=f"{owner}/kv")
            with sharding_ctx(self._sharder):
                cache = model.init_paged_cache(
                    params, num_slots, max_len, page_size=page_size,
                    num_pages=num_pages, kv_dtype=kv_dtype,
                    kernel_counters=self.kernel_counters)
            if registry is not None:
                # the allocator registers pages; it needs the pool's
                # per-page byte size and a live-content reader, both
                # only known once the device cache exists
                a = self.kv.alloc
                a.page_bytes = sum(
                    sub[key][:, 0].nbytes
                    for sub in cache["main"].values() if "pt" in sub
                    for key in ("k", "v"))
                a.page_reader = self._read_page
            self._copy_fn = (step_cache.get("page_copy")
                             if step_cache is not None
                             else make_page_copy(self._sharder))
        else:
            self.kv = None
            with sharding_ctx(self._sharder):
                cache = model.init_cache(params, num_slots, max_len,
                                         kv_dtype=kv_dtype)
        self.cache = model.with_cache_index(
            cache, torch.zeros((num_slots,), dtype=torch.int32,
                               device=self.device))
        self.tokens = torch.zeros((num_slots, 1), dtype=torch.int32,
                                  device=self.device)
        if self.spec and registry is not None:
            # the drafter's corpus is the engine's long-lived draft
            # window: replicas that served the same traffic hold
            # bit-identical copies (replica_draft_window)
            registry.register(
                f"{owner}/draft/window", "draft_window",
                num_slots * (self.spec_k + 1) * 4,
                reader=self._read_draft_window)

        self.slots: List[Optional[Request]] = [None] * num_slots
        self._lengths = np.zeros(num_slots, np.int64)  # host mirror of idx
        self._queue: Deque[Request] = deque()
        self.finished: Dict[str, Request] = {}
        self.step_no = 0
        self.stats = MonotonicStats(
            {"prefill_tokens": 0, "decode_tokens": 0,
             "prefill_s": 0.0, "decode_s": 0.0, "ticks": 0,
             "prefills": 0,
             # prompt tokens actually pushed through the model
             # (< prefill_tokens when prefixes hit the cache)
             "prefill_computed_tokens": 0,
             # padded-garbage positions the bucketed prefill burned
             "padded_prefill_tokens": 0,
             "prefix_hits": 0, "prefix_hit_tokens": 0,
             "cow_copies": 0, "pages_freed": 0,
             # admissions pushed back by pool pressure (the router's
             # preemption signal)
             "admit_deferred": 0,
             # admissions pushed back ONE tick by content dedup so a
             # same-burst duplicate prefix admits as an index hit
             "dedup_deferred": 0,
             # speculative decode accounting
             "spec_ticks": 0, "draft_proposed": 0,
             "draft_accepted": 0, "draft_s": 0.0,
             "verify_s": 0.0, "verified_positions": 0})

        if step_cache is not None:
            assert step_cache.model is model, \
                "step_cache was built for a different model"
            assert step_cache.strategy is strategy, \
                "step_cache was built for a different strategy"
            self._tick_fn = step_cache.get("tick", paged=self.paged)
            self._prefill_fn = step_cache.get("prefill", paged=self.paged)
            self._verify_fn = step_cache.get(
                "verify", paged=self.paged,
                rollback=self.spec_rollback) if self.spec else None
        else:
            self._tick_fn = make_engine_tick(model, strategy,
                                             paged=self.paged)
            self._prefill_fn = make_engine_prefill(model, strategy,
                                                   paged=self.paged)
            self._verify_fn = make_engine_verify(
                model, strategy, paged=self.paged,
                rollback=self.spec_rollback) if self.spec else None

        # detector geometry: the KV sub-blocks of one superblock
        main = self.cache["main"]
        self._kv_names = [n for n, sub in main.items() if "k" in sub]
        if detectors is not None:
            def row(n):
                return 2 * int(np.prod(main[n]["k"].shape[3:]))
            isz = main[self._kv_names[0]]["k"].element_size()
            detectors.bind(
                num_layers=model.sched.n_super,
                site_bytes=sum(row(n) * main[n]["k"].element_size()
                               for n in self._kv_names),
                paged=self.paged, kv_itemsize=isz,
                row_elems={n: row(n) for n in self._kv_names})

    # --------------------------- tensor parallel ----------------------
    def _serving_sharder(self, strategy):
        """The strategy's sharder: the engine serves under tp_serve, over
        any (data, model) mesh (the slots over 'data' when they divide,
        the cache chunked over 'model', an MoE model's experts over
        'model'), with or without an object registry; another strategy
        raises."""
        if strategy.name != "tp_serve":
            raise ValueError(
                f"ServeEngine serves under tp_serve, not {strategy.name!r}")
        return strategy.sharder()

    def _check_ranks(self, tokens: torch.Tensor) -> None:
        """Every rank must have stepped to the same token ids: compare
        them (one all-gather) and raise at once on a mismatch."""
        mesh = self.strategy.mesh
        if mesh.size == 1:
            return
        got = comm.all_gather(tokens.reshape(1, -1), mesh.axis_names, mesh,
                              dim=0)
        if not bool((got == got[:1]).all()):
            raise RuntimeError(
                f"rank {mesh.rank}: the ranks' tokens differ at step "
                f"{self.step_no}: {got.cpu().numpy().tolist()}")

    # ----------------------------- device sync ------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _peek(self, layer: int, page: int, off: int) -> np.ndarray:
        """The K/V values at one site, f32 on the host: dense layout
        (L, B, S, Hkv, D) with page = slot row, paged layout
        (L, P, page_size, Hkv, D) with the pool page. On a chunked cache
        the rank that holds the site broadcasts it."""
        s = self._sharder
        total = None
        if s is not None:
            total = s.pool_pages if self.paged else s.seq_len
        if total is None:
            outs = []
            for name in self._kv_names:
                sub = self.cache["main"][name]
                outs.append(sub["k"][layer, page, off].reshape(-1))
                outs.append(sub["v"][layer, page, off].reshape(-1))
            return torch.cat(outs).float().cpu().numpy()
        mesh = s.mesh
        first = self.cache["main"][self._kv_names[0]]["k"]
        chunk = first.shape[1] if self.paged else first.shape[2]
        site = page if self.paged else off
        owner, local = divmod(site, chunk)
        outs = []
        for name in self._kv_names:
            sub = self.cache["main"][name]
            for key in ("k", "v"):
                rows = (sub[key][layer, local, off] if self.paged
                        else sub[key][layer, page, local])
                outs.append(rows.reshape(-1))
        vals = torch.cat(outs)
        if owner != mesh.index("model"):
            vals = torch.zeros_like(vals)
        vals = comm.broadcast(vals, owner, "model", mesh)
        return vals.float().cpu().numpy()

    # --------------------------- object tier ---------------------------
    def _read_page(self, p: int) -> torch.Tensor:
        """Live contents of pool page `p` across every paged KV
        sub-block (k, then v, each (L, page_size, Hkv, D)), as one flat
        uint8 tensor on the pool's device: the replica detector's
        content reader, in the reference's byte order. On a pool chunked
        over 'model' the rank that holds the page broadcasts it (every
        rank scans the same pages in the same order)."""
        s = self._sharder
        chunk = next(sub["k"] for sub in self.cache["main"].values()
                     if "pt" in sub).shape[1]
        owner, local = divmod(p, chunk)
        chunks = []
        for sub in self.cache["main"].values():
            if "pt" not in sub:
                continue
            for key in ("k", "v"):
                chunks.append(sub[key][:, local].contiguous().reshape(-1)
                              .view(torch.uint8))
        page = (torch.cat(chunks) if chunks
                else torch.zeros(0, dtype=torch.uint8))
        if s is None or s.pool_pages is None:
            return page
        return comm.broadcast(page, owner, "model", s.mesh)

    def _read_draft_window(self) -> np.ndarray:
        corpus = (getattr(self.drafter, "_corpus", None)
                  or getattr(self.drafter, "_seqs", None) or [])
        arrs = [np.asarray(a, np.int32).ravel() for a in corpus]
        return (np.concatenate(arrs) if arrs else np.zeros(0, np.int32))

    def _read_kernel_counts(self):
        """The last forward's in-kernel [stored, silent, dropped] element
        counts, per KV sub-block, as (L, B, 3) host arrays — or None when
        the kernel tier is off."""
        if not self.kernel_counters or self.detectors is None:
            return None
        counts = self.model.kernel_counters(self.cache)
        if counts is None:
            return None
        return {n: c.cpu().numpy() for n, c in counts.items()}

    def _emit_kernel_store(self, site: str) -> None:
        counts = self._read_kernel_counts()
        if counts is not None:
            self.detectors.on_kernel_store(self.step_no, site, counts)

    # ------------------------------ schedule ---------------------------
    def submit(self, req: Request) -> None:
        if req.tokens.ndim != 1 or req.tokens.size < 1:
            raise ValueError(f"{req.rid}: the prompt must be a non-empty "
                             f"1-D token array")
        if req.tokens.size >= self.max_len:
            raise ValueError(f"{req.rid}: prompt of {req.tokens.size} "
                             f"tokens exceeds the cache ({self.max_len})")
        if req.max_new_tokens < 1:
            raise ValueError(f"{req.rid}: max_new_tokens must be >= 1")
        self._queue.append(req)

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(r is not None for r in self.slots)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def live_slots(self) -> int:
        return sum(r is not None for r in self.slots)

    def _note_freed(self, freed: List[int]) -> None:
        """Every page-freeing path goes through here: count the frees
        AND disarm the detectors' now-stale traps on them."""
        self.stats["pages_freed"] += len(freed)
        if self.detectors is not None and freed:
            self.detectors.on_page_free(freed)

    def note_freed(self, freed: List[int]) -> None:
        """Pages freed by an EXTERNAL holder of this replica's pool (the
        fleet's global prefix tier dropping its pins) still need their
        frees counted and their stale traps disarmed here."""
        self._note_freed([int(p) for p in freed])

    def _accept_token(self, slot: int, req: Request, tok: int) -> None:
        req.generated.append(int(tok))
        limit = min(req.max_new_tokens,
                    self.max_len - req.tokens.size)
        if ((self.eos_id is not None and tok == self.eos_id)
                or len(req.generated) >= limit):
            req.finish_step = self.step_no
            self.finished[req.rid] = req
            self.slots[slot] = None        # recycle: slot idles until reuse
            if self.drafter is not None:
                # a served sequence is future draft material
                self.drafter.observe(np.concatenate(
                    [req.tokens, np.asarray(req.generated, np.int32)]))
            if self.paged:
                # recycling frees pages; the device page table is synced
                # at the next admission (a finished slot's writes drop
                # on the idle index sentinel meanwhile)
                self._note_freed(self.kv.free_slot(slot))
            if self.detectors is not None:
                self.detectors.on_finish(self.step_no, slot, req.rid)

    def _dedup_group(self, group: List[Request]) -> List[Request]:
        """Content-addressed same-burst dedup (the OJXPerf replica fix).

        Requests admitted in ONE group share a single prefill and only
        register their prefixes after it, so two same-tick arrivals with
        a common prompt prefix each compute it into their own pages.
        Defer every member whose page-aligned prefix digest duplicates an
        earlier member's beyond what the index (or a fleet lease) already
        covers: next tick the leader's register_prefix has landed and the
        duplicate admits as an ordinary prefix hit. Outputs stay the
        same; the follower starts one tick later."""
        ps = self.kv.page_size
        keep: List[Request] = []
        deferred: List[Request] = []
        seen: Dict[str, int] = {}      # page-aligned prefix digest key
        for req in group:
            toks = np.asarray(req.tokens)
            lens = range(ps, int(toks.size), ps)
            keys = [f"{m}:{_digest(toks[:m])}" for m in lens]
            best = max((m for m, k in zip(lens, keys) if k in seen),
                       default=0)
            have = self.kv.index.match(toks)[0]
            if req.prefix_hint is not None:
                have = max(have, int(req.prefix_hint[0]))
            if best > have:
                req.arrival = self.step_no + 1
                deferred.append(req)
                self.stats["dedup_deferred"] += 1
            else:
                keep.append(req)
                seen.update((k, 1) for k in keys)
        if deferred:
            self._queue.extendleft(reversed(deferred))
        return keep

    def _admit(self) -> None:
        free = [b for b, r in enumerate(self.slots) if r is None]
        group: List[Request] = []
        while free[len(group):] and self._queue \
                and self._queue[0].arrival <= self.step_no:
            group.append(self._queue.popleft())
        if self.content_dedup and len(group) > 1:
            group = self._dedup_group(group)
        if not group:
            return
        B = self.num_slots
        admit = np.zeros(B, bool)
        starts = np.zeros(B, np.int32)
        lengths = np.ones(B, np.int32)
        taken: List[int] = []
        plans: Dict[int, Any] = {}
        admitted: List[Request] = []
        for b, req in zip(free, group):
            L = req.tokens.size
            if self.paged:
                budget = min(req.max_new_tokens, self.max_len - L)
                try:
                    plan = self.kv.admit(b, req.tokens, budget,
                                         hint=req.prefix_hint)
                except PoolExhausted as e:
                    # pool pressure: defer this (and following) requests;
                    # pages the failed eviction pass did free still need
                    # their stale traps disarmed. The dispatch lease (if
                    # any) stays held for the retry.
                    self._note_freed(e.freed)
                    self.stats["admit_deferred"] += 1
                    self._queue.extendleft(
                        reversed(group[len(admitted):]))
                    break
                if req.prefix_hint is not None:
                    # admit pinned whatever it mapped; the dispatch-time
                    # lease has done its job
                    self._note_freed(self.kv.release(req.prefix_hint[1]))
                    req.prefix_hint = None
                plans[b] = plan
                starts[b] = plan.reuse_len
                req.reuse_len = plan.reuse_len
                if plan.reuse_len:
                    self.stats["prefix_hits"] += 1
                    self.stats["prefix_hit_tokens"] += plan.reuse_len
                self.stats["cow_copies"] += len(plan.cow)
                self._note_freed(plan.freed)
            admit[b] = True
            lengths[b] = L
            taken.append(b)
            admitted.append(req)
            self.slots[b] = req
            self._lengths[b] = L
            req.prefill_step = self.step_no
        if not admitted:
            return

        # power-of-two padding of the group's (suffix) lengths, capped at
        # the cache extent
        suffixes = [int(lengths[b] - starts[b]) for b in taken]
        P = min(_bucket(max(suffixes)), self.max_len)
        toks = np.zeros((B, P), np.int32)
        for b, req in zip(taken, admitted):
            suf = req.tokens[int(starts[b]):]
            toks[b, :suf.size] = suf
            if self.detectors is not None:
                # dense: the prefill store sweeps the padded extent [0,P)
                # of the slot's row; paged: only freshly-owned pages are
                # written, so there is no stale-row sweep to trap
                self.detectors.on_admit(
                    self.step_no, b, req.rid, req.tokens,
                    padded_len=None if self.paged else P,
                    reuse_len=int(starts[b]))

        if self.paged:
            self.cache = self.model.with_page_table(self.cache, self.kv.pt)
            cows = [c for b in taken for c in plans[b].cow]
            if cows:
                # copy-on-write of partially reused pages
                src = np.full(B, 0, np.int32)
                dst = np.full(B, self.kv.num_pages, np.int32)  # dropped
                for i, (s, d) in enumerate(cows):
                    src[i], dst[i] = s, d
                self.cache = self._copy_fn(self.cache, src, dst)
            # the copy consumed the COW sources — drop their pins
            for b in taken:
                self._note_freed(self.kv.release(plans[b].cow_pins))

        dev = self.device
        t0 = time.perf_counter()
        toks_out, self.cache = self._prefill_fn(
            self._step_params, self.cache,
            torch.as_tensor(toks, device=dev),
            torch.as_tensor(admit, device=dev),
            torch.as_tensor(starts, device=dev),
            torch.as_tensor(lengths, device=dev), self.tokens)
        self._sync()
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_tokens"] += int(sum(r.tokens.size
                                                for r in admitted))
        self.stats["prefill_computed_tokens"] += int(sum(suffixes))
        self.stats["padded_prefill_tokens"] += B * P - int(sum(suffixes))
        self.stats["prefills"] += 1
        self.tokens = toks_out
        if self.strategy is not None:
            self._check_ranks(toks_out)
        self._emit_kernel_store("prefill")
        if self.paged:
            for b, req in zip(taken, admitted):
                self._note_freed(self.kv.register_prefix(b, req.tokens))
        host = toks_out[:, 0].cpu().numpy()
        for b, req in zip(taken, admitted):
            self._accept_token(b, req, host[b])

    def _decode_tick(self) -> None:
        if self.spec:
            self._spec_tick()
            return
        active = np.array([r is not None for r in self.slots])
        write_pos = self._lengths.copy()   # the position each slot writes
        t0 = time.perf_counter()
        nxt, self.cache = self._tick_fn(
            self._step_params, self.cache, self.tokens,
            torch.as_tensor(active, device=self.device))
        self._sync()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_tokens"] += int(active.sum())
        self.stats["ticks"] += 1
        self.tokens = nxt
        if self.strategy is not None:
            self._check_ranks(nxt)
        self._emit_kernel_store("decode")
        self._lengths[active] += 1
        host = nxt[:, 0].cpu().numpy()
        slots_now = list(self.slots)
        for b, req in enumerate(slots_now):
            if req is not None:
                self._accept_token(b, req, host[b])
        self._report_tick_writes(slots_now, write_pos)

    def _report_tick_writes(self, slots_now, write_pos) -> None:
        """Tier-3 reporting of one tick's K/V stores."""
        if self.detectors is None:
            return
        writes = []
        for b, req in enumerate(slots_now):
            pos = int(write_pos[b])
            if self.paged:
                # idle slots write nothing in the paged layout, and a slot
                # that just finished freed its pages (site unmapped)
                if req is None:
                    continue
                page, off = self.kv.site(b, pos)
                if page < 0:
                    continue
            else:
                page, off = b, pos
            writes.append(SlotWrite(b, req.rid if req is not None
                                    else None, req is not None, pos,
                                    page=page, offset=off))
        self.detectors.on_step(self.step_no, writes, self._peek)

    # ------------------------- speculative tick -----------------------
    def _draft_cap(self, slot: int, req: Request) -> int:
        """Drafts worth proposing for this slot: at most spec_k, the
        request's remaining allowance less the bonus token, and the
        slot's writable extent (its mapped pages when paged, the cache
        otherwise), so an accepted draft always lands."""
        limit = min(req.max_new_tokens, self.max_len - req.tokens.size)
        cap = min(self.spec_k, limit - len(req.generated) - 1)
        pos0 = int(self._lengths[slot])
        if self.paged:
            cap = min(cap, self.kv.slot_extent(slot) - pos0 - 1)
        else:
            cap = min(cap, self.max_len - pos0 - 1)
        return max(0, cap)

    def _spec_tick(self) -> None:
        """One draft, verify, accept step over the whole batch: the
        drafter proposes up to spec_k tokens per live slot on the host,
        ONE width-(k+1) verify forward scores them all, and the accepted
        prefix plus the bonus token are emitted. The host reads the
        greedy tokens and accept counts once per tick."""
        B, W = self.num_slots, self.spec_k + 1
        active = np.array([r is not None for r in self.slots])
        write_pos = self._lengths.copy()
        toks = np.zeros((B, W), np.int32)
        dlen = np.zeros(B, np.int32)
        t0 = time.perf_counter()
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            cap = self._draft_cap(b, req)
            if cap <= 0:
                continue
            hist = np.concatenate(
                [req.tokens, np.asarray(req.generated, np.int32)])
            d = np.asarray(self.drafter.propose(hist, cap),
                           np.int32).reshape(-1)[:cap]
            dlen[b] = d.size
            toks[b, 1:1 + d.size] = d
        self.stats["draft_s"] += time.perf_counter() - t0

        dev = self.device
        t0 = time.perf_counter()
        toks_d = torch.as_tensor(toks, device=dev)
        toks_d[:, :1] = self.tokens          # the last accepted tokens
        g, m, nxt, self.cache = self._verify_fn(
            self._step_params, self.cache, toks_d,
            torch.as_tensor(active, device=dev),
            torch.as_tensor(dlen, device=dev))
        self._sync()
        dt = time.perf_counter() - t0
        if self.strategy is not None:
            self._check_ranks(torch.cat([g, m[:, None]], dim=1))
        gm = torch.cat([g, m[:, None]], dim=1).cpu().numpy()
        g, m = gm[:, :W], gm[:, W]
        self.stats["verify_s"] += dt
        self.stats["decode_s"] += dt
        self.stats["ticks"] += 1
        self.stats["spec_ticks"] += 1
        self.stats["draft_proposed"] += int(dlen[active].sum())
        self.stats["verified_positions"] += int(active.sum()) * W
        self.stats["draft_accepted"] += int(m[active].sum())
        self.tokens = nxt
        counts = self._read_kernel_counts()
        if counts is not None:
            # overwrite: the verify forward's full-window stores;
            # rollback: the commit's accepted-prefix stores
            self.detectors.on_kernel_verify(self.step_no, counts, m, dlen,
                                            active)
        self._lengths[active] += 1 + m[active]

        slots_now = list(self.slots)
        emitted = 0
        for b, req in enumerate(slots_now):
            if req is None:
                continue
            # the accepted chain and the bonus, up to EOS or the limit,
            # so the stream is exactly the plain-decode stream
            for j in range(int(m[b]) + 1):
                emitted += 1
                self._accept_token(b, req, int(g[b, j]))
                if req.done:
                    break
        self.stats["decode_tokens"] += emitted

        self._report_tick_writes(slots_now, write_pos)
        if self.detectors is not None:
            self.detectors.on_verify(self.step_no, self._verify_writes(
                slots_now, active, write_pos, m, dlen))

    def _verify_writes(self, slots_now, active, write_pos, m, dlen):
        """Tier-3 view of one verify tick's draft-row stores: every
        proposed row under overwrite (so the flagged share is 1 - accept
        rate), the accepted prefix under rollback. The fixed-width
        window's padding rows past dlen are stored too under overwrite,
        dead as well, but not the drafter's waste, so they stay out."""
        entries = []
        for b, req in enumerate(slots_now):
            if req is None or not active[b]:
                continue
            pos0 = int(write_pos[b])
            n_written = int(m[b]) if self.spec_rollback else int(dlen[b])
            sites = []
            for j in range(1, n_written + 1):
                pos = pos0 + j
                if self.paged:
                    page, off = self.kv.site(b, pos)
                    if page < 0:
                        continue
                else:
                    if pos >= self.max_len:
                        continue
                    page, off = b, pos
                sites.append((page, off, j > int(m[b])))
            entries.append(VerifyWrite(b, req.rid, int(m[b]), sites))
        return entries

    def step(self) -> None:
        """One scheduler step: admit into free slots, then one decode
        tick over the whole batch."""
        self._admit()
        self._decode_tick()
        self.step_no += 1

    def run(self, max_steps: int = 100_000) -> Dict[str, Request]:
        """Drive until every submitted request has finished."""
        steps = 0
        while self.pending and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    # ---------------------------- reporting ----------------------------
    def traced_tick(self):
        """Abstract trace of one decode tick over the engine's own
        parameters and cache, every slot active (``core/graph_trace.py``:
        fake tensors, nothing runs or is written): the tier-2 subject,
        the counterpart of the reference's ``lowered_tick``. Under a
        strategy it is this rank's tick over its slices and its chunk of
        the cache, each collective a node (``sharding/comm.py``); the
        engine may then hold fake parameters on a mesh with no process
        group, and trace any rank of any layout."""
        from repro_torch.core.graph_trace import trace_step
        active = torch.ones((self.num_slots,), dtype=torch.bool,
                            device=self.device)
        return trace_step(self._tick_fn, self._step_params, self.cache,
                          self.tokens, active)

    def throughput(self) -> Dict[str, float]:
        s = self.stats
        out = {
            "prefill_tok_s": (s["prefill_tokens"] / s["prefill_s"]
                              if s["prefill_s"] else 0.0),
            "decode_tok_s": (s["decode_tokens"] / s["decode_s"]
                             if s["decode_s"] else 0.0),
        }
        if self.spec:
            out["draft_tok_s"] = (s["draft_proposed"] / s["draft_s"]
                                  if s["draft_s"] else 0.0)
            out["verify_tok_s"] = (s["verified_positions"] / s["verify_s"]
                                   if s["verify_s"] else 0.0)
            out["accept_rate"] = (s["draft_accepted"] / s["draft_proposed"]
                                  if s["draft_proposed"] else 0.0)
        return out
