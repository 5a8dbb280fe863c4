"""Block-paged KV cache with copy-on-write prefix reuse (DESIGN.md §2,
serving tier).

This is the optimization the serve-side detectors point at: dense
per-slot cache rows make every idle tick a dead/silent KV store (Defs.
1-2) and every duplicated prompt prefix a silent prefix load (Def. 3).
The paged heap eliminates both:

  * the KV pool is a flat array of fixed-size **pages**; a free-list
    allocator hands pages to slots and a per-slot **page table** maps
    logical token positions to pages, so idle/finished slots simply own
    no pages past their extent and write nothing (the stores drop);
  * pages are **refcounted**: a prefix another request already computed
    is mapped into the new slot's table instead of recomputed (the
    Def.-3 finding becomes a cache hit), and a partially reused page is
    **copied-on-write** so the borrower's suffix never mutates the
    donor's K/V;
  * a **content-digest prefix index** (LRU-bounded, pinning its pages
    via refcounts) matches a new prompt's longest cached prefix at
    power-of-two and page-boundary granularities.

Host-side bookkeeping lives here (allocator, page tables, prefix index,
numpy, as in the reference); the device pool lives in
`models/lm.py` (`init_paged_cache`) and the stores in the paged kernels.
`ServeEngine(kv_layout="paged")` drives it.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class PoolExhausted(RuntimeError):
    """No free pages left even after evicting every prefix-index pin.

    `freed` carries the pages that pressure-eviction DID release before
    giving up, so the caller can still disarm stale watchpoints on them."""

    def __init__(self, msg: str, freed: Optional[List[int]] = None):
        super().__init__(msg)
        self.freed: List[int] = freed or []


# ----------------------------------------------------------------------
# Free-list page allocator with refcounts
# ----------------------------------------------------------------------
class PageAllocator:
    """Fixed pool of `num_pages` pages; O(1) alloc/free; refcounted.

    A page's refcount is the number of holders: slots mapping it in
    their page table plus prefix-index entries pinning it. `alloc`
    returns pages at refcount 1 (the caller is the first holder);
    sharing bumps it via `incref`; `decref` returns the pages that
    reached zero (freed back to the list).

    With an `ObjectRegistry` attached (core/objects.py) every alloc
    registers the page as a live ``kv_page`` object (its allocation site
    is THIS allocator's alloc) and the zero-refcount free retires it, so
    replica scans only see pages some holder still maps. The engine
    installs `page_bytes` / `page_reader` once it has built the device
    pool."""

    def __init__(self, num_pages: int, *, registry=None, owner: str = "kv",
                 page_bytes: int = 0, page_reader=None):
        assert num_pages >= 1
        self.num_pages = num_pages
        self.refcount = np.zeros(num_pages, np.int32)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self.registry = registry
        self.owner = owner
        self.page_bytes = page_bytes
        self.page_reader = page_reader
        self._oids: Dict[int, int] = {}    # page -> registry oid (live)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free of {self.num_pages}")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            assert self.refcount[p] == 0, f"free page {p} had refs"
            self.refcount[p] = 1
            if self.registry is not None:
                rd = self.page_reader
                rec = self.registry.register(
                    f"{self.owner}/page{p}", "kv_page", self.page_bytes,
                    reader=(lambda p=p, rd=rd: rd(p))
                    if rd is not None else None)
                self._oids[p] = rec.oid
        return out

    def incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            assert self.refcount[p] > 0, f"incref on free page {p}"
            self.refcount[p] += 1

    def decref(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; returns pages freed (now refless)."""
        freed: List[int] = []
        for p in pages:
            assert self.refcount[p] > 0, f"double free of page {p}"
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(int(p))
                freed.append(int(p))
                if self.registry is not None:
                    oid = self._oids.pop(int(p), None)
                    if oid is not None:
                        self.registry.release(oid)
        return freed

    def check(self) -> None:
        """Invariants: free list and refcounts partition the pool."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate page in free list"
        for p in range(self.num_pages):
            if p in free:
                assert self.refcount[p] == 0, f"free page {p} has refs"
            else:
                assert self.refcount[p] > 0, f"leaked page {p} (no refs)"


# ----------------------------------------------------------------------
# Content-digest prefix index
# ----------------------------------------------------------------------
def _digest(tokens: np.ndarray) -> str:
    arr = np.ascontiguousarray(tokens)
    return hashlib.blake2b(arr.tobytes(), digest_size=8).hexdigest()


def prefix_candidates(n: int, page_size: int) -> List[int]:
    """Prefix lengths worth indexing for an n-token prompt: the power-of-
    two ladder shared with `ServingDetectors` (what the detector calls a
    duplicate, the cache can reuse), page boundaries (whole-page reuse
    needs no copy), and the full prompt; ascending."""
    from repro_torch.core.detectors import PREFIX_POW2
    cands = {p for p in PREFIX_POW2 if p < n}
    cands.update(range(page_size, n, page_size))
    cands.add(n)
    return sorted(cands)


@dataclass
class _Entry:
    length: int
    pages: Tuple[int, ...]     # pages covering [0, ceil(length/page_size))


class PrefixIndex:
    """digest(prompt[:L]) -> pages holding that prefix's K/V.

    Entries pin their pages through the allocator so a donor's prefix
    survives the donor's slot; the index is LRU-bounded and evicts under
    pool pressure (unpinning frees pages only when no live slot still
    maps them)."""

    def __init__(self, allocator: PageAllocator, page_size: int,
                 window: int = 32):
        self.alloc = allocator
        self.page_size = page_size
        self.window = max(1, window)
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        # refcount of registered entry LENGTHS: a donor's full prompt can
        # end mid-bucket, where the candidate ladder alone would never
        # probe it; `probe_lengths` adds every registered length
        self._lengths: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _key(length: int, tokens: np.ndarray) -> str:
        return f"{length}:{_digest(tokens[:length])}"

    def probe_lengths(self, n: int) -> List[int]:
        """Prefix lengths `match` probes for an n-token prompt: the
        pow2+page candidate ladder PLUS every registered length."""
        cands = set(prefix_candidates(n, self.page_size))
        cands.update(L for L in self._lengths if L < n)
        return sorted(cands)

    def match(self, tokens: np.ndarray) -> Tuple[int, Tuple[int, ...]]:
        """Longest indexed prefix of `tokens`: (length, pages) or (0, ())."""
        tokens = np.asarray(tokens)
        best_len, best_pages = 0, ()
        for cand in self.probe_lengths(tokens.size):
            key = self._key(cand, tokens)
            e = self._entries.get(key)
            if e is not None and cand > best_len:
                best_len, best_pages = e.length, e.pages
                self._entries.move_to_end(key)
        return best_len, best_pages

    def lookup(self, tokens: np.ndarray,
               length: int) -> Optional[Tuple[int, ...]]:
        """Pages of the exact-length entry for tokens[:length], or None
        (no LRU touch). The fleet's global tier mirrors local entries
        through this."""
        e = self._entries.get(self._key(length, np.asarray(tokens)))
        return e.pages if e is not None else None

    def register(self, tokens: np.ndarray,
                 pages: Sequence[int]) -> List[int]:
        """Index the prompt's prefixes against the slot's page row.

        `pages` is the slot's table row covering [0, tokens.size).
        Returns pages freed by LRU eviction (window overflow)."""
        tokens = np.asarray(tokens)
        ps = self.page_size
        freed: List[int] = []
        for cand in prefix_candidates(tokens.size, ps):
            key = self._key(cand, tokens)
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            need = -(-cand // ps)            # ceil: pages covering [0,cand)
            if need > len(pages):
                continue
            pinned = tuple(int(p) for p in pages[:need])
            self.alloc.incref(pinned)
            self._entries[key] = _Entry(cand, pinned)
            self._lengths[cand] = self._lengths.get(cand, 0) + 1
            while len(self._entries) > self.window:
                freed += self.evict_one() or []
        return freed

    def evict_one(self, prefer_freeing: bool = False) -> Optional[List[int]]:
        """Unpin one entry; returns pages freed, or None when empty.

        Plain LRU by default (window bounding). Under pool pressure
        (`prefer_freeing`), the LRU-oldest entry that would actually
        release a page goes first; falls back to plain LRU when no entry
        frees directly."""
        if not self._entries:
            return None
        key = next(iter(self._entries))
        if prefer_freeing:
            for k, e in self._entries.items():
                if any(self.alloc.refcount[p] == 1 for p in e.pages):
                    key = k
                    break
        e = self._entries.pop(key)
        self._lengths[e.length] -= 1
        if not self._lengths[e.length]:
            del self._lengths[e.length]
        return self.alloc.decref(e.pages)


# ----------------------------------------------------------------------
# The paged KV heap: allocator + per-slot tables + prefix index
# ----------------------------------------------------------------------
@dataclass
class AdmitPlan:
    """One admission's paging decisions (host side, pre-prefill)."""
    reuse_len: int                      # cached-prefix tokens mapped in
    row: List[int]                      # the slot's new page-table row
    cow: List[Tuple[int, int]] = field(default_factory=list)  # (src, dst)
    freed: List[int] = field(default_factory=list)  # evicted under pressure
    # COW source pages temporarily pinned by this admission — the caller
    # MUST release() them once the device-side page copy has consumed
    # their contents (the pin keeps eviction/realloc off the source)
    cow_pins: List[int] = field(default_factory=list)


class PagedKV:
    """Host-side manager of the paged serving heap for one engine: the
    free list, refcounts, each slot's page table (mirrored to the device
    via `LM.with_page_table`), and the prefix index that turns duplicated
    prompts into page mappings."""

    def __init__(self, num_slots: int, page_size: int, num_pages: int,
                 max_pages_per_slot: int, prefix_window: int = 32,
                 registry=None, owner: str = "kv"):
        self.num_slots = num_slots
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages_per_slot = max_pages_per_slot
        self.alloc = PageAllocator(num_pages, registry=registry,
                                   owner=owner)
        self.index = PrefixIndex(self.alloc, page_size, prefix_window)
        self.pt = np.full((num_slots, max_pages_per_slot), -1, np.int32)

    # ------------------------------------------------------------------
    def admit(self, slot: int, tokens: np.ndarray, budget: int,
              hint: Optional[Tuple[int, Tuple[int, ...]]] = None
              ) -> AdmitPlan:
        """Map a new request into `slot`: longest cached prefix shared
        page-for-page, a partially reused page copied-on-write, fresh
        pages for the rest of [0, len(tokens)+budget).

        `budget` is the request's generation allowance; pages covering
        prompt+budget are allocated up front so decode never faults.
        Raises PoolExhausted when eviction cannot free enough pages.

        `hint` is a (length, pages) prefix mapping from the fleet's
        global prefix tier (serve/global_prefix.py): pages of THIS pool
        holding tokens[:length], leased (incref'd) by the router at
        dispatch so they stay live and immutable even if the local LRU
        index has since forgotten the entry. Used when it beats the
        local match (an unreferenced page means the lease protocol was
        violated, so that is asserted)."""
        tokens = np.asarray(tokens)
        L = int(tokens.size)
        ps = self.page_size
        assert np.all(self.pt[slot] < 0), f"slot {slot} still mapped"

        match_len, donor = self.index.match(tokens)
        if hint is not None:
            h_len, h_pages = int(hint[0]), tuple(int(p) for p in hint[1])
            h_len = min(h_len, L)
            if h_len > match_len and h_len <= len(h_pages) * ps:
                assert all(self.alloc.refcount[p] > 0 for p in h_pages), \
                    "global-prefix hint maps an unreferenced page"
                match_len, donor = h_len, h_pages
        # the last prompt position is always recomputed: its logits seed
        # the continuation and hidden states are not cached
        reuse = min(match_len, L - 1)
        n_full = reuse // ps
        shared = [int(p) for p in donor[:n_full]]
        partial = reuse % ps
        cow_src = int(donor[n_full]) if partial else None

        need_pos = min(L + max(budget, 1), self.max_pages_per_slot * ps)
        n_need = -(-need_pos // ps)
        if n_need > self.num_pages:
            raise ValueError(
                f"request needs {n_need} pages but the pool holds only "
                f"{self.num_pages}; raise num_pages or page_size")
        n_new = n_need - n_full            # COW page (if any) + fresh pages

        # pin the matched pages BEFORE evicting/allocating: the pressure
        # loop below may evict the very entry just matched, and without
        # these references the allocator would hand the donor's pages
        # back as "fresh"
        self.alloc.incref(shared)
        cow_pins = [cow_src] if partial else []
        self.alloc.incref(cow_pins)

        freed: List[int] = []
        while self.alloc.free_count < n_new:
            fr = self.index.evict_one(prefer_freeing=True)
            if fr is None:
                freed += self.alloc.decref(shared)
                freed += self.alloc.decref(cow_pins)
                raise PoolExhausted(
                    f"slot {slot} needs {n_new} pages, "
                    f"{self.alloc.free_count} free, prefix index empty",
                    freed)
            freed += fr
        new_pages = self.alloc.alloc(n_new)

        cow = [(cow_src, new_pages[0])] if partial else []
        row = shared + new_pages
        self.pt[slot, :] = -1
        self.pt[slot, :len(row)] = row
        return AdmitPlan(reuse, row, cow, freed, cow_pins)

    def release(self, pages: Sequence[int]) -> List[int]:
        """Drop temporary pins (AdmitPlan.cow_pins, once the device copy
        has read the source pages); returns pages actually freed."""
        return self.alloc.decref(pages)

    def register_prefix(self, slot: int, tokens: np.ndarray) -> List[int]:
        """After prefill: index this prompt's prefixes for future reuse.
        Returns pages freed by LRU eviction."""
        row = [int(p) for p in self.pt[slot] if p >= 0]
        return self.index.register(tokens, row)

    def free_slot(self, slot: int) -> List[int]:
        """Recycle: unmap the slot's pages; returns pages actually freed
        (shared/pinned pages survive their other holders)."""
        row = [int(p) for p in self.pt[slot] if p >= 0]
        self.pt[slot, :] = -1
        return self.alloc.decref(row)

    def slot_extent(self, slot: int) -> int:
        """Number of logical positions the slot's page table maps (its
        writable extent). Speculative verify windows are capped to it so
        an accepted draft never lands on an unmapped position; only
        rejected and padding rows reach past it (and those drop)."""
        return int((self.pt[slot] >= 0).sum()) * self.page_size

    def site(self, slot: int, pos: int) -> Tuple[int, int]:
        """(page, offset) of a logical token position, or (-1, off)."""
        page_i, off = divmod(int(pos), self.page_size)
        if not (0 <= page_i < self.max_pages_per_slot):
            return -1, off
        return int(self.pt[slot, page_i]), off

    def check(self, extra_holders: Optional[Dict[int, int]] = None) -> None:
        """Cross-structure invariants: refcounts equal holders.

        `extra_holders` maps page -> references held outside this heap
        (the fleet's global prefix pins and in-flight dispatch leases)."""
        self.alloc.check()
        refs: Dict[int, int] = dict(extra_holders or {})
        for b in range(self.num_slots):
            for p in self.pt[b]:
                if p >= 0:
                    refs[int(p)] = refs.get(int(p), 0) + 1
        for e in self.index._entries.values():
            for p in e.pages:
                refs[int(p)] = refs.get(int(p), 0) + 1
        for p in range(self.num_pages):
            assert self.alloc.refcount[p] == refs.get(p, 0), \
                f"page {p}: refcount {self.alloc.refcount[p]} != " \
                f"holders {refs.get(p, 0)}"


# ----------------------------------------------------------------------
# Device-side page copy (COW) over every paged KV sub-block
# ----------------------------------------------------------------------
def make_page_copy(sharder=None):
    """(cache, src, dst) -> cache with pool[dst] = pool[src] in every
    layer of every paged KV sub-block, written in place. `src`/`dst` are
    equal-length host int vectors; entries with dst == num_pages are
    padding and are dropped (as the reference's fixed-shape copy drops
    them).

    Under a ``sharder`` whose pool is chunked by pages over the ranks
    (``sharder.pool_pages``) each rank holds pages [r*chunk, (r+1)*chunk):
    a copy within one rank's chunk is local to it, and across ranks the
    owner of `src` broadcasts the page over 'model' for the owner of `dst`
    to store (the reference's jitted copy leaves that to GSPMD); every
    rank takes part in every broadcast, in one order."""

    def copy(cache, src, dst):
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        pools = [sub[key] for sub in cache["main"].values() if "pt" in sub
                 for key in ("k", "v")]            # (L, P, page, Hkv, D)
        if not pools:
            return cache
        chunk = pools[0].shape[1]
        total = (sharder.pool_pages if sharder is not None
                 and sharder.pool_pages is not None else chunk)
        if total == chunk:
            for pool in pools:
                keep = dst < pool.shape[1]
                s = torch.as_tensor(np.clip(src[keep], 0, pool.shape[1] - 1),
                                    device=pool.device)
                d = torch.as_tensor(dst[keep], device=pool.device)
                pool[:, d] = pool[:, s]
            return cache
        from repro_torch.sharding import comm
        mesh = sharder.mesh
        me = mesh.index("model")
        for s_pg, d_pg in zip(src.tolist(), dst.tolist()):
            if d_pg >= total:
                continue
            (so, sl), (do, dl) = divmod(s_pg, chunk), divmod(d_pg, chunk)
            if so == do:
                if so == me:
                    for pool in pools:
                        pool[:, dl] = pool[:, sl]
                continue
            page = torch.stack([pool[:, sl] for pool in pools])
            page = comm.broadcast(page, so, "model", mesh)
            if do == me:
                for pool, rows in zip(pools, page):
                    pool[:, dl] = rows
        return cache
    return copy
