"""Global (fleet-wide) prefix-cache tier (DESIGN.md § Fleet tier).

Each `ServeEngine` replica already dedups duplicated prompts locally
through its `PrefixIndex`, but a fleet re-pays a prefix once per replica
it lands on — Def.-3 silent loads measured ACROSS replicas (the
redundancy fraction of "Redundant Loads: A Software Inefficiency
Indicator", applied with OJXPerf's replica-detection framing: the fix
for cross-replica duplicate KV state is routing plus a shared
content-addressed tier).

`GlobalPrefixIndex` is that tier: one content-digest map over the whole
replica group, ``digest(prompt[:L]) -> (replica, pages)``. It never
copies K/V between pools; it records WHERE a prefix is resident so the
router can send the request there, and it pins the pages through the
owning replica's own `PageAllocator` so they survive the donor slot,
local LRU forgetting, and local pool-pressure eviction alike.

Pin/evict ordering protocol (what makes cross-replica reuse
refcount-safe):

  * **publish** — after a replica prefilled a prompt, the router
    publishes it here; the entry increfs the pages it maps (one global
    pin per entry, on top of whatever local holders exist).
  * **lease** — at dispatch the router takes a per-request lease
    (another incref) on the matched entry's pages. The lease — not the
    entry — is what the admitted request consumes, so the entry may be
    evicted between dispatch and admission without ever exposing a
    freed page: pages stay allocated and, by the COW discipline, shared
    pages are never written, so their contents are immutable while any
    reference exists. The engine releases the lease once `PagedKV.admit`
    has pinned what it mapped.
  * **evict** — dropping an entry decrefs through the OWNING replica's
    allocator and reports pages that actually freed back to that engine
    (`ServeEngine.note_freed`) so its stale detector traps disarm.
    Local pressure eviction can therefore never free a globally pinned
    page (the global pin is a holder its allocator counts), and global
    eviction can never free a page a live slot or lease still holds —
    preemption-safe by construction, property-tested in
    tests/test_fleet.py.

Port of src/repro/serve/global_prefix.py (host-side numpy, unchanged).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.kv_cache import PrefixIndex, prefix_candidates


@dataclass
class GlobalEntry:
    replica: int
    length: int
    pages: Tuple[int, ...]


class GlobalPrefixIndex:
    """digest(prompt[:L]) -> (replica, pages) across the replica group.

    `replicas` maps replica id -> its `ServeEngine`; every engine must
    run the paged KV layout with the same page size. LRU-bounded by
    `window` entries fleet-wide."""

    def __init__(self, replicas: Dict[int, object], page_size: int,
                 window: int = 64):
        for rid, eng in replicas.items():
            assert eng.kv is not None, \
                f"replica {rid} is not paged; the global tier needs " \
                f"kv_layout='paged'"
            assert eng.kv.page_size == page_size, \
                f"replica {rid} page_size {eng.kv.page_size} != {page_size}"
        self.replicas = replicas
        self.page_size = page_size
        self.window = max(1, window)
        self._entries: "OrderedDict[str, GlobalEntry]" = OrderedDict()
        # registered entry lengths (refcounted), same partial-boundary
        # probe fix as the local PrefixIndex: a published prompt can end
        # mid-bucket and must still be probed
        self._lengths: Dict[int, int] = {}
        # outstanding dispatch leases: pages incref'd per routed request
        self._leases: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
        self.stats = {"published": 0, "evicted": 0, "leases": 0}

    def __len__(self) -> int:
        return len(self._entries)

    def _key(self, length: int, tokens: np.ndarray) -> str:
        return PrefixIndex._key(length, tokens)

    # ------------------------------------------------------------------
    def publish(self, replica: int, tokens: np.ndarray) -> None:
        """Mirror this prompt's locally indexed prefix entries (every
        candidate granularity, not just the longest — two prompts that
        share only a SUB-prefix must still meet at the common boundary)
        into the global tier; each entry pins its pages through the
        owning replica's allocator. Idempotent for already-published
        prefixes (LRU touch; first owner wins — routing concentrates
        that traffic there, which is the point)."""
        tokens = np.asarray(tokens)
        kv = self.replicas[replica].kv
        for cand in kv.index.probe_lengths(tokens.size):
            pages = kv.index.lookup(tokens, cand)
            if pages is None:
                continue
            key = self._key(cand, tokens)
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            pages = tuple(int(p) for p in pages)
            kv.alloc.incref(pages)
            self._entries[key] = GlobalEntry(replica, cand, pages)
            self._lengths[cand] = self._lengths.get(cand, 0) + 1
            self.stats["published"] += 1
            while len(self._entries) > self.window:
                self.evict_one()

    def match(self, tokens: np.ndarray) -> Optional[Tuple[str, GlobalEntry]]:
        """Longest globally resident prefix of `tokens`:
        (key, GlobalEntry) or None. Probes the pow2+page candidate
        ladder plus every registered entry length (partial boundaries
        included)."""
        tokens = np.asarray(tokens)
        cands = set(prefix_candidates(tokens.size, self.page_size))
        cands.update(L for L in self._lengths if L < tokens.size)
        best: Optional[Tuple[str, GlobalEntry]] = None
        for cand in sorted(cands):
            key = self._key(cand, tokens)
            e = self._entries.get(key)
            if e is not None and (best is None or cand > best[1].length):
                best = (key, e)
                self._entries.move_to_end(key)
        return best

    # ------------------------------------------------------------------
    def lease(self, key: str, rid: str) -> Optional[Tuple[int, Tuple[int, ...]]]:
        """Pin an entry's pages for one in-flight request (`rid`); the
        returned (length, pages) becomes the request's `prefix_hint`.
        None if the entry vanished since `match`."""
        e = self._entries.get(key)
        if e is None:
            return None
        self.replicas[e.replica].kv.alloc.incref(e.pages)
        self._leases[rid] = (e.replica, e.pages)
        self.stats["leases"] += 1
        return e.length, e.pages

    def lease_replica(self, rid: str) -> Optional[int]:
        lease = self._leases.get(rid)
        return lease[0] if lease is not None else None

    def drop_lease(self, rid: str) -> None:
        """Release a dispatch lease the ENGINE could not consume (the
        request was cancelled before admission). Leases consumed at
        admission are released by the engine itself via `PagedKV`."""
        lease = self._leases.pop(rid, None)
        if lease is not None:
            replica, pages = lease
            eng = self.replicas[replica]
            eng.note_freed(eng.kv.release(pages))

    def note_admitted(self, rid: str) -> None:
        """The engine consumed (and released) this request's lease."""
        self._leases.pop(rid, None)

    # ------------------------------------------------------------------
    def evict_one(self) -> Optional[Tuple[int, List[int]]]:
        """Drop the LRU entry; decrefs through the owner's allocator and
        disarms the owner's stale traps on pages that actually freed.
        Returns (replica, freed_pages) or None when empty."""
        if not self._entries:
            return None
        key = next(iter(self._entries))
        return self._evict(key)

    def evict_for(self, replica: int, want_pages: int) -> int:
        """Pool pressure on `replica`: drop ITS LRU entries until
        `want_pages` pages came free there or none of its entries
        remain. Returns pages actually freed. Entries owned by other
        replicas are untouched — their pins are not this pool's
        pressure."""
        freed = 0
        while freed < want_pages:
            key = next((k for k, e in self._entries.items()
                        if e.replica == replica), None)
            if key is None:
                break
            freed += len(self._evict(key)[1])
        return freed

    def _evict(self, key: str) -> Tuple[int, List[int]]:
        e = self._entries.pop(key)
        self._lengths[e.length] -= 1
        if not self._lengths[e.length]:
            del self._lengths[e.length]
        eng = self.replicas[e.replica]
        freed = eng.kv.release(e.pages)
        eng.note_freed(freed)
        self.stats["evicted"] += 1
        return e.replica, freed

    # ------------------------------------------------------------------
    def holders(self, replica: int) -> Dict[int, int]:
        """page -> reference count this tier holds on `replica`'s pool
        (entry pins + outstanding dispatch leases) — feeds
        `PagedKV.check(extra_holders=...)` so the fleet-wide refcount
        audit stays exact."""
        out: Dict[int, int] = {}
        for e in self._entries.values():
            if e.replica == replica:
                for p in e.pages:
                    out[p] = out.get(p, 0) + 1
        for r, pages in self._leases.values():
            if r == replica:
                for p in pages:
                    out[p] = out.get(p, 0) + 1
        return out

    def check(self) -> None:
        """No entry or lease may reference a free page: every pinned
        page must show a live refcount in its owner's allocator."""
        for key, e in self._entries.items():
            alloc = self.replicas[e.replica].kv.alloc
            for p in e.pages:
                assert alloc.refcount[p] > 0, \
                    f"global entry {key} maps freed page {p} " \
                    f"on replica {e.replica}"
        for rid, (replica, pages) in self._leases.items():
            alloc = self.replicas[replica].kv.alloc
            for p in pages:
                assert alloc.refcount[p] > 0, \
                    f"lease {rid} maps freed page {p} on replica {replica}"
