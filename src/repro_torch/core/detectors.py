"""Tier-3 waste detectors (DESIGN.md §2) of the training and serving
loops, plus the tier-4 kernel counters of the serving kernels.

Training loop (``TrainingDetectors``, port of the reference's
``detectors.py:95-186``):

  silent parameter stores — a parameter leaf whose post-optimizer value
      equals its pre-step value within tolerance (frozen/dead subnetwork,
      zero grads): the optimizer "stored the same value" (Def. 2);
  dead gradient stores    — gradient leaves that are (near-)all-zero: the
      backward pass produced bytes nobody needed (Def. 1 flavour);
  silent data loads       — repeated identical batches from the pipeline
      (MemEvent content digest), Def. 3 at the input boundary.

The leaf comparison is ``ops.silent_fraction``: on CUDA leaves the
silent-compare kernel (2 reads per element), on CPU leaves its plain
version. Under a sharded train step (``mesh`` and the param ``specs``)
each rank holds a block of every leaf: every rank draws the same leaves
(one seed), counts the silent elements of its block with the kernel,
and the counts are summed over the axes the leaf is sharded over, so
the fraction and the bytes are the whole leaf's, as the reference's,
which compares global arrays.

Serving loop (``ServingDetectors``): the serving engine's fixed-size
decode batch keeps writing the KV cache whether or not a slot serves a
live request:

  dead KV stores     — K/V rows written for slots past a request's end
      (idle/finished slots still written every step, or a finished
      request's rows overwritten at recycle without a live read): Def. 1
      at request granularity;
  silent KV stores   — inactive slots rewriting the same K/V site with
      identical values (frozen token + frozen write index): Def. 2;
  silent prefix loads — duplicate prompt prefixes by content digest:
      the prefill re-reads (and recomputes K/V for) a prefix another
      request already paid for — a prefix-cache opportunity (Def. 3).

Tier 3 samples K/V sites with reservoir watchpoints; the value compare
runs on the host over the sampled site's few values, as in the
reference. Tier 4 (``on_kernel_store``) is exhaustive: the paged
kernels count [stored, silent, dropped] elements at every store site,
and the engine feeds the per-layer counts here.
"""
from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ProfilerConfig
from repro_torch.core.events import LOAD, STORE, MemEvent
from repro_torch.core.findings import Finding, WasteProfile
from repro_torch.core.reservoir import ReservoirWatchpoints, Watchpoint
from repro_torch.kernels import ops

# power-of-two prefix granularities shared by the Def.-3 prefix-load
# detector and the paged prefix cache (serve.kv_cache) — one ladder, so
# what the detector calls a duplicate is exactly what the cache can reuse
PREFIX_POW2 = (8, 16, 32, 64, 128, 256, 512, 1024)


def _leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of a nested-dict tree in the reference's order: keys
    sorted at every level and paths spelled as ``jax.tree_util.keystr``
    spells them (``['main']['b0_dense']['attn']['wq']['w']``), so the
    seeded leaf draws pick the same leaves as the reference's."""
    if isinstance(tree, dict):
        return [pl for key in sorted(tree)
                for pl in _leaf_paths(tree[key], f"{prefix}[{key!r}]")]
    return [(prefix, tree)]


def _leaf_event(path: str, leaf) -> MemEvent:
    # metadata from the tensor or array; the leaf is held by reference.
    # crc32, not hash(): Python string hashing is salted per process,
    # so hash()-derived addresses would change trap/disarm behavior
    # from run to run
    itemsize = (leaf.element_size() if torch.is_tensor(leaf)
                else leaf.dtype.itemsize)
    return MemEvent(kind=STORE, address=zlib.crc32(path.encode()) & 0x7FFFFFFF,
                    nelems=int(np.prod(leaf.shape)), itemsize=int(itemsize),
                    values=leaf, ctx=(path,))


class TrainingDetectors:
    """Attach to a training loop; call ``on_batch`` with each host batch
    and ``on_step`` with the params before and after each step."""

    def __init__(self, cfg: Optional[ProfilerConfig] = None,
                 leaves_per_step: int = 4, *, mesh=None, specs=None):
        self.cfg = cfg or ProfilerConfig(enabled=True)
        # a sharded step's mesh and param spec tree (by leaf path)
        self.mesh = mesh
        self._specs = None if specs is None else dict(_leaf_paths(specs))
        self.tol = self.cfg.fp_tolerance
        self.leaves_per_step = leaves_per_step
        self.wp = ReservoirWatchpoints(self.cfg.num_watchpoints,
                                       self.cfg.seed)
        self.rng = np.random.RandomState(self.cfg.seed)
        self.report = WasteProfile(tier=3)
        # bounded LRU of batch-content digests: a long run must not grow
        # memory without limit (window from ProfilerConfig)
        self._batch_hashes: "OrderedDict[str, int]" = OrderedDict()
        self._hash_window = max(1, self.cfg.batch_hash_window)

    def _found(self, step: int, kind: str, path: str,
               frac: float, nbytes: float) -> Finding:
        f = Finding(kind=kind, tier=3, c1=(path,), fraction=frac,
                    step=step, bytes=nbytes, meta={"path": path})
        self.report.add(f)
        return f

    def _silent(self, path: str, a, b, tol: float) -> Tuple[float, int]:
        """(silent fraction, bytes) of the whole leaf at ``path``: a and b
        are its values before and after (under a mesh, this rank's
        blocks, each rank counting its own and the counts summed over
        the leaf's shard axes)."""
        if self.mesh is None:
            return (ops.silent_fraction(a, b, tol=tol),
                    _leaf_event(path, b).nbytes)
        from repro_torch.sharding import comm
        from repro_torch.sharding.rules import global_shape, spec_axes
        spec = self._specs[path]
        n = max(int(np.prod(global_shape(b.shape, spec, self.mesh))), 1)
        cnt = comm.all_reduce(ops.silent_count(a, b, tol),
                              spec_axes(spec), self.mesh)
        return float(cnt.to(torch.float32) / n), n * b.element_size()

    # ------------------------------------------------------------------
    def on_step(self, step: int, params_before, params_after,
                grads=None) -> List[Finding]:
        """Sample leaves; compare watched leaves before/after (Def. 2).
        ``params_before`` must be other tensors than ``params_after``
        (the train step makes fresh compute params)."""
        out: List[Finding] = []
        before = dict(_leaf_paths(params_before))
        after = dict(_leaf_paths(params_after))

        # traps: previously armed watchpoints observe this step's store
        for wp in list(self.wp.armed()):
            path = wp.meta
            if path in after:
                frac, nbytes = self._silent(path, before[path], after[path],
                                            self.tol)
                silent = frac > 0.99
                self.report.observe("silent_param_store", silent)
                if silent:
                    out.append(self._found(step, "silent_param_store",
                                           path, frac, nbytes))
            self.wp.disarm(wp)

        # arm new watchpoints on sampled leaf-store events (reservoir
        # discipline over the substrate's event type)
        paths = list(after)
        for _ in range(min(self.leaves_per_step, len(paths))):
            p = paths[self.rng.randint(len(paths))]
            ev = _leaf_event(p, after[p])
            self.wp.on_sample(Watchpoint(
                address=ev.address, offset=0, size=ev.itemsize,
                value=None, context=ev.ctx, trap_type="W_TRAP", meta=p))

        # dead gradient stores (value-agnostic: all-zero grad leaves)
        if grads is not None:
            gleaves = _leaf_paths(grads)
            for _ in range(min(self.leaves_per_step, len(gleaves))):
                p, g = gleaves[self.rng.randint(len(gleaves))]
                zero_frac, nbytes = self._silent(p, g, torch.zeros_like(g),
                                                 0.0)
                dead = zero_frac > 0.99
                self.report.observe("dead_grad_store", dead)
                if dead:
                    out.append(self._found(step, "dead_grad_store", p,
                                           zero_frac, nbytes))
        return out

    # ------------------------------------------------------------------
    def on_batch(self, step: int, batch) -> List[Finding]:
        """Silent data loads: identical batch content re-delivered.
        ``batch`` is the host (numpy) batch, as the reference digests it."""
        out: List[Finding] = []
        for path, leaf in _leaf_paths(batch):
            ev = _leaf_event(path, leaf)
            key = f"{path}:{ev.digest()}"
            dup = key in self._batch_hashes
            self.report.observe("silent_data_load", dup)
            if dup:
                out.append(self._found(step, "silent_data_load", path,
                                       1.0, ev.nbytes))
                self._batch_hashes.move_to_end(key)
            self._batch_hashes[key] = step
            while len(self._batch_hashes) > self._hash_window:
                self._batch_hashes.popitem(last=False)
        return out


class SlotWrite:
    """One decode-batch slot's K/V write in the current engine tick.

    Sites are addressed as (page, offset) so watchpoints survive page
    remapping in the paged KV layout; the dense layout is the degenerate
    case page == slot row, offset == position."""

    __slots__ = ("slot", "rid", "active", "pos", "page", "offset")

    def __init__(self, slot: int, rid: Optional[str], active: bool,
                 pos: int, page: Optional[int] = None,
                 offset: Optional[int] = None):
        self.slot = slot
        self.rid = rid
        self.active = active
        self.pos = pos
        self.page = slot if page is None else page
        self.offset = pos if offset is None else offset


class VerifyWrite:
    """One slot's speculative verify-window K/V stores in one tick.

    ``sites`` lists the draft rows actually stored this tick, in window
    order, as (page, offset, rejected): rejected rows are Def.-1 dead
    stores (written for a token past the accept point, never read by the
    request, overwritten by the next window). Under rollback the engine
    never stores rejected rows, so every site arrives with
    rejected=False."""

    __slots__ = ("slot", "rid", "accepted", "sites")

    def __init__(self, slot: int, rid: str, accepted: int,
                 sites: Sequence[Tuple[int, int, bool]]):
        self.slot = slot
        self.rid = rid
        self.accepted = accepted
        self.sites = list(sites)


class ServingDetectors:
    """Serve-side tier 3: KV-cache waste at request granularity.

    Attach to a ``serve.engine.ServeEngine`` (it calls ``bind`` once and
    then ``on_admit`` / ``on_finish`` / ``on_step`` / ``on_page_free`` /
    ``on_verify`` as the schedule advances, in the reference engine's order: the sampled
    watchpoints draw from one seeded RandomState, so the order is part of
    the result). A sampled K/V *site* (layer, page, offset) arms one
    reservoir watchpoint for one client — dead (value-agnostic) or silent
    (holds the written value) — and traps on the next store to that site.
    ⟨C1,C2⟩ is the arming request/layer and the trapping request/step.
    In the paged layout, armed watchpoints on a freed page disarm without
    classification (``on_page_free``).
    """

    def __init__(self, cfg: Optional[ProfilerConfig] = None,
                 sites_per_step: int = 2):
        self.cfg = cfg or ProfilerConfig(enabled=True)
        self.tol = self.cfg.fp_tolerance
        self.sites_per_step = sites_per_step
        self.wp = ReservoirWatchpoints(self.cfg.num_watchpoints,
                                       self.cfg.seed)
        self.rng = np.random.RandomState(self.cfg.seed)
        self.report = WasteProfile(tier=3)
        # bounded LRU of prompt-prefix digests -> (step, C1 of first load)
        self._prefix_hashes: "OrderedDict[str, Tuple[int, Tuple[str, ...]]]" \
            = OrderedDict()
        self._hash_window = max(1, self.cfg.batch_hash_window)
        self.num_layers = 1
        self.site_bytes = 0
        self.paged = False
        # kernel tier (tier 4): exhaustive in-kernel store-site counters,
        # kept as its own profile so the §5.6 merge composes it with the
        # sampled tier-3 report without mixing estimator populations
        self.kernel = WasteProfile(tier=4)
        self.kv_itemsize = 4
        self.row_elems: dict = {}

    def bind(self, *, num_layers: int, site_bytes: int,
             paged: bool = False, kv_itemsize: int = 4,
             row_elems: Optional[dict] = None) -> None:
        """Engine geometry: layer count, bytes per K/V site, KV layout,
        bytes per stored element and, per KV sub-block, the K+V element
        count of one stored row (2 * Hkv * D)."""
        self.num_layers = max(1, num_layers)
        self.site_bytes = site_bytes
        self.paged = paged
        self.kv_itemsize = kv_itemsize
        self.row_elems = dict(row_elems or {})

    # -- kernel tier (in-kernel store-site counters) -------------------
    def on_kernel_store(self, step: int, site: str, counts) -> None:
        """Merge one forward's in-kernel waste counters.

        counts: per KV sub-block name, an (L, B, 3) int array of
        [stored, silent, dropped] ELEMENT counts measured at the paged
        store site (L = layers, B = slots). Exhaustive, not sampled.
        ``site`` names the store site (prefill / decode); findings
        coalesce per (site, sub-block, layer)."""
        isz = self.kv_itemsize
        for name, c in counts.items():
            c = np.asarray(c)
            per_layer = c.sum(axis=1)                      # (L, 3)
            stored = int(per_layer[:, 0].sum())
            silent = int(per_layer[:, 1].sum())
            dropped = int(per_layer[:, 2].sum())
            k = self.kernel
            k.bump_total("kernel_store_elems", stored)
            k.bump_total("kernel_silent_elems", silent)
            k.bump_total("kernel_dropped_elems", dropped)
            k.checked["kernel_silent_store"] = \
                k.checked.get("kernel_silent_store", 0) + stored
            k.flagged["kernel_silent_store"] = \
                k.flagged.get("kernel_silent_store", 0) + silent
            k.checked["kernel_dead_store"] = \
                k.checked.get("kernel_dead_store", 0) + stored + dropped
            k.flagged["kernel_dead_store"] = \
                k.flagged.get("kernel_dead_store", 0) + dropped
            for layer in range(per_layer.shape[0]):
                st, si, dr = (int(x) for x in per_layer[layer])
                if si:
                    k.add_pair("kernel_silent_store", 4,
                               (f"kernel:{site}", name, f"layer:{layer}"),
                               (f"serve.engine:{site}",), si * isz,
                               stored_bytes=st * isz)
                if dr:
                    k.add_pair("kernel_dead_store", 4,
                               (f"kernel:{site}", name, f"layer:{layer}"),
                               (f"serve.engine:{site}",), dr * isz,
                               stored_bytes=st * isz)

    def on_kernel_verify(self, step: int, counts, accepted, draft_len,
                         active) -> None:
        """Classify one verify tick's kernel counters against the accept
        point (measured in the kernel, classified on the host).

        counts: as in ``on_kernel_store``; under overwrite the verify
        forward's full-window stores, under rollback the commit's
        accepted-prefix stores (the deferred window stored nothing).
        accepted/draft_len/active: (B,) accept counts m, real draft
        counts, live mask. Per slot the stored rows are stored elements
        / row elements; stored drafts past the m accepted are rejected,
        so the flagged count is the rejected drafts under overwrite and
        exactly 0 when only the accepted prefix was committed."""
        self.on_kernel_store(step, "verify", counts)
        accepted = np.asarray(accepted)
        draft_len = np.asarray(draft_len)
        active = np.asarray(active)
        k = self.kernel
        for name, c in counts.items():
            re = self.row_elems.get(name)
            if not re:
                continue
            c = np.asarray(c)
            # layers store identically; measure rows from layer 0
            rows_stored = c[0, :, 0] // re                 # (B,)
            for b in range(c.shape[1]):
                if not active[b] or draft_len[b] == 0:
                    continue
                drafts_stored = min(int(draft_len[b]),
                                    max(0, int(rows_stored[b]) - 1))
                rejected = max(0, drafts_stored - int(accepted[b]))
                k.checked["kernel_rejected_draft_store"] = \
                    k.checked.get("kernel_rejected_draft_store", 0) \
                    + int(draft_len[b])
                k.flagged["kernel_rejected_draft_store"] = \
                    k.flagged.get("kernel_rejected_draft_store", 0) \
                    + rejected
                if rejected:
                    k.add_pair(
                        "kernel_rejected_draft_store", 4,
                        ("kernel:verify", name),
                        ("serve.engine:verify",),
                        rejected * re * self.kv_itemsize * c.shape[0],
                        accepted=int(accepted[b]))

    def combined(self) -> WasteProfile:
        """Tier-3 sampled report + tier-4 kernel counters, §5.6-merged."""
        out = WasteProfile()
        out.merge(self.report)
        out.merge(self.kernel)
        return out

    # -- silent prefix loads -------------------------------------------
    @staticmethod
    def _prefix_lengths(n: int) -> List[int]:
        """Power-of-two prefixes (≥8) plus the full prompt, shortest
        first, so shared prefixes of different-length prompts match."""
        out = [p for p in PREFIX_POW2 if p < n]
        out.append(n)
        return out

    def on_admit(self, step: int, slot: int, rid: str,
                 tokens: np.ndarray,
                 padded_len: Optional[int] = None,
                 reuse_len: int = 0) -> List[Finding]:
        """Admission: prefix-digest dedup + recycle traps for the slot.

        padded_len: extent of the prefill's store sweep (dense layout),
        None when the prefill sweeps no stale rows (paged layout).
        reuse_len: prompt positions served from the prefix cache — only a
        duplicated prefix LONGER than this was re-loaded and
        re-computed."""
        out: List[Finding] = []
        tokens = np.asarray(tokens)
        swept = max(int(padded_len or 0), tokens.size)
        ctx2 = ("serve.engine:prefill", f"req:{rid}", f"slot:{slot}")

        plens = self._prefix_lengths(tokens.size)
        hit: Optional[Tuple[int, Tuple[str, ...]]] = None
        keys = []
        for plen in plens:
            ev = MemEvent(kind=LOAD, address=slot, nelems=plen,
                          itemsize=int(tokens.dtype.itemsize),
                          values=tokens[:plen], ctx=ctx2)
            key = f"prefix{plen}:{ev.digest()}"
            keys.append(key)
            if key in self._prefix_hashes and plen > reuse_len:
                hit = (plen, self._prefix_hashes[key][1])
        self.report.observe("silent_prefix_load", hit is not None)
        if hit is not None:
            plen, c1 = hit       # longest re-paid duplicated prefix wins
            f = self.report.add_pair(
                "silent_prefix_load", 3, c1, ctx2,
                (plen - reuse_len) * int(tokens.dtype.itemsize),
                prefix_len=plen, reuse_len=reuse_len)
            out.append(f)
        for key in keys:
            if key in self._prefix_hashes:
                self._prefix_hashes.move_to_end(key)
            else:
                self._prefix_hashes[key] = (step, ctx2)
        while len(self._prefix_hashes) > self._hash_window:
            self._prefix_hashes.popitem(last=False)

        # recycle traps (dense layout only): the prefill store sweeps
        # [0, padded_len) of this slot's rows — watched sites there are
        # overwritten now. Silent-client watchpoints disarm without
        # classification (the old value is gone); dead-client ones
        # classify: no live read since arming ⇒ dead.
        if not self.paged:
            for wp in list(self.wp.armed()):
                m = wp.meta
                if m["slot"] != slot or m["pos"] >= swept:
                    continue
                if m["client"] == "dead_kv_store":
                    dead = not m["live"]
                    self.report.observe("dead_kv_store", dead)
                    if dead:
                        f = self.report.add_pair("dead_kv_store", 3,
                                                 wp.context, ctx2, wp.size)
                        out.append(f)
                self.wp.disarm(wp)
        return out

    def on_finish(self, step: int, slot: int, rid: str) -> None:
        """Request ended: its armed sites can no longer be live-read."""
        for wp in self.wp.armed():
            if wp.meta["slot"] == slot and wp.meta["rid"] == rid:
                wp.meta["live"] = False

    def on_page_free(self, pages: Sequence[int]) -> None:
        """Paged layout: recycling freed these pool pages, so armed traps
        on them are stale and disarm without classification."""
        freed = set(int(p) for p in pages)
        if not freed:
            return
        for wp in list(self.wp.armed()):
            if wp.meta.get("page") in freed:
                self.wp.disarm(wp)

    # -- speculative verify (rejected-draft dead stores) ---------------
    def on_verify(self, step: int,
                  entries: Sequence[VerifyWrite]) -> List[Finding]:
        """One verify tick's draft-row K/V stores (Def. 1 at the
        speculative-decode site): every proposed-and-stored draft row is
        checked and rows past the accept point are flagged, dead by
        construction. Exact accounting, no sampling: the engine knows
        which rows it stored and where the accept point fell. A rejected
        row is written in every layer, so it costs site_bytes *
        num_layers."""
        out: List[Finding] = []
        for e in entries:
            for page, off, rejected in e.sites:
                self.report.observe("rejected_draft_store", rejected)
                if rejected:
                    # derived, not drawn: a draw from the shared RNG would
                    # shift the other detectors' sampling between the
                    # overwrite and rollback runs of one seed
                    layer = (page * 131 + off) % self.num_layers
                    out.append(self.report.add_pair(
                        "rejected_draft_store", 3,
                        ("serve.spec:draft", f"req:{e.rid}"),
                        ("serve.engine:verify", f"slot:{e.slot}"),
                        self.site_bytes * self.num_layers,
                        layer=layer, page=page, offset=off,
                        accepted=e.accepted))
        return out

    # -- per-tick watchpoints ------------------------------------------
    def on_step(self, step: int, writes: Sequence[SlotWrite],
                peek: Callable[[int, int, int], Any]) -> List[Finding]:
        """One engine decode tick's K/V stores.

        writes: per-slot view of this tick's stores, addressed by
        (page, offset) site — every slot in the dense layout, live slots
        only in the paged layout (idle stores were dropped).
        peek(layer, page, offset) -> the K/V values now at that site
        (host numpy, f32).
        """
        out: List[Finding] = []
        by_site = {(w.page, w.offset): w for w in writes}

        for wp in list(self.wp.armed()):
            m = wp.meta
            w = by_site.get((m["page"], m["offset"]))
            if w is None:
                continue                 # no store at the watched site
            ctx2 = (f"serve.engine:step{step}", f"slot:{w.slot}",
                    f"req:{w.rid or 'idle'}")
            if m["client"] == "dead_kv_store":
                # Def. 1 analogue: the armed store was overwritten with no
                # live-request read in between
                dead = not m["live"]
                self.report.observe("dead_kv_store", dead)
                if dead:
                    out.append(self.report.add_pair(
                        "dead_kv_store", 3, wp.context, ctx2, wp.size))
            else:
                # Def. 2 analogue: same site rewritten with the same value
                cur = np.asarray(peek(m["layer"], w.page, w.offset))
                frac = ops.silent_fraction(wp.value, cur, tol=self.tol)
                silent = frac > 0.99
                self.report.observe("silent_kv_store", silent)
                if silent:
                    out.append(self.report.add_pair(
                        "silent_kv_store", 3, wp.context, ctx2, wp.size))
            self.wp.disarm(wp)

        # arm: sample this tick's written sites; one client per sample
        k = min(self.sites_per_step, len(writes))
        if k > 0:
            for i in self.rng.choice(len(writes), size=k, replace=False):
                w = writes[int(i)]
                layer = int(self.rng.randint(self.num_layers))
                client = ("dead_kv_store" if self.rng.randint(2) == 0
                          else "silent_kv_store")
                value = None
                if client == "silent_kv_store":
                    value = np.asarray(peek(layer, w.page, w.offset))
                c1 = (f"serve.kv[{layer}]", f"page:{w.page}",
                      f"req:{w.rid or 'idle'}")
                self.wp.on_sample(Watchpoint(
                    address=(layer << 40) | (w.page << 20) | w.offset,
                    offset=w.offset, size=self.site_bytes, value=value,
                    context=c1,
                    trap_type="RW_TRAP" if client == "dead_kv_store"
                    else "W_TRAP",
                    meta={"client": client, "layer": layer,
                          "page": w.page, "offset": w.offset,
                          "slot": w.slot, "pos": w.pos, "rid": w.rid,
                          "live": w.active}))
        return out
