"""Multi-replica fleet router with prefix-aware placement
(DESIGN.md § Fleet tier).

`FleetRouter` spreads a request stream over N in-process `ServeEngine`
replicas, each with its own paged pool and slot budget. Three routing
policies:

  * ``prefix`` — consult the fleet's `GlobalPrefixIndex`: a request
    whose prompt has a globally resident prefix of at least
    `min_route_len` tokens routes to the OWNING replica (taking a
    refcount lease on the pages so they survive until admission), where
    `PagedKV.admit` maps them in instead of re-prefilling. Falls back
    to least-loaded placement when there is no useful match or the
    owner is saturated.
  * ``least`` — least-loaded (queue depth + live slots), the classic
    baseline.
  * ``random`` — uniform over replicas with capacity; the honest
    strawman prefix routing must beat.

Admission control and backpressure: each replica accepts at most
`max_inflight` requests (queued + live); when every replica is
saturated, dispatch stops for the tick and the backlog waits (counted
in ``stats["backpressure"]``). Pool pressure inside a replica
(`admit_deferred` growing) triggers preemption-safe relief: the router
evicts that replica's OWN global-prefix pins (`evict_for`) — never
another replica's, and never a page a live slot or lease still holds —
so the deferred admission can retry next tick.

The router is also a measurement instrument: per-request TTFT/TPOT wall
times, per-replica queue depths, and a fleet-level Tier-3
`WasteProfile` charging ``fleet_silent_prefix_load`` bytes whenever a
request re-prefilled a prefix that was resident on SOME replica at
dispatch time (Def. 3 at fleet scale — the redundancy the prefix policy
exists to eliminate; random routing pays it on every misroute).

Port of src/repro/serve/router.py (host-side numpy, unchanged; the
replicas it steps run their forwards on their own device). Request
tokens stay numpy int32, so a fleet charge counts 4 bytes a token, as
the reference's does.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.findings import WasteProfile
from repro_torch.serve.engine import MonotonicStats, Request, ServeEngine
from repro_torch.serve.kv_cache import _digest
from repro_torch.serve.global_prefix import GlobalPrefixIndex
from repro_torch.serve.workload import Trace, TraceRequest

POLICIES = ("prefix", "least", "random")


class FleetRouter:
    """Route a request stream over N `ServeEngine` replicas."""

    def __init__(self, engines: List[ServeEngine], *,
                 policy: str = "prefix", seed: int = 0,
                 min_route_len: int = 8,
                 max_inflight: Optional[int] = None,
                 global_window: int = 64,
                 content_dedup: bool = False):
        assert engines, "a fleet needs at least one replica"
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}")
        self.engines = list(engines)
        self.policy = policy
        self.min_route_len = min_route_len
        # default inflight cap: a queue as deep as the slot count keeps
        # prefill groups full without unbounded per-replica pile-up
        self.max_inflight = (max_inflight if max_inflight is not None
                             else 2 * max(e.num_slots for e in engines))
        self._rng = np.random.RandomState(seed)
        paged = all(e.kv is not None for e in engines)
        self.gpi: Optional[GlobalPrefixIndex] = None
        if paged:
            self.gpi = GlobalPrefixIndex(
                dict(enumerate(self.engines)),
                page_size=engines[0].kv.page_size, window=global_window)
        elif policy == "prefix":
            raise ValueError(
                "policy='prefix' needs every replica on kv_layout='paged'")
        self.backlog: Deque[TraceRequest] = deque()
        self._inflight: Dict[str, Tuple[int, Request]] = {}
        self.finished: Dict[str, Request] = {}
        self.tick = 0
        # per-request measurement: wall stamps + dispatch-time routing
        # facts (expected global reuse, owner) for waste attribution
        self.metrics: Dict[str, Dict] = {}
        self.stats = MonotonicStats(
            {"dispatched": 0, "prefix_routes": 0,
             "cross_replica_prefix_routes": 0, "fallback_routes": 0,
             "backpressure_ticks": 0, "backpressure_requests": 0,
             "preemption_evicted_pages": 0, "global_evictions": 0,
             "content_dedup_routes": 0})
        # content-addressed dedup of DISPATCHED-but-unpublished prefixes
        # (OJXPerf replica fix, fleet side): the global prefix tier only
        # knows a prefix after its owner admits+publishes, so two
        # same-burst duplicates route independently and each replica
        # computes its own bit-identical pages. With `content_dedup` the
        # router keys every in-flight request's page-aligned prefix
        # digests to its replica and sends later duplicates THERE, where
        # the engine's own same-burst defer (engine.content_dedup) turns
        # them into PrefixIndex hits on the leader's pages.
        self.content_dedup = bool(content_dedup) and paged
        self._inflight_digests: Dict[str, Tuple[int, int]] = {}
        self._rid_digests: Dict[str, List[str]] = {}
        # fleet-level Def.-3 accounting (tier 3: runtime-observed)
        self.profile = WasteProfile(tier=3)
        self.queue_depths: List[List[int]] = [[] for _ in self.engines]
        self._deferred_seen = [0] * len(self.engines)

    # ------------------------------------------------------------------
    def submit(self, treq: TraceRequest) -> None:
        self.backlog.append(treq)

    def submit_trace(self, trace: Trace) -> None:
        for treq in sorted(trace.requests, key=lambda r: r.arrival):
            self.submit(treq)

    @property
    def pending(self) -> int:
        return len(self.backlog) + len(self._inflight)

    def _load(self, i: int) -> int:
        e = self.engines[i]
        return e.queue_depth + e.live_slots

    def _has_capacity(self, i: int) -> bool:
        return self.engines[i].pending < self.max_inflight

    def _least_loaded(self) -> Optional[int]:
        avail = [i for i in range(len(self.engines))
                 if self._has_capacity(i)]
        if not avail:
            return None
        return min(avail, key=lambda i: (self._load(i), i))

    # ------------------------------------------------------------------
    def _route(self, treq: TraceRequest) -> Optional[Tuple[int, Optional[tuple]]]:
        """(replica, prefix_hint) or None when every replica is full.

        The dispatch-time global match is recorded in `metrics` for ALL
        policies — measurement must not depend on whether the policy
        acts on it, or the waste comparison between policies is rigged."""
        L = int(treq.tokens.size)
        g_len, owner, key = 0, None, None
        if self.gpi is not None:
            m = self.gpi.match(treq.tokens)
            if m is not None:
                key, entry = m
                g_len = min(entry.length, L - 1)
                owner = entry.replica
        met = self.metrics.setdefault(treq.rid, {})
        met["global_match_len"] = g_len
        met["owner"] = owner

        fallback = self._least_loaded()
        if (self.policy == "prefix" and key is not None
                and g_len >= self.min_route_len
                and owner is not None and self._has_capacity(owner)):
            lease = self.gpi.lease(key, treq.rid)
            if lease is not None:
                self.stats["prefix_routes"] += 1
                if fallback is not None and fallback != owner:
                    # the prefix overrode load-based placement: the
                    # routing decision crossed replicas through the
                    # global tier (the CI fleet-smoke asserts >= 1)
                    self.stats["cross_replica_prefix_routes"] += 1
                return owner, lease
        if self.content_dedup:
            hit = self._dedup_match(treq)
            if hit is not None and self._has_capacity(hit):
                # an in-flight request on `hit` shares a page-aligned
                # prefix: co-locate so the leader's pages get shared
                # instead of recomputed into cross-replica replicas
                self.stats["content_dedup_routes"] += 1
                return hit, None
        if fallback is None:
            return None
        if self.policy == "random":
            avail = [i for i in range(len(self.engines))
                     if self._has_capacity(i)]
            return int(self._rng.choice(avail)), None
        self.stats["fallback_routes"] += self.policy == "prefix"
        return fallback, None

    def _prefix_keys(self, tokens: np.ndarray) -> List[str]:
        """Page-aligned prefix digest keys of a prompt (same key space
        the engine's same-burst defer uses)."""
        ps = self.engines[0].kv.page_size
        toks = np.asarray(tokens)
        return [f"{m}:{_digest(toks[:m])}"
                for m in range(ps, int(toks.size), ps)]

    def _dedup_match(self, treq: TraceRequest) -> Optional[int]:
        """Replica holding an in-flight request that shares this
        prompt's longest page-aligned prefix (>= min_route_len)."""
        best_len, best = 0, None
        ps = self.engines[0].kv.page_size
        for m, key in zip(range(ps, int(treq.tokens.size), ps),
                          self._prefix_keys(treq.tokens)):
            hit = self._inflight_digests.get(key)
            if hit is not None and m > best_len:
                best_len, best = m, hit[0]
        return best if best_len >= self.min_route_len else None

    def _note_inflight(self, treq: TraceRequest, replica: int) -> None:
        keys = self._prefix_keys(treq.tokens)
        self._rid_digests[treq.rid] = keys
        for key in keys:
            cur = self._inflight_digests.get(key)
            # first dispatcher of a prefix stays its owner; later
            # holders only bump the count that keeps the key alive
            self._inflight_digests[key] = ((replica, 1) if cur is None
                                           else (cur[0], cur[1] + 1))

    def _dispatch(self) -> None:
        blocked = False
        while self.backlog and self.backlog[0].arrival <= self.tick:
            treq = self.backlog[0]
            met = self.metrics.setdefault(treq.rid, {})
            met.setdefault("t_due", time.perf_counter())
            choice = self._route(treq)
            if choice is None:
                # fleet saturated: the head request waits (FIFO — no
                # overtaking, so TTFT percentiles stay honest)
                self.stats["backpressure_requests"] += 1
                blocked = True
                break
            self.backlog.popleft()
            replica, hint = choice
            if self.content_dedup:
                self._note_inflight(treq, replica)
            req = Request(rid=treq.rid, tokens=np.asarray(treq.tokens),
                          max_new_tokens=treq.max_new_tokens,
                          arrival=0, prefix_hint=hint)
            self.engines[replica].submit(req)
            self._inflight[treq.rid] = (replica, req)
            met["replica"] = replica
            self.stats["dispatched"] += 1
        if blocked:
            self.stats["backpressure_ticks"] += 1

    # ------------------------------------------------------------------
    def _relieve_pressure(self, i: int) -> None:
        """A replica deferred an admission under pool pressure: evict
        ITS global-prefix pins until a slot's worth of pages freed (or
        none of its entries remain). Other replicas' pins — and every
        outstanding lease — are untouchable, so a pinned remote prefix
        can never be freed by another pool's pressure."""
        if self.gpi is None:
            return
        want = self.engines[i].kv.max_pages_per_slot
        freed = self.gpi.evict_for(i, want)
        self.stats["preemption_evicted_pages"] += freed

    def _account_admission(self, rid: str, req: Request) -> None:
        """Fleet Def.-3: the request re-prefilled `waste` tokens whose
        K/V was resident on some replica at dispatch time."""
        met = self.metrics[rid]
        g = int(met.get("global_match_len", 0))
        if self.gpi is not None:
            self.gpi.note_admitted(rid)
            self.gpi.publish(met["replica"], req.tokens)
        # admitted + published: the global tier now covers this prompt's
        # prefixes, so the in-flight digest window closes
        for key in self._rid_digests.pop(rid, ()):
            owner_n = self._inflight_digests.get(key)
            if owner_n is not None:
                replica_i, n = owner_n
                if n <= 1:
                    del self._inflight_digests[key]
                else:
                    self._inflight_digests[key] = (replica_i, n - 1)
        if g <= 0:
            return
        waste = max(0, g - int(req.reuse_len))
        self.profile.observe("fleet_silent_prefix_load", waste > 0)
        if waste:
            owner, chosen = met.get("owner"), met["replica"]
            self.profile.add_pair(
                "fleet_silent_prefix_load", 3,
                c1=("serve.global_prefix:resident", f"replica{owner}"),
                c2=("serve.router:dispatch", f"replica{chosen}"),
                nbytes=float(waste * req.tokens.dtype.itemsize),
                tokens=waste, rid=rid)
            self.profile.bump_total("fleet_silent_prefix_tokens", waste)

    def step(self) -> None:
        """One fleet tick: dispatch due requests, step every replica
        with work, then stamp timings / publish prefixes / account
        fleet-level waste and relieve pool pressure."""
        self._dispatch()
        for i, eng in enumerate(self.engines):
            self.queue_depths[i].append(eng.queue_depth)
            if eng.pending:
                eng.step()
            deferred = eng.stats["admit_deferred"]
            if deferred > self._deferred_seen[i]:
                self._deferred_seen[i] = deferred
                self._relieve_pressure(i)
        now = time.perf_counter()
        for rid in list(self._inflight):
            replica, req = self._inflight[rid]
            met = self.metrics[rid]
            if req.prefill_step >= 0 and "t_admit" not in met:
                met["t_admit"] = now
                self._account_admission(rid, req)
            if req.generated and "t_first" not in met:
                met["t_first"] = now
            if req.done:
                met["t_done"] = now
                met["n_generated"] = len(req.generated)
                self.finished[rid] = req
                del self._inflight[rid]
        if self.gpi is not None:
            self.stats["global_evictions"] = max(
                self.stats["global_evictions"], self.gpi.stats["evicted"])
        self.tick += 1

    def run(self, max_ticks: int = 100_000) -> Dict[str, Request]:
        ticks = 0
        while self.pending and ticks < max_ticks:
            self.step()
            ticks += 1
        assert not self.pending, \
            f"fleet did not drain in {max_ticks} ticks " \
            f"({len(self.backlog)} backlogged, {len(self._inflight)} live)"
        return self.finished

    # ---------------------------- reporting ---------------------------
    def latency_summary(self) -> Dict[str, float]:
        """p50/p99 TTFT (due -> first token) and TPOT (per-token decode
        time after the first), seconds, over finished requests."""
        ttft = [m["t_first"] - m["t_due"] for m in self.metrics.values()
                if "t_first" in m and "t_due" in m]
        tpot = [(m["t_done"] - m["t_first"]) / (m["n_generated"] - 1)
                for m in self.metrics.values()
                if "t_done" in m and m.get("n_generated", 0) >= 2]
        out: Dict[str, float] = {}
        if ttft:
            out["ttft_p50"] = float(np.percentile(ttft, 50))
            out["ttft_p99"] = float(np.percentile(ttft, 99))
        if tpot:
            out["tpot_p50"] = float(np.percentile(tpot, 50))
            out["tpot_p99"] = float(np.percentile(tpot, 99))
        return out

    def queue_summary(self) -> List[Dict[str, float]]:
        return [{"replica": i,
                 "mean_depth": float(np.mean(d)) if d else 0.0,
                 "max_depth": int(max(d)) if d else 0}
                for i, d in enumerate(self.queue_depths)]

    def prefix_hit_fraction(self) -> float:
        hit = sum(e.stats["prefix_hit_tokens"] for e in self.engines)
        tot = sum(e.stats["prefill_tokens"] for e in self.engines)
        return hit / tot if tot else 0.0

    def fleet_waste_bytes(self) -> float:
        """Total fleet-level silent-prefix-load bytes this run charged."""
        return sum(f.bytes for f in self.profile.findings
                   if f.kind == "fleet_silent_prefix_load")

    def check(self) -> None:
        """Fleet-wide refcount audit: every replica's pool must balance
        against its local holders PLUS the global tier's pins/leases,
        and no global entry may reach a freed page."""
        if self.gpi is None:
            return
        self.gpi.check()
        for i, eng in enumerate(self.engines):
            eng.kv.check(extra_holders=self.gpi.holders(i))
