"""Typed memory-event substrate shared by every tier (DESIGN.md §2).

The paper's measurement discipline is a pipeline: memory accesses stream
past a PMU-style sampler (geometric inter-sample gaps ≙ period-P PEBS);
sampled accesses arm reservoir-managed software watchpoints; the next
access to a watched location is the trap, classified per Definitions 1-3
with ⟨C1,C2⟩ context-pair attribution. This module is that pipeline, fed
by tier 1 (the concrete-run recorder, ``core/interpreter.py``) and by the
serving detectors:

  MemEvent          one load/store over a logical buffer (+ value + ctx)
  EventTrace        a recorded flat event stream (trace→replay profiling:
                    record once, replay the trace for epochs 2..N)
  GeometricSampler  the PMU analogue (one sample every ~period events)
  EventEngine       sampler + watchpoints + trap classification, writing
                    into a shared findings.WasteProfile

plus the single approximate-equality definition of "silent" (symmetric
relative tolerance) used by the trap compares, the detectors, the
kernel-tier store counters and their plain versions.

An event's values are a numpy array or a tensor on any device, held by
reference. The engine reads an event's sampled and trapped elements in
one gather (one device sync per event, not per sample); ``digest`` is
the only accessor that moves a whole value to the host.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ProfilerConfig
from repro_torch.core.findings import WasteProfile
from repro_torch.core.reservoir import ReservoirWatchpoints, Watchpoint

LOAD = "load"
STORE = "store"


# ----------------------------------------------------------------------
# The one "silent" comparison (paper Defs. 2-3, FP tolerance default 1%).
# Symmetric relative tolerance: |a-b| <= tol*max(|a|,|b|).
# ----------------------------------------------------------------------
def silent_mask(a, b, tol: float):
    """Elementwise silent-match mask; torch tensors or numpy arrays in,
    bool array of the same kind out. NaNs are never silent. tol=0 gives
    exact (integer) equality."""
    mod = np if isinstance(a, np.ndarray) else torch
    if tol == 0.0:
        eq = a == b
    else:
        eq = mod.abs(a - b) <= tol * mod.maximum(mod.abs(a), mod.abs(b))
    return eq & ~mod.isnan(a) & ~mod.isnan(b)


def approx_equal(a, b, tol: float) -> bool:
    """Scalar form of silent_mask — tier 1's per-element trap compare."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.dtype.kind in "fc":
        fa, fb = float(np.real(a)), float(np.real(b))
        if np.isnan(fa) or np.isnan(fb):
            return False
        return abs(fa - fb) <= tol * max(abs(fa), abs(fb))
    return bool(a == b)


# ----------------------------------------------------------------------
def _gather(values, offsets: Sequence[int]) -> np.ndarray:
    """Elements at flat (C-order) `offsets` of a numpy array or tensor,
    as a host numpy array, in one read. bfloat16 widens to float32
    (exactly: numpy has no bfloat16)."""
    if isinstance(values, np.ndarray):
        return values.reshape(-1)[np.asarray(offsets, np.int64)]
    t = values
    if t.is_contiguous():
        idx = torch.as_tensor(offsets, dtype=torch.int64, device=t.device)
        sel = t.reshape(-1)[idx]
    else:
        coords = np.unravel_index(np.asarray(offsets, np.int64), tuple(t.shape))
        sel = t[tuple(torch.as_tensor(c, device=t.device) for c in coords)]
    if sel.dtype == torch.bfloat16:
        sel = sel.float()
    return sel.cpu().numpy()


@dataclass
class MemEvent:
    """One load/store of `nelems` elements at logical address `address`."""
    kind: str                       # LOAD | STORE
    address: int
    nelems: int
    itemsize: int
    values: object                  # full stored/loaded value (by ref):
                                    # numpy array, tensor or None
    ctx: Tuple[str, ...]            # full calling context of the access

    @property
    def nbytes(self) -> int:
        return self.nelems * self.itemsize

    def values_at(self, offsets: Sequence[int]) -> List[Optional[object]]:
        """Elements at `offsets` (numpy scalars), read in one gather; None
        for an offset outside the event's value extent. A watchpoint armed
        at a high offset can trap on a shorter event at the same
        (recycled) address; clamping would silently compare the wrong
        element, so classification must skip — and disarm — instead."""
        vals = self.values
        if vals is None:
            return [None] * len(offsets)
        if torch.is_tensor(vals):
            size = vals.numel()
        else:
            vals = np.asarray(vals)
            size = vals.size
        inside = [o for o in offsets if o < size]
        if not inside:
            return [None] * len(offsets)
        got = iter(_gather(vals, inside))
        return [next(got) if o < size else None for o in offsets]

    def value_at(self, offset: int):
        """Element at `offset`, or None outside the value extent."""
        return self.values_at([offset])[0]

    def digest(self, size: int = 8) -> str:
        """Content fingerprint (silent-data-load hashing). The only
        MemEvent accessor that moves the whole value to the host."""
        vals = self.values
        if torch.is_tensor(vals):
            vals = vals.detach().cpu().numpy()
        arr = np.ascontiguousarray(np.asarray(vals))
        return hashlib.blake2b(arr.tobytes(), digest_size=size).hexdigest()


class EventTrace:
    """Flat recorded event stream of one profiled epoch.

    Recording happens during the single concrete run; replay pushes the
    identical stream through a fresh-epoch EventEngine without running a
    single operation again (values are held by reference)."""

    def __init__(self):
        self.events: List[MemEvent] = []

    def append(self, ev: MemEvent) -> None:
        self.events.append(ev)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[MemEvent]:
        return iter(self.events)

    @property
    def element_events(self) -> int:
        return sum(ev.nelems for ev in self.events)


# ----------------------------------------------------------------------
class GeometricSampler:
    """PMU-period analogue: i.i.d. geometric gaps with mean `period`.

    `advance(n)` moves past n element-events and returns the offsets of
    the sampled ones."""

    def __init__(self, period: int, rng: np.random.RandomState):
        self.period = max(1, period)
        self.rng = rng
        # the first gap is drawn lazily at the first advance(), so that
        # construct-then-reset (the engine's epoch 0) costs one draw
        self.next_sample: Optional[int] = None

    def draw_gap(self) -> int:
        return max(1, int(self.rng.geometric(1.0 / self.period)))

    def reset(self) -> None:
        """Epoch boundary: discard the partial gap; a fresh one is drawn
        at the next advance() (the RNG stream continues across epochs)."""
        self.next_sample = None

    def advance(self, n: int) -> List[int]:
        if self.next_sample is None:
            self.next_sample = self.draw_gap()
        hits: List[int] = []
        pos = 0
        remaining = n
        while self.next_sample <= remaining:
            pos += self.next_sample
            hits.append(pos - 1)
            remaining -= self.next_sample
            self.next_sample = self.draw_gap()
        self.next_sample -= remaining
        return hits


# ----------------------------------------------------------------------
class EventEngine:
    """Sampler + reservoir watchpoints + Defs. 1-3 trap classification.

    Feed it MemEvents (replayed from an EventTrace, or one at a time); it
    writes pairs and estimator counters into `profile`. Given the same
    event stream and ProfilerConfig it draws the reference engine's gaps,
    arms its watchpoints and writes its profile, bit for bit."""

    def __init__(self, cfg: Optional[ProfilerConfig] = None, tier: int = 1):
        self.cfg = cfg or ProfilerConfig(enabled=True)
        self.tier = tier
        self.tol = self.cfg.fp_tolerance
        self.detect = set(self.cfg.detect)
        self.rng = np.random.RandomState(self.cfg.seed)
        self.sampler = GeometricSampler(self.cfg.period, self.rng)
        # store-side client selection (dead vs silent) draws from its own
        # stream so it never perturbs the sampler's geometric gaps
        self.client_rng = np.random.RandomState(self.cfg.seed + 0x5EED)
        self._store_clients = tuple(
            c for c in ("dead_store", "silent_store") if c in self.detect)
        self.profile = WasteProfile(tier=tier,
                                    sampling_period=self.sampler.period)
        self.wp = {}
        self.reset_epoch()

    def reset_epoch(self) -> None:
        """GC-epoch semantics: watchpoints never cross an epoch; the
        reservoir restarts from its seed, the sampler draws a fresh gap."""
        self.wp = {
            STORE: ReservoirWatchpoints(self.cfg.num_watchpoints,
                                        self.cfg.seed),
            LOAD: ReservoirWatchpoints(self.cfg.num_watchpoints,
                                       self.cfg.seed + 1),
        }
        self.sampler.reset()

    # ------------------------------------------------------------------
    def on_event(self, ev: MemEvent) -> None:
        if ev.kind == STORE:
            self._on_store(ev)
        else:
            self._on_load(ev)

    def replay(self, trace: EventTrace) -> None:
        """One epoch over a recorded trace (no operation runs again)."""
        on_store, on_load = self._on_store, self._on_load
        for ev in trace:
            if ev.kind == STORE:
                on_store(ev)
            else:
                on_load(ev)

    def finalize(self) -> WasteProfile:
        self.profile.watchpoint_stats = {
            k: dict(v.stats) for k, v in self.wp.items()}
        return self.profile

    # ------------------------------------------------------------------
    # Each event is handled in the reference's order — traps, then the
    # samples it arms — but the elements both need are read first, in one
    # gather: matching, the gaps and the client draws depend on the
    # watchpoints and the RNG streams only, never on values.
    def _on_store(self, ev: MemEvent) -> None:
        prof = self.profile
        prof.bump_total("store_events", ev.nelems)
        prof.bump_total("store_bytes", ev.nbytes)
        hits = self._trap_hits(ev)
        offs = self.sampler.advance(ev.nelems)
        clients = self._store_clients
        if len(clients) > 1 and offs:
            # one-sample-one-watchpoint (paper §5.2): a single PMU sample
            # arms exactly one client, chosen uniformly, so dead- and
            # silent-store detection share the reservoir at the pressure
            # one PMU stream generates instead of doubling it
            picks = [clients[i] for i in
                     self.client_rng.randint(len(clients), size=len(offs))]
        else:
            picks = list(clients[:1]) * len(offs)   # none without clients
        silent = [off for off, c in zip(offs, picks) if c == "silent_store"]
        trap_vals, vals = self._read(ev, hits, STORE, silent)
        self._classify(STORE, ev, hits, trap_vals)
        got = iter(vals)
        for off, client in zip(offs, picks):
            value = None
            if client == "silent_store":
                value = next(got)
                if value is None:        # no comparable value at this offset
                    client = "dead_store"
                    if "dead_store" not in self.detect:
                        continue
            self.wp[STORE].on_sample(Watchpoint(
                address=ev.address, offset=off, size=ev.itemsize,
                value=value, context=ev.ctx,
                trap_type="RW_TRAP" if client == "dead_store" else "W_TRAP",
                meta=client))

    def _on_load(self, ev: MemEvent) -> None:
        prof = self.profile
        prof.bump_total("load_events", ev.nelems)
        prof.bump_total("load_bytes", ev.nbytes)
        hits = self._trap_hits(ev)
        offs = (self.sampler.advance(ev.nelems)
                if "silent_load" in self.detect else [])
        trap_vals, vals = self._read(ev, hits, LOAD, offs)
        self._classify(LOAD, ev, hits, trap_vals)
        for off, value in zip(offs, vals):
            if value is None:            # no comparable value at this offset
                continue
            self.wp[LOAD].on_sample(Watchpoint(
                address=ev.address, offset=off, size=ev.itemsize,
                value=value, context=ev.ctx,
                trap_type="RW_TRAP", meta="silent_load"))

    def _trap_hits(self, ev: MemEvent):
        """The armed watchpoints at the event's address, per reservoir."""
        return {k: r.matching(lambda w: w.address == ev.address)
                for k, r in self.wp.items()}

    @staticmethod
    def _read(ev: MemEvent, hits, access: str, offsets: List[int]):
        """Values the trap compares and the new samples need: (per trapped
        watchpoint that compares, per sample offset), in one gather."""
        meta = "silent_store" if access == STORE else "silent_load"
        compare = [wp for wp in hits[STORE] + hits[LOAD]
                   if wp.meta == meta and wp.offset < ev.nelems]
        want = [wp.offset for wp in compare] + list(offsets)
        got = ev.values_at(want) if want else []
        trap_vals = {id(wp): v for wp, v in zip(compare, got)}
        return trap_vals, got[len(compare):]

    def _classify(self, access: str, ev: MemEvent, hits, trap_vals) -> None:
        prof = self.profile
        # Two passes per reservoir, stale disarms FIRST: with several
        # watchpoints tied on one (recycled) address, classification and
        # stale-disarm used to interleave in slot order, so which
        # watchpoints survived the event depended on how earlier slots
        # happened to be filled. Disarming every stale tie up front
        # makes the surviving set — and the profile — a function of the
        # event stream alone.
        store_hits, load_hits = [], []
        for wp in hits[STORE]:
            if wp.offset >= ev.nelems:
                # stale watchpoint: a shorter event at the same (recycled)
                # address means the watched element no longer exists —
                # skip classification entirely and free the slot
                self.wp[STORE].disarm(wp)
            else:
                store_hits.append(wp)
        for wp in hits[LOAD]:
            if wp.offset >= ev.nelems:
                self.wp[LOAD].disarm(wp)
            else:
                load_hits.append(wp)
        for wp in store_hits:
            if wp.meta == "dead_store":
                # Def. 1: store;store with no intervening load is dead
                hit = access == STORE
                prof.observe("dead_store", hit)
                if hit:
                    prof.add_pair("dead_store", self.tier, wp.context,
                                  ev.ctx, wp.size)
                self.wp[STORE].disarm(wp)
            elif wp.meta == "silent_store" and access == STORE:
                cur = trap_vals[id(wp)]
                if cur is None:          # offset outside the value extent
                    self.wp[STORE].disarm(wp)
                    continue
                # Def. 2: overwrite with the value already there
                hit = approx_equal(wp.value, cur, self.tol)
                prof.observe("silent_store", hit)
                if hit:
                    prof.add_pair("silent_store", self.tier, wp.context,
                                  ev.ctx, wp.size)
                self.wp[STORE].disarm(wp)
        for wp in load_hits:
            if access == LOAD:
                cur = trap_vals[id(wp)]
                if cur is None:
                    self.wp[LOAD].disarm(wp)
                    continue
                # Def. 3: load of the value already loaded
                hit = approx_equal(wp.value, cur, self.tol)
                prof.observe("silent_load", hit)
                if hit:
                    prof.add_pair("silent_load", self.tier, wp.context,
                                  ev.ctx, wp.size)
            self.wp[LOAD].disarm(wp)
