"""Reservoir-sampled watchpoint slots (paper §5.2, exact algorithm).

Hardware offers N debug registers (default 4). If every slot is armed when
a new PMU sample arrives, naive policies (replace-oldest, exponential
decay) are biased — the paper's scheme gives every sample a uniform
survival probability with O(1) state:

  * the i-th sample since a slot was last (re)armed replaces that slot
    with probability P = 1/i;
  * a new sample attempts each armed slot (in randomized order) and may
    fail everywhere;
  * whether it succeeds or fails, every armed slot's P is updated;
  * a trap disarms its slot and resets its reservoir probability to 1.0.

``Watchpoint`` is trigger-agnostic: Tier-1 arms it on interpreter memory
events, Tier-3 on parameter/optimizer stores.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, List, Optional


@dataclass
class Watchpoint:
    address: int                 # logical address (allocator offset)
    offset: int                  # element offset within the buffer
    size: int                    # bytes per element access
    value: Any                   # value observed when armed
    context: Any                 # C1 — full calling context when armed
    trap_type: str               # "W_TRAP" (stores) | "RW_TRAP" (loads+stores)
    meta: Any = None
    # samples seen since this slot was armed (P = 1 / samples_seen)
    samples_seen: int = 1


class ReservoirWatchpoints:
    """N-slot manager with the paper's uniform-survival replacement.

    The reservoir count belongs to the SLOT (samples seen since the slot
    was last free), not to the occupant — the i-th sample since the slot
    freed replaces whatever occupies it with probability 1/i, which is the
    invariant that makes survival uniform (P(any sample survives) = 1/i
    after i samples)."""

    def __init__(self, num_slots: int = 4, seed: int = 0):
        assert num_slots >= 1
        self.num_slots = num_slots
        self.slots: List[Optional[Watchpoint]] = [None] * num_slots
        self.counts: List[int] = [0] * num_slots   # samples since last free
        self.rng = random.Random(seed)
        self.stats = {"armed": 0, "replaced": 0, "rejected": 0, "traps": 0}

    # ------------------------------------------------------------------
    def armed(self) -> List[Watchpoint]:
        return [w for w in self.slots if w is not None]

    def on_sample(self, wp: Watchpoint) -> bool:
        """A PMU sample arrived; try to install `wp`. Returns installed?"""
        # free slot: arm unconditionally (its count restarts at 1)
        for i, s in enumerate(self.slots):
            if s is None:
                self.slots[i] = wp
                self.counts[i] = 1
                for j in range(self.num_slots):   # others age
                    if j != i and self.slots[j] is not None:
                        self.counts[j] += 1
                self.stats["armed"] += 1
                return True
        # all armed: visit slots in randomized order; the (count+1)-th
        # sample replaces slot i with probability 1/(count+1); every slot's
        # count advances whether the attempt succeeded or not (paper §5.2)
        order = list(range(self.num_slots))
        self.rng.shuffle(order)
        installed = False
        for i in order:
            self.counts[i] += 1
            if not installed and self.rng.random() < 1.0 / self.counts[i]:
                self.slots[i] = wp
                self.stats["replaced"] += 1
                installed = True
        if not installed:
            self.stats["rejected"] += 1
        return installed

    # ------------------------------------------------------------------
    def matching(self, pred: Callable[[Watchpoint], bool]) -> List[Watchpoint]:
        return [w for w in self.slots if w is not None and pred(w)]

    def disarm(self, wp: Watchpoint) -> None:
        """Trap handled: free the slot (reservoir P resets to 1.0 — the
        slot count restarts when the next occupant arms)."""
        for i, s in enumerate(self.slots):
            if s is wp:
                self.slots[i] = None
                self.counts[i] = 0
                self.stats["traps"] += 1
                return

    def disarm_all(self) -> None:
        """Epoch boundary (GC analogue: one profiled run) — watchpoints
        never survive an epoch because buffer identity is not stable."""
        self.slots = [None] * self.num_slots
        self.counts = [0] * self.num_slots
