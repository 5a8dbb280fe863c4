"""Calling contexts and ⟨C1,C2⟩ pair bookkeeping (paper §5.5-§5.6).

A context is a tuple of frame labels, outermost first — the analogue of
``packageA.classB.methodC:line -> ... -> String.equals():line``. The
reference's jaxpr-equation contexts (``context_of_eqn``) belong to the
tier-1 slice and are not part of this package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


def fmt_context(ctx: Tuple[str, ...]) -> str:
    return " -> ".join(ctx)


@dataclass
class PairStats:
    count: int = 0
    bytes: float = 0.0


class PairTable:
    """⟨C_watch, C_trap⟩ -> stats, mergeable across shards (§5.6: two pairs
    coalesce iff both contexts match)."""

    def __init__(self):
        self.pairs: Dict[Tuple[Tuple[str, ...], Tuple[str, ...]], PairStats] = {}

    def add(self, c1, c2, nbytes: float) -> None:
        st = self.pairs.setdefault((c1, c2), PairStats())
        st.count += 1
        st.bytes += nbytes

    def merge(self, other: "PairTable") -> "PairTable":
        for k, v in other.pairs.items():
            st = self.pairs.setdefault(k, PairStats())
            st.count += v.count
            st.bytes += v.bytes
        return self

    def top(self, k: int = 10):
        items = sorted(self.pairs.items(), key=lambda kv: -kv[1].bytes)
        return items[:k]

    @property
    def total_count(self) -> int:
        return sum(v.count for v in self.pairs.values())
