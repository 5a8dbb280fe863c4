"""Unified waste-finding schema shared by all three tiers (DESIGN.md §2).

One ``Finding`` describes one coalescible waste site: a kind (dead_store,
silent_store, silent_load, silent_param_store, dead_grad_store,
silent_data_load, redundant_collective, recompute, reshard_copy, ...), the
tier that observed it, the paper's ⟨C1,C2⟩ calling-context provenance, and
its cost dimensions (event count, bytes, flops, local waste fraction).

One ``WasteProfile`` is the report type every tier emits: findings plus
the checked/flagged counters behind the sampled fraction estimator
(Eq. (1): F^kind = flagged/checked over a uniform reservoir sample),
event/byte totals, and watchpoint statistics. Profiles merge across
shards, epochs and tiers with the paper's §5.6 rule — findings coalesce
iff (kind, tier, C1, C2) all match; counters and totals add — and
round-trip losslessly through JSON so per-host profiles can be shipped
and aggregated post-mortem.
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.context import PairStats, PairTable, fmt_context

SCHEMA_VERSION = 1

# kinds whose fraction estimator is meaningful per-access (Defs. 1-3)
TIER1_KINDS = ("dead_store", "silent_store", "silent_load")

# the static tier (DESIGN.md § Static tier): findings proven on an
# abstract trace of a step BEFORE it runs by core/graph_lint.py
# (dead_store, silent_store, redundant_load, dead_param). Checked/flagged
# counters count candidate nodes, so Eq. (1) here estimates the fraction
# of store/load SITES that are wasteful rather than dynamic accesses.
TIER_STATIC = 0

# the object tier (DESIGN.md § Object tier): DJXPerf-style aggregation
# by allocation (core/objects.py registry) and OJXPerf-style replica
# findings (core/replicas.py) — replica_kv_page / replica_param /
# replica_opt_state, each naming the dedup that eliminates it.
TIER_OBJECT = 5


def _fmax(a: float, b: float) -> float:
    """NaN-robust max: prefer the non-NaN operand (both NaN -> NaN).

    Python's max() is order-dependent under NaN (max(nan, 1) is nan but
    max(1, nan) is 1), which silently broke the §5.6 merge's
    associativity/commutativity for NaN-bearing findings — the merge
    fuzz test pins this."""
    if math.isnan(a):
        return b
    if math.isnan(b):
        return a
    return max(a, b)


@dataclass
class Finding:
    """One coalescible waste site (key = kind, tier, c1, c2)."""
    kind: str
    tier: int
    c1: Tuple[str, ...] = ()
    c2: Tuple[str, ...] = ()
    count: int = 1
    bytes: float = 0.0
    flops: float = 0.0
    # worst observed local fraction (max keeps merge exactly associative)
    fraction: float = 0.0
    step: int = -1
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def key(self) -> Tuple:
        return (self.kind, self.tier, self.c1, self.c2)

    @property
    def path(self) -> str:
        """Tier-3 leaf path / generic site label."""
        return self.meta.get("path", fmt_context(self.c1))

    def absorb(self, other: "Finding") -> None:
        assert self.key == other.key
        self.count += other.count
        self.bytes += other.bytes
        self.flops += other.flops
        self.fraction = _fmax(self.fraction, other.fraction)
        self.step = max(self.step, other.step)
        for k, v in other.meta.items():
            self.meta.setdefault(k, v)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "tier": self.tier,
                "c1": list(self.c1), "c2": list(self.c2),
                "count": self.count, "bytes": self.bytes,
                "flops": self.flops, "fraction": self.fraction,
                "step": self.step, "meta": dict(self.meta)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Finding":
        return cls(kind=d["kind"], tier=int(d["tier"]),
                   c1=tuple(d.get("c1", ())), c2=tuple(d.get("c2", ())),
                   count=int(d.get("count", 1)),
                   bytes=float(d.get("bytes", 0.0)),
                   flops=float(d.get("flops", 0.0)),
                   fraction=float(d.get("fraction", 0.0)),
                   step=int(d.get("step", -1)),
                   meta=dict(d.get("meta", {})))


class WasteProfile:
    """The one report type all tiers emit; mergeable and JSON round-trip."""

    def __init__(self, tier: Optional[int] = None, sampling_period: int = 1):
        self.tiers: List[int] = [tier] if tier is not None else []
        self.sampling_period = sampling_period
        self._index: Dict[Tuple, Finding] = {}
        # sampled fraction estimator state: per kind, how many watched
        # accesses were checked and how many of those were wasteful
        self.checked: Dict[str, int] = {}
        self.flagged: Dict[str, int] = {}
        # event/byte/flop totals ("store_events", "load_bytes", tier-2
        # "recompute_flops", ...) — all additive under merge
        self.totals: Dict[str, float] = {}
        self.watchpoint_stats: Dict[str, Dict[str, int]] = {}
        self.meta: Dict[str, Any] = {}
        # DJXPerf object table: object_key (kind|name|alloc-site, see
        # core/objects.py) -> {"kind","name","site","nbytes","count",
        # "waste": {waste_kind: bytes}}. Any tier can bill waste bytes
        # to an object; rows merge additively (waste/count add, nbytes
        # is a size so merge takes the NaN-robust max) which keeps the
        # §5.6 merge associative and commutative over objects too.
        self.objects: Dict[str, Dict[str, Any]] = {}

    # -- findings ------------------------------------------------------
    @property
    def findings(self) -> List[Finding]:
        return list(self._index.values())

    def add(self, f: Finding) -> Finding:
        """Coalesce `f` into the profile (§5.6 rule); returns the site."""
        cur = self._index.get(f.key)
        if cur is None:
            cur = dataclasses.replace(f, meta=dict(f.meta))
            self._index[cur.key] = cur
        else:
            cur.absorb(f)
        return cur

    def add_pair(self, kind: str, tier: int, c1, c2, nbytes: float,
                 **meta) -> Finding:
        return self.add(Finding(kind=kind, tier=tier, c1=tuple(c1),
                                c2=tuple(c2), bytes=float(nbytes),
                                meta=meta))

    def observe(self, kind: str, flagged: bool) -> None:
        """One watched access was checked against Definitions 1-3."""
        self.checked[kind] = self.checked.get(kind, 0) + 1
        if flagged:
            self.flagged[kind] = self.flagged.get(kind, 0) + 1

    def bump_total(self, key: str, amount: float) -> None:
        self.totals[key] = self.totals.get(key, 0) + amount

    # -- object table (DJXPerf aggregation) ----------------------------
    def bill_object(self, obj, waste_kind: str, nbytes: float,
                    count: int = 1) -> Dict[str, Any]:
        """Bill ``nbytes`` of ``waste_kind`` waste to an object.

        ``obj`` is an ``ObjectRecord`` (core/objects.py) or a row dict
        from another profile's object table; either way the row is keyed
        by the stable object key so repeated bills and cross-profile
        merges coalesce."""
        if isinstance(obj, dict):
            key, kind, name, site = (obj["key"], obj["kind"], obj["name"],
                                     obj["site"])
        else:
            key, kind, name, site = (obj.object_key, obj.kind, obj.name,
                                     obj.site)
        size = float(obj["nbytes"] if isinstance(obj, dict) else obj.nbytes)
        row = self.objects.setdefault(key, {
            "key": key, "kind": kind, "name": name, "site": site,
            "nbytes": size, "count": 0, "waste": {}})
        row["nbytes"] = _fmax(row["nbytes"], size)
        row["count"] += int(count)
        row["waste"][waste_kind] = (row["waste"].get(waste_kind, 0.0)
                                    + float(nbytes))
        return row

    def top_objects(self, k: int = 10) -> List[Dict[str, Any]]:
        """Object rows by total attributed waste bytes, descending."""
        rows = sorted(self.objects.values(),
                      key=lambda r: (-sum(r["waste"].values()), r["key"]))
        return rows[:k]

    def _absorb_object(self, row: Dict[str, Any]) -> None:
        cur = self.objects.get(row["key"])
        if cur is None:
            self.objects[row["key"]] = {**row, "waste": dict(row["waste"])}
            return
        cur["nbytes"] = _fmax(float(cur["nbytes"]), float(row["nbytes"]))
        cur["count"] += int(row["count"])
        for k, v in row["waste"].items():
            cur["waste"][k] = cur["waste"].get(k, 0.0) + float(v)

    # -- estimators ----------------------------------------------------
    def fractions(self) -> Dict[str, float]:
        # `if v` is a guard, not style: a zero-event kind (cold engine,
        # empty object tier) must drop out of the estimator entirely
        # rather than divide by zero and leak NaN into JSON/SARIF
        out = {k: self.flagged.get(k, 0) / v
               for k, v in self.checked.items() if v}
        for k in TIER1_KINDS:            # always present for tier-1 readers
            if 1 in self.tiers:
                out.setdefault(k, 0.0)
        return out

    def top(self, k: int = 10, kind: Optional[str] = None) -> List[Finding]:
        fs = [f for f in self._index.values()
              if kind is None or f.kind == kind]
        return sorted(fs, key=lambda f: (-f.bytes, -f.flops, -f.fraction,
                                         -f.count))[:k]

    def pair_table(self, kind: str) -> PairTable:
        """⟨C1,C2⟩ view of one kind's findings (seed-Report compatible)."""
        t = PairTable()
        for f in self._index.values():
            if f.kind == kind:
                t.pairs[(f.c1, f.c2)] = PairStats(count=f.count,
                                                  bytes=f.bytes)
        return t

    # the reference's accessors, which its tests and examples read
    @property
    def dead_stores(self) -> PairTable:
        return self.pair_table("dead_store")

    @property
    def silent_stores(self) -> PairTable:
        return self.pair_table("silent_store")

    @property
    def silent_loads(self) -> PairTable:
        return self.pair_table("silent_load")

    @property
    def total_store_events(self) -> int:
        return int(self.totals.get("store_events", 0))

    @property
    def total_load_events(self) -> int:
        return int(self.totals.get("load_events", 0))

    @property
    def total_store_bytes(self) -> float:
        return self.totals.get("store_bytes", 0.0)

    @property
    def total_load_bytes(self) -> float:
        return self.totals.get("load_bytes", 0.0)

    # -- merge (cross-epoch, cross-shard, cross-tier) ------------------
    def merge(self, other: "WasteProfile") -> "WasteProfile":
        for t in other.tiers:
            if t not in self.tiers:
                self.tiers.append(t)
        self.tiers.sort()
        self.sampling_period = max(self.sampling_period,
                                   other.sampling_period)
        for f in other._index.values():
            self.add(f)
        for k, v in other.checked.items():
            self.checked[k] = self.checked.get(k, 0) + v
        for k, v in other.flagged.items():
            self.flagged[k] = self.flagged.get(k, 0) + v
        for k, v in other.totals.items():
            self.totals[k] = self.totals.get(k, 0) + v
        for cls, st in other.watchpoint_stats.items():
            mine = self.watchpoint_stats.setdefault(cls, {})
            for k, v in st.items():
                mine[k] = mine.get(k, 0) + v
        for row in other.objects.values():
            self._absorb_object(row)
        for k, v in other.meta.items():
            self.meta.setdefault(k, v)
        return self

    # -- serialization -------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": SCHEMA_VERSION,
            "tiers": list(self.tiers),
            "sampling_period": self.sampling_period,
            "checked": dict(sorted(self.checked.items())),
            "flagged": dict(sorted(self.flagged.items())),
            "totals": dict(sorted(self.totals.items())),
            "watchpoint_stats": {k: dict(sorted(v.items())) for k, v in
                                 sorted(self.watchpoint_stats.items())},
            "meta": dict(sorted(self.meta.items())),
            "objects": {k: {**row, "waste": dict(sorted(row["waste"].items()))}
                        for k, row in sorted(self.objects.items())},
            "findings": [f.to_dict() for f in
                         sorted(self._index.values(),
                                key=lambda f: (f.kind, f.tier, f.c1, f.c2))],
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WasteProfile":
        p = cls()
        p.tiers = [int(t) for t in d.get("tiers", [])]
        p.sampling_period = int(d.get("sampling_period", 1))
        p.checked = {k: int(v) for k, v in d.get("checked", {}).items()}
        p.flagged = {k: int(v) for k, v in d.get("flagged", {}).items()}
        p.totals = dict(d.get("totals", {}))
        p.watchpoint_stats = {k: {kk: int(vv) for kk, vv in v.items()}
                              for k, v in d.get("watchpoint_stats",
                                                {}).items()}
        p.meta = dict(d.get("meta", {}))
        for k, row in d.get("objects", {}).items():
            p.objects[k] = {
                "key": row.get("key", k), "kind": row["kind"],
                "name": row["name"], "site": row["site"],
                "nbytes": float(row["nbytes"]),
                "count": int(row.get("count", 0)),
                "waste": {wk: float(wv)
                          for wk, wv in row.get("waste", {}).items()}}
        for fd in d.get("findings", []):
            f = Finding.from_dict(fd)
            p._index[f.key] = f
        return p

    @classmethod
    def from_json(cls, s: str) -> "WasteProfile":
        return cls.from_dict(json.loads(s))

    def __eq__(self, other) -> bool:
        if not isinstance(other, WasteProfile):
            return NotImplemented
        return self.to_dict() == other.to_dict()

    def __repr__(self) -> str:
        return (f"WasteProfile(tiers={self.tiers}, "
                f"findings={len(self._index)}, "
                f"fractions={self.fractions()})")

    # -- rendering -----------------------------------------------------
    def render(self, top_k: int = 5, by: str = "kind") -> str:
        if by == "object":
            return self._render_objects(top_k)
        if by != "kind":
            raise ValueError(f"render(by=...) wants 'kind' or 'object', "
                             f"not {by!r}")
        fr = self.fractions()
        tiers = ",".join(str(t) for t in self.tiers) or "-"
        lines = [f"== JXPerf-JAX waste profile (tiers {tiers}) =="]
        if self.total_store_events or self.total_load_events:
            lines.append(f"  sampling period: {self.sampling_period} events")
            lines.append(f"  events: {self.total_store_events:,} stores / "
                         f"{self.total_load_events:,} loads")
        for kind in TIER1_KINDS:
            if kind not in fr:
                continue
            table = self.pair_table(kind)
            lines.append(f"  F^{kind} = {fr[kind]:.1%} "
                         f"({table.total_count} sampled pairs)")
            for (c1, c2), st in table.top(top_k):
                lines.append(f"    x{st.count:<5d} {fmt_context(c1[-3:])}")
                lines.append(f"           -> {fmt_context(c2[-3:])}")
        for kind in sorted(fr):
            if kind in TIER1_KINDS:
                continue
            lines.append(f"  F^{kind} = {fr[kind]:.1%} "
                         f"({self.flagged.get(kind, 0)}/"
                         f"{self.checked.get(kind, 0)} checked)")
            for f in self.top(top_k, kind=kind):
                cost = (f"{f.bytes / 1e9:.2f} GB" if f.bytes
                        else f"{f.flops / 1e12:.2f} TF" if f.flops
                        else f"{f.fraction:.0%}")
                lines.append(f"    x{f.count:<5d} {cost:>10s}  {f.path}")
        return "\n".join(lines)

    def _render_objects(self, top_k: int) -> str:
        """DJXPerf-style top-objects table: waste billed per allocation,
        ranked by attributed bytes, with the allocation site inline. An
        empty or waste-free table renders zero rows (an object's nbytes
        can be 0, so no fraction divides by it)."""
        lines = [f"== top objects by attributed waste "
                 f"({len(self.objects)} registered) =="]
        rows = [r for r in self.top_objects(top_k)
                if sum(r["waste"].values()) > 0]
        if not rows:
            lines.append("  (no object-attributed waste)")
            return "\n".join(lines)
        for r in rows:
            waste = sum(r["waste"].values())
            nbytes = r["nbytes"]
            frac = (f"{waste / nbytes:7.1%}"
                    if nbytes and not math.isnan(nbytes) else "      -")
            kinds = ", ".join(f"{k} {v / 1e3:.1f}KB"
                              for k, v in sorted(r["waste"].items()))
            lines.append(f"  {waste / 1e3:10.1f} KB {frac} "
                         f"{r['kind']:13s} {r['name']}")
            lines.append(f"      @ {r['site']}  [{kinds}] x{r['count']}")
        return "\n".join(lines)


def merge(*profiles: WasteProfile) -> WasteProfile:
    """Pure n-way merge: cross-shard, cross-epoch and cross-tier profiles
    coalesce into one report (associative; inputs untouched)."""
    out = WasteProfile()
    for p in profiles:
        out.merge(p)
    return out


def merge_profiles(profiles: Iterable[WasteProfile]) -> WasteProfile:
    return merge(*profiles)


def merge_fleet(profiles: Dict[str, WasteProfile]) -> WasteProfile:
    """§5.6 merge across serving-fleet members (replica engines + the
    router's own fleet-level findings), keyed by member name.

    Findings coalesce exactly as in `merge`, but replica attribution is
    kept: ``meta["fleet"]`` records each member's finding count and
    checked/flagged totals. The result round-trips through JSON and
    SARIF like any profile."""
    out = WasteProfile()
    summary: Dict[str, Dict[str, int]] = {}
    for name in sorted(profiles):
        p = profiles[name]
        out.merge(p)
        summary[name] = {
            "findings": len(p.findings),
            "checked": int(sum(p.checked.values())),
            "flagged": int(sum(p.flagged.values())),
        }
    out.meta["fleet"] = summary
    return out
