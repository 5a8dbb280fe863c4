"""SARIF v2.1.0 export for any :class:`WasteProfile` (DESIGN.md § Static
tier, "SARIF contract").

Findings of the serving and training tiers — detectors (3), kernel
counters (4), the prefill padding accounting — render as code-scanning
annotations: each waste kind becomes a SARIF *rule* carrying its paper definition as help
text, each finding becomes a *result* at a logical location built from
its ⟨C1,C2⟩ contexts. (The reference's tier-0 lint findings carry a
source ``file:line``; that tier is bound to JAX and not ported.)

Contract details tooling relies on:

* ``partialFingerprints["wasteKey/v1"]`` is a sha256 over the §5.6
  coalescing key ``kind|tier|C1|C2`` — byte counts and fractions are
  deliberately excluded, so the fingerprint is stable run-to-run and a
  committed baseline can suppress pre-existing findings.
* ``rank`` orders results by wasted bytes (log scale; flops, then
  fraction as fallbacks) so viewers sort the biggest waste first.
"""
from __future__ import annotations

import hashlib
import json
import math
from typing import Any, Dict, List

from repro_torch.core.context import fmt_context
from repro_torch.core.findings import Finding, WasteProfile

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")
TOOL_NAME = "jxperf-jax"

# Rule registry: waste kind -> (short description, paper-definition help).
# Kinds not listed here still export — a generic rule is synthesized — so
# the exporter accepts ANY WasteProfile, including future tiers' kinds.
_RULES: Dict[str, Dict[str, str]] = {
    "dead_store": {
        "short": "Dead store: a write that is overwritten before any read",
        "help": "Paper Def. 1: two successive stores S1, S2 to memory "
                "location M with no intervening load make S1 dead.",
    },
    "silent_store": {
        "short": "Silent store: rewriting the value already resident",
        "help": "Paper Def. 2: a store S2 writing value V2 to location M "
                "holding V1 is silent iff V1 == V2.",
    },
    "silent_load": {
        "short": "Silent load: re-reading an unchanged value",
        "help": "Paper Def. 3: two successive loads L1, L2 from location "
                "M are silent iff they observe the same value with no "
                "intervening store changing it.",
    },
    "silent_param_store": {
        "short": "Silent parameter update: optimizer wrote back unchanged "
                 "weights",
        "help": "Paper Def. 2 applied per parameter leaf: the train step "
                "stored a parameter tensor bit-equal (within tolerance) "
                "to its previous value.",
    },
    "dead_grad_store": {
        "short": "Dead gradient store: gradient written then overwritten "
                 "unread",
        "help": "Paper Def. 1 applied to gradient accumulation buffers.",
    },
    "silent_data_load": {
        "short": "Silent data load: an input batch re-read unchanged",
        "help": "Paper Def. 3 applied to input pipelines: the same batch "
                "content loaded repeatedly (duplicate epochs/shards).",
    },
    "prefill_padding": {
        "short": "Prefill padding burn: tokens computed then masked away",
        "help": "Serve-side: bucket padding in batched prefill computes "
                "attention for positions that are discarded.",
    },
    "kernel_silent_store": {
        "short": "Kernel-counted silent store (exact, in-kernel)",
        "help": "Tier 4: the paged kernels' store epilogue counted stores "
                "whose value equaled the resident value (COUNTER_TOL=0). "
                "Exhaustive population — the fraction is exact.",
    },
    "kernel_dead_store": {
        "short": "Kernel-counted dead store (exact, in-kernel)",
        "help": "Tier 4: in-kernel counters at the store site; writes "
                "dropped or overwritten before any read.",
    },
}

_TIER_NAMES = {0: "static jaxpr lint", 1: "interpreter", 2: "HLO",
               3: "detectors", 4: "kernel counters",
               5: "object replicas"}


def finding_fingerprint(f: Finding) -> str:
    """Stable id over the §5.6 coalescing key (kind|tier|C1|C2).

    Excludes counts/bytes/fractions on purpose: the same site found in
    two runs with different magnitudes must collide, so baselines can
    suppress it."""
    raw = "|".join([f.kind, str(f.tier),
                    "\x1f".join(f.c1), "\x1f".join(f.c2)])
    return hashlib.sha256(raw.encode("utf-8")).hexdigest()[:32]


def _rank(f: Finding) -> float:
    """0-100 priority: log-scaled wasted bytes, then flops, then the
    local waste fraction."""
    if f.bytes > 0:
        return round(min(100.0, 10.0 * math.log10(f.bytes + 1.0)), 2)
    if f.flops > 0:
        return round(min(100.0, 8.0 * math.log10(f.flops + 1.0)), 2)
    fr = f.fraction
    if not math.isnan(fr) and fr > 0:
        return round(min(100.0, 50.0 * fr), 2)
    return 1.0


def _fmt_bytes(b: float) -> str:
    if b >= 1e9:
        return f"{b / 1e9:.2f} GB"
    if b >= 1e6:
        return f"{b / 1e6:.2f} MB"
    if b >= 1e3:
        return f"{b / 1e3:.1f} KB"
    return f"{b:.0f} B"


def _message(f: Finding) -> str:
    rule = f.meta.get("rule", "")
    bits = [f"{f.kind} (tier {f.tier}, {_TIER_NAMES.get(f.tier, '?')})"]
    if rule:
        bits.append(rule)
    cost = []
    if f.bytes:
        cost.append(f"{_fmt_bytes(f.bytes)} wasted")
    if f.flops:
        cost.append(f"{f.flops / 1e9:.2f} GFLOP wasted")
    if not math.isnan(f.fraction) and f.fraction > 0:
        cost.append(f"local waste fraction {f.fraction:.0%}")
    if f.count > 1:
        cost.append(f"x{f.count}")
    if cost:
        bits.append(", ".join(cost))
    if f.c1:
        bits.append(f"C1: {fmt_context(f.c1[-3:])}")
    if f.c2:
        bits.append(f"C2: {fmt_context(f.c2[-3:])}")
    return ". ".join(bits)


def _location(f: Finding) -> Dict[str, Any]:
    name = f.meta.get("path") or fmt_context(f.c1[-2:]) or f.kind
    return {"logicalLocations": [
        {"name": str(name), "kind": "member",
         "fullyQualifiedName": fmt_context(f.c1) or str(name)}]}


def _rule_for(kind: str) -> Dict[str, Any]:
    spec = _RULES.get(kind)
    if spec is None:
        spec = {"short": f"Wasteful memory operation: {kind}",
                "help": "Waste class observed by the JXPerf-JAX profiler "
                        "(see DESIGN.md); no static definition recorded "
                        "for this kind."}
    return {
        "id": kind,
        "name": "".join(w.capitalize() for w in kind.split("_")),
        "shortDescription": {"text": spec["short"]},
        "fullDescription": {"text": spec["help"]},
        "help": {"text": spec["help"]},
        "defaultConfiguration": {"level": "warning"},
    }


def to_sarif(profile: WasteProfile, *,
             tool_version: str = "0") -> Dict[str, Any]:
    """Render a WasteProfile (any tier or merged) as a SARIF 2.1.0 doc."""
    findings = sorted(profile.findings,
                      key=lambda f: (-f.bytes, -f.flops, f.kind,
                                     f.tier, f.c1, f.c2))
    kinds: List[str] = []
    for f in findings:
        if f.kind not in kinds:
            kinds.append(f.kind)
    rule_index = {k: i for i, k in enumerate(kinds)}

    results = []
    for f in findings:
        props: Dict[str, Any] = {
            "tier": f.tier, "count": f.count, "bytes": f.bytes,
            "flops": f.flops, "fraction": (None if math.isnan(f.fraction)
                                           else f.fraction),
        }
        for k in ("subject", "path", "shape"):
            if k in f.meta:
                props[k] = f.meta[k]
        results.append({
            "ruleId": f.kind,
            "ruleIndex": rule_index[f.kind],
            "level": "warning",
            "rank": _rank(f),
            "message": {"text": _message(f)},
            "locations": [_location(f)],
            "partialFingerprints": {"wasteKey/v1": finding_fingerprint(f)},
            "properties": props,
        })

    run: Dict[str, Any] = {
        "tool": {"driver": {
            "name": TOOL_NAME,
            "informationUri":
                "https://github.com/jxperf/jxperf#readme",
            "version": str(tool_version),
            "rules": [_rule_for(k) for k in kinds],
        }},
        "results": results,
        "columnKind": "utf16CodeUnits",
        "properties": {
            "tiers": list(profile.tiers),
            "fractions": {k: v for k, v in profile.fractions().items()},
            "checked": dict(profile.checked),
            "flagged": dict(profile.flagged),
        },
    }
    return {"$schema": SARIF_SCHEMA, "version": SARIF_VERSION,
            "runs": [run]}


def write_sarif(profile: WasteProfile, path: str, *,
                tool_version: str = "0") -> Dict[str, Any]:
    doc = to_sarif(profile, tool_version=tool_version)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return doc
