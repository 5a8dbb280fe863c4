"""SARIF v2.1.0 export for any :class:`WasteProfile` (DESIGN.md § Static
tier, "SARIF contract").

Findings from every tier — the static graph lint (0), the concrete-run
recorder (1), the traced-step analysis (2), detectors (3), kernel
counters (4), object replicas (5) — render as code-scanning annotations:
each waste kind becomes a SARIF *rule* carrying its paper definition as
help text, each finding becomes a *result*. A finding whose ``meta``
names a source ``file`` (and ``line``) gets that ``physicalLocation``:
a tier-0 finding the Python ``file:line`` of the offending node, an
object finding its allocation site. The others get a logical location
built from their ⟨C1,C2⟩ contexts.

Contract details tooling relies on:

* ``partialFingerprints["wasteKey/v1"]`` is a sha256 over the §5.6
  coalescing key ``kind|tier|C1|C2`` — byte counts and fractions are
  deliberately excluded, so the fingerprint is stable run-to-run and a
  committed baseline (``lint_baseline_torch.json``) can suppress
  pre-existing findings.
* file URIs under ``src_root`` are emitted relative with
  ``uriBaseId: SRCROOT``; anything else stays absolute.
* ``rank`` orders results by wasted bytes (log scale; flops, then
  fraction as fallbacks) so viewers sort the biggest waste first.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
from typing import Any, Dict, List, Optional

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
                "location M with no intervening load make S1 dead. "
                "Statically (tier 0): an in-place store (copy_ into a "
                "view, index_put_, index_copy_, scatter_) whose region is "
                "fully overwritten before a read, or whose buffer is never "
                "read again.",
    },
    "silent_store": {
        "short": "Silent store: rewriting the value already resident",
        "help": "Paper Def. 2: a store S2 writing value V2 to location M "
                "holding V1 is silent iff V1 == V2. Statically (tier 0): "
                "storing a region loaded from the same buffer at the same "
                "indices, or an identity chain (x+0, x*1) whose result "
                "provably equals its operand.",
    },
    "silent_load": {
        "short": "Silent load: re-reading an unchanged value",
        "help": "Paper Def. 3: two successive loads L1, L2 from location "
                "M are silent iff they observe the same value with no "
                "intervening store changing it.",
    },
    "redundant_load": {
        "short": "Redundant load: same buffer read at identical indices "
                 "more than once",
        "help": "Paper Def. 3 at the operation level: the same unmutated "
                "buffer gathered or sliced into a new buffer with "
                "identical index chains more than once, or a "
                "loop-invariant load re-executed on every loop trip.",
    },
    "dead_param": {
        "short": "Dead parameter: a buffer marshalled in but never read",
        "help": "Paper Def. 1 at allocation granularity: a traced step's "
                "input that reaches no output and no store into an "
                "argument — e.g. dead expert weights in MoE dispatch, "
                "unused cache leaves. The buffer is allocated, "
                "transferred and held live for nothing.",
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
    "redundant_collective": {
        "short": "Redundant collective: identical collective issued twice",
        "help": "Tier-2 traced-step analysis: two collectives of the same "
                "kind over the same operand shape and producer move the "
                "same bytes twice.",
    },
    "recompute": {
        "short": "Recompute: identical expensive op executed twice",
        "help": "Tier-2 traced-step analysis: a matrix product, "
                "convolution or large reduction computed twice over the "
                "same operand values — the same flops spent twice "
                "(a missed reuse, or intentional remat; rank tells you if "
                "it matters).",
    },
    "reshard_copy": {
        "short": "Reshard copy: large layout change materialized",
        "help": "Tier-2 traced-step analysis: a copy of a permuted view or "
                "a copy_ over the reshard threshold that only rearranges "
                "bytes.",
    },
    "dot_padding": {
        "short": "Padded product: flops spent on padding",
        "help": "Tier-2 traced-step analysis: a matrix product whose "
                "operand was padded (constant_pad_nd); the padded rows' "
                "flops compute values that are discarded.",
    },
    "prefill_padding": {
        "short": "Prefill padding burn: tokens computed then masked away",
        "help": "Serve-side: bucket padding in batched prefill computes "
                "attention for positions that are discarded.",
    },
    "rejected_draft_store": {
        "short": "Rejected draft store: KV written for tokens verification "
                 "discarded",
        "help": "Paper Def. 1 in speculative decoding: draft tokens past "
                "the first mismatch still wrote their KV into the cache "
                "(overwrite mode); rollback commits exactly the accepted "
                "rows and drives this to zero.",
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
    "kernel_rejected_draft_store": {
        "short": "Kernel-counted rejected-draft store (exact, in-kernel)",
        "help": "Tier 4: verify-kernel store counters; equals 1-accept "
                "under overwrite and is provably 0 under rollback.",
    },
    "fleet_silent_prefix_load": {
        "short": "Fleet-level silent prefix load: prefix re-prefilled on "
                 "one replica while resident on another",
        "help": "Paper Def. 3 measured across serving replicas (the "
                "redundancy fraction of Su et al.'s Redundant Loads, "
                "OJXPerf's replica-detection framing): at dispatch time "
                "some replica already held this prompt prefix's KV "
                "pages, but the routed replica recomputed them. "
                "Prefix-aware routing through the global prefix tier "
                "(serve/global_prefix.py) turns the finding into a "
                "cross-replica cache hit.",
    },
    "replica_kv_page": {
        "short": "Bit-identical KV pool pages (dedup opportunity)",
        "help": "Object tier (OJXPerf replica detection): content "
                "digests of live KV pages collide across the fleet — "
                "duplicated prefixes the PrefixIndex missed (same-burst "
                "admissions registered after prefill, or reuse cut at "
                "mismatched page-granularity boundaries). The result's "
                "location is the duplicate page's allocation site "
                "(PageAllocator.alloc). Fix: content-addressed page "
                "dedup (content_dedup on router + engine).",
    },
    "replica_param": {
        "short": "Weight tensors replicated across serving replicas",
        "help": "Object tier (OJXPerf replica detection): the same "
                "parameter bytes live once per replica. Fix: a shared "
                "weight arena mapped once per host, replicas get views.",
    },
    "replica_opt_state": {
        "short": "Bit-identical optimizer-state leaves",
        "help": "Object tier (OJXPerf replica detection): optimizer "
                "moments that are byte-equal (typically still "
                "zero-initialized). Fix: dedup or lazy-materialize on "
                "first nonzero update.",
    },
    "replica_draft_window": {
        "short": "Bit-identical speculative draft windows",
        "help": "Object tier (OJXPerf replica detection): per-slot "
                "draft windows holding the same proposal bytes.",
    },
}

_TIER_NAMES = {0: "static graph lint", 1: "interpreter",
               2: "traced step",
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


def _location(f: Finding, src_root: Optional[str]) -> Dict[str, Any]:
    file = f.meta.get("file")
    line = int(f.meta.get("line", 0) or 0)
    if file:
        uri = str(file).replace(os.sep, "/")
        loc: Dict[str, Any] = {"artifactLocation": {"uri": uri}}
        if src_root:
            rootu = str(src_root).rstrip("/\\").replace(os.sep, "/") + "/"
            if uri.startswith(rootu):
                loc["artifactLocation"] = {
                    "uri": uri[len(rootu):], "uriBaseId": "SRCROOT"}
        if line > 0:
            loc["region"] = {"startLine": line}
        return {"physicalLocation": loc}
    # no source file (e.g. dead_param names a buffer, tier-3 names a
    # leaf path): a logical location keeps the result addressable
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
             src_root: Optional[str] = None,
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
            "locations": [_location(f, src_root)],
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
    if src_root:
        run["originalUriBaseIds"] = {
            "SRCROOT": {"uri": "file://"
                        + str(src_root).replace(os.sep, "/").rstrip("/")
                        + "/"}}
    return {"$schema": SARIF_SCHEMA, "version": SARIF_VERSION,
            "runs": [run]}


def write_sarif(profile: WasteProfile, path: str, *,
                src_root: Optional[str] = None,
                tool_version: str = "0") -> Dict[str, Any]:
    doc = to_sarif(profile, src_root=src_root, tool_version=tool_version)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return doc
