"""Post-mortem profile rendering and merging (paper §5.6, DESIGN.md §2).

Every tier emits the same findings.WasteProfile, so merging is uniform:
per-device / per-process / per-tier profiles coalesce with the paper's
rule — ⟨C1,C2⟩ pairs merge iff both calling contexts (and kind/tier)
match; estimator counters and totals aggregate. Profiles round-trip
through JSON losslessly, so shards can be written per host and merged
post-mortem. The JSON is the reference package's: either package loads
the other's profiles.
"""
from __future__ import annotations

import os
from typing import Iterable

from repro_torch.core.findings import WasteProfile, merge_profiles


def merge_reports(reports: Iterable[WasteProfile]) -> WasteProfile:
    """Mutating left-fold merge (seed API): first profile absorbs the rest."""
    it = iter(reports)
    first = next(it)
    for r in it:
        first.merge(r)
    return first


def merge_shards(reports: Iterable[WasteProfile]) -> WasteProfile:
    """Pure cross-shard merge: inputs untouched, fresh merged profile."""
    return merge_profiles(reports)


def render(report: WasteProfile, top_k: int = 5) -> str:
    return report.render(top_k=top_k)


def dump_json(report: WasteProfile, path: str) -> str:
    """Write the profile to `path` (lossless JSON round-trip). Parent
    directories are created — a long profiled run must not lose its
    profile to a missing output directory at the very end."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    text = report.to_json(indent=2)
    with open(path, "w") as f:
        f.write(text)
    return path


def load_json(path: str) -> WasteProfile:
    with open(path) as f:
        return WasteProfile.from_json(f.read())
