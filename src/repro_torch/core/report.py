"""Profile JSON round trip (paper §5.6, DESIGN.md §2): every tier emits
the same findings.WasteProfile, written and read losslessly so shards
can be merged post-mortem (``findings.merge_profiles``). The JSON is the
reference package's: either package loads the other's profiles.
"""
from __future__ import annotations

import os

from repro_torch.core.findings import WasteProfile


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
