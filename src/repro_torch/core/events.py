"""Typed memory-event substrate shared by every tier (DESIGN.md §2).

The parts the serving slice needs: the event kinds, ``MemEvent`` (one
load/store over a logical buffer, with its content digest), and the
single approximate-equality definition of "silent" used by the
detectors, the kernel-tier store counters and their plain versions.
The sampler and ``EventEngine`` come with the tier-1 slice.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

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


# ----------------------------------------------------------------------
@dataclass
class MemEvent:
    """One load/store of `nelems` elements at logical address `address`."""
    kind: str                       # LOAD | STORE
    address: int
    nelems: int
    itemsize: int
    values: Optional[np.ndarray]    # full stored/loaded value (by ref)
    ctx: Tuple[str, ...]            # full calling context of the access

    @property
    def nbytes(self) -> int:
        return self.nelems * self.itemsize

    def digest(self, size: int = 8) -> str:
        """Content fingerprint (silent-data-load hashing)."""
        arr = np.ascontiguousarray(np.asarray(self.values))
        return hashlib.blake2b(arr.tobytes(), digest_size=size).hexdigest()
