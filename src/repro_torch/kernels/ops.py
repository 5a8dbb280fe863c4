"""Model-facing kernel entry points, dispatched by the tensors' device.

A CUDA tensor reaching ``paged_decode`` or ``paged_window`` launches the
hand-written Hopper kernel (``csrc/*.cu``) or raises; a CPU tensor takes
the kernel's plain version from ``ref.py``. There is no switch and no
fallback. The paged scatter/gather and the masked attention of the dense
per-slot cache are plain PyTorch on every device, as the reference left
them to XLA.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_prefill import paged_window_attention
from repro_torch.kernels.paged_attention import paged_decode_attention

# store-site waste-counter tolerance (kernel tier): exact equality, the
# paper's Def.-2 silent-store semantics for same-dtype overwrites
COUNTER_TOL = 0.0

paged_update = _ref.paged_update
paged_gather = _ref.paged_gather
paged_store_counts = _ref.paged_store_counts


def attention(q, k, v, *, causal: bool = True, q_offset=0,
              kv_len: Optional[torch.Tensor] = None,
              kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked GQA attention over a cache (``kv_len``/offsets given): the
    plain composition on every device, as in the reference. The
    cache-free causal case is the flash kernel's, which is not ported
    yet, so it raises on CUDA."""
    if (q.device.type == "cuda" and kv_len is None and kv_valid is None
            and isinstance(q_offset, int) and q_offset == 0):
        raise NotImplementedError(
            "cache-free attention on CUDA needs the flash attention "
            "kernel, which is not ported yet")
    return _ref.attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                              kv_len=kv_len, kv_valid=kv_valid)


def paged_decode(q, k_new, v_new, pool_k, pool_v, pt, idx, *,
                 counters: bool = False):
    """One-token paged decode: attend the slot history + the new K/V row
    and store the row through the page table (in place).

    Returns ``(out, pool_k, pool_v, cnt)``; cnt is the (B, 3) int32
    [stored, silent, dropped] store-site counter block, or None when
    ``counters=False``."""
    out, _, cnt = paged_decode_attention(q, k_new, v_new, pool_k, pool_v,
                                         pt, idx, tol=COUNTER_TOL)
    return out, pool_k, pool_v, (cnt if counters else None)


def paged_window(q, k_win, v_win, pool_k, pool_v, pt, idx, *,
                 store: bool = True, counters: bool = False):
    """S-token paged window forward (prefill chunk / verify window): the
    committed history + the in-window causal part; store mode writes the
    window rows into the pool (in place). Returns
    ``(out, pool_k, pool_v, cnt)`` like ``paged_decode``."""
    out, _, cnt, ck, cv = paged_window_attention(
        q, k_win, v_win, pool_k, pool_v, pt, idx, store=store,
        tol=COUNTER_TOL)
    return out, ck, cv, (cnt if counters else None)


def silent_fraction(a, b, tol: float = 0.01) -> float:
    """Fraction of silent (unchanged within tol) elements between a and b,
    computed as the reference computes it (an f32 count over f32 size)."""
    a = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
    b = torch.as_tensor(np.asarray(b) if not torch.is_tensor(b) else b)
    cnt = _ref.silent_compare_ref(a, b, tol)
    return float(cnt.to(torch.float32) / max(a.numel(), 1))
