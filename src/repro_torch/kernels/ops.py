"""Model-facing kernel entry points, dispatched by the tensors' device.

A CUDA tensor reaching ``paged_decode``, ``paged_window``, the cache-free
``attention``, ``silent_fraction`` or ``silent_count`` launches the
hand-written Hopper kernel (``csrc/*.cu``, or Triton for the silent
compare) or raises; a CPU tensor takes the kernel's plain version from
``ref.py``. There is no switch and no fallback. The paged scatter/gather
and the masked attention of the dense per-slot cache are plain PyTorch on
every device, as the reference left them to XLA.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_prefill import paged_window_attention
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.silent_compare import silent_compare

# store-site waste-counter tolerance (kernel tier): exact equality, the
# paper's Def.-2 silent-store semantics for same-dtype overwrites
COUNTER_TOL = 0.0

paged_update = _ref.paged_update
paged_gather = _ref.paged_gather
paged_store_counts = _ref.paged_store_counts


def attention(q, k, v, *, causal: bool = True, q_offset=0,
              kv_len: Optional[torch.Tensor] = None,
              kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA attention, differentiable. The cache-free case (no
    ``kv_len``/``kv_valid``, offset 0: the training forward) is the flash
    kernel's whatever Sq is; masked attention over a cache is the plain
    composition on every device, as in the reference."""
    if (kv_len is None and kv_valid is None and isinstance(q_offset, int)
            and q_offset == 0):
        return flash_attention(q, k, v, causal=causal)
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


def silent_count(a, b, tol: float = 0.01) -> torch.Tensor:
    """Count of silent (unchanged within tol) elements between a and b, a
    0-d int32 tensor: the silent-compare kernel on CUDA tensors, its
    plain version on CPU tensors and numpy arrays."""
    a = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
    b = b if torch.is_tensor(b) else torch.as_tensor(np.asarray(b))
    return silent_compare(a, b, tol)


def silent_fraction(a, b, tol: float = 0.01) -> float:
    """Fraction of silent (unchanged within tol) elements between a and b,
    computed as the reference computes it (an f32 count over f32 size)."""
    n = max(int(np.prod(np.shape(a))), 1)
    return float(silent_count(a, b, tol).to(torch.float32) / n)
