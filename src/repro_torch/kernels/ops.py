"""Model-facing kernel entry points, dispatched by the tensors' device.

A CUDA tensor reaching ``paged_decode``, ``paged_window``, the cache-free
``attention``, ``rmsnorm``, ``silent_fraction`` or ``silent_count``
launches the hand-written Hopper kernel (``csrc/*.cu``, or Triton for the
silent compare) or raises; a CPU tensor takes the kernel's
plain version from ``ref.py``. There is no switch and no fallback. The
paged scatter/gather and the masked attention of the dense per-slot cache
are plain PyTorch on every device, as the reference left them to XLA.

Under a tier-1 recording (``core/interpreter.py``) each entry point
records itself as one operation ``ops.<name>`` on every device: a LOAD
per tensor input, a STORE per output and per pool written in place.
Outside a recording it runs as it is.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.interpreter import recorded
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_prefill import paged_window_attention
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.rmsnorm import RMSNorm, rmsnorm_forward
from repro_torch.kernels.silent_compare import silent_compare

# store-site waste-counter tolerance (kernel tier): exact equality, the
# paper's Def.-2 silent-store semantics for same-dtype overwrites
COUNTER_TOL = 0.0

paged_update = _ref.paged_update
paged_gather = _ref.paged_gather
paged_store_counts = _ref.paged_store_counts


@recorded("attention")
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


@recorded("rmsnorm")
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm of x (..., d) with scale (d,), differentiable. CPU
    tensors take ``ref.rmsnorm_ref`` (autograd through its ops); CUDA
    tensors the CUDA kernels, through ``RMSNorm`` when a gradient is
    needed, else the forward kernel alone, which saves nothing."""
    if x.device.type == "cpu":
        return _ref.rmsnorm_ref(x, scale, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNorm.apply(x, scale, eps)
    return rmsnorm_forward(x, scale, eps)[0]


@recorded("paged_decode", writes=lambda a: (a["pool_k"], a["pool_v"]))
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


@recorded("paged_window", writes=lambda a: (
    (a["pool_k"], a["pool_v"]) if a["store"] else ()))
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


@recorded("silent_count")
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
