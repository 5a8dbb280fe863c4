"""Speculative verify over the paged pool: a mode wrapper over the paged
window kernel (``flash_prefill.paged_window_attention``, csrc/
paged_window.cu), with no kernel of its own.

Counterpart of: src/repro/kernels/paged_verify.py:paged_verify_attention.
Verify pushes a width-(k+1) draft window against the pool as prefill
pushes a prompt chunk; only the pool's fate differs:

  * ``mode="overwrite"``: all k+1 window rows are stored through the page
    table and counted; rows past the accept point are rejected draft
    stores, which the engine's kernel-tier classification attributes.
  * ``mode="defer"`` (rollback): the pool is untouched and the counters
    stay zero; ``LM.commit_verify`` stores the accepted prefix later, so
    rejected rows never become stores.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_prefill import paged_window_attention

MODES = ("overwrite", "defer")


def paged_verify_attention(q: torch.Tensor, k_win: torch.Tensor,
                           v_win: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, pt: torch.Tensor,
                           idx: torch.Tensor, *, mode: str = "overwrite",
                           tol: float = 0.0):
    """q/k_win/v_win: (B, k+1, H*, D) at per-slot offsets ``idx``.

    Returns ``(out, lse, counters, pool_k, pool_v)`` as
    ``paged_window_attention`` does; the pools are left unchanged in
    ``defer`` mode."""
    if mode not in MODES:
        raise ValueError(f"paged verify mode {mode!r} not in {MODES}")
    return paged_window_attention(q, k_win, v_win, pool_k, pool_v, pt, idx,
                                  store=mode == "overwrite", tol=tol)
