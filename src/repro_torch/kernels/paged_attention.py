"""Paged-attention decode: one new token per slot attends its paged K/V
history, its K/V row is stored through the page table, and the store is
counted at the store site as [stored, silent, dropped] elements (the
kernel tier of the detector stack, DESIGN.md § Kernel tier).

CUDA tensors go to the hand-written kernel ``csrc/paged_decode.cu``;
CPU tensors go to its plain version, ``ref.paged_decode_ref``. There is
no other path: a tensor on any other device raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

_SIGNATURES = {"paged_decode": [build.PTR] * 11 + [build.INT] * 6
               + [build.FLOAT] * 2 + [build.INT] * 2 + [build.PTR],
               "paged_decode_workspace": [build.INT] * 5 + [build.PTR]}


def paged_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, pt: torch.Tensor,
                           idx: torch.Tensor, *, tol: float = 0.0):
    """q/k_new/v_new: (B, 1, H*, D); pool: (P, page, Hkv, D); pt: (B, M)
    int32 (-1 = unmapped); idx: (B,) int32 write positions (< 0 = idle).

    Stores the new K/V row into the pool IN PLACE and returns
    ``(out, lse, counters)``: out (B, 1, Hq, D) in q's dtype; lse (B, Hq)
    f32 log-sum-exp (NEG_INF where nothing was attended); counters (B, 3)
    int32 [stored, silent, dropped] elements of the store, measured
    against the pool content it overwrote. Idle slots: the kernel returns
    out 0, the plain version NaN.
    """
    if q.device.type == "cpu":
        out, lse, _, _, cnt = ref.paged_decode_ref(
            q, k_new, v_new, pool_k, pool_v, pt, idx, tol=tol)
        return out, lse, cnt
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention runs on CUDA or CPU "
                         f"tensors, not {q.device}")
    if q.shape[1] != 1:
        raise ValueError(f"paged decode takes one token, q {tuple(q.shape)}")
    build.check_paged("paged decode", q, k_new, v_new, pool_k, pool_v, pt,
                      idx)
    B, _, Hq, D = q.shape
    _, ps, Hkv, _ = pool_k.shape
    M = pt.shape[1]
    lib = build.load("paged_decode", _SIGNATURES)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    ints, part = build.workspace(lib, "paged_decode_workspace", q.device, B,
                                 Hq, Hkv, D, M)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.paged_decode(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            pool_k.data_ptr(), pool_v.data_ptr(), pt.data_ptr(),
            idx.data_ptr(), out.data_ptr(), lse.data_ptr(), ints.data_ptr(),
            None if part is None else part.data_ptr(),
            B, Hq, Hkv, D, ps, M, 1.0 / math.sqrt(D), tol,
            build.dtype_code(q), build.dtype_code(pool_k), stream)
    build.launched(rc, "paged_decode")
    paged_decode_attention.launches += 1
    return out, lse, ints[:3 * B].view(B, 3)


# kernel launches since the count was last set to 0 (CPU calls not counted)
paged_decode_attention.launches = 0
