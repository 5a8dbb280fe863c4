"""Cache-free flash attention, forward and backward: the attention of the
training forward (every layer of ``LM.backbone``) and of its gradient.

The forward computes what the reference's Pallas ``flash_attention``
computes (blocked GQA attention, causal masks top-left aligned) and also
returns the f32 log-sum-exp; the backward is the counterpart of the
hand-written VJP the reference trains through (``flash_xla._bwd_rule``).
Both are bound to autograd by ``FlashAttention``.

CUDA tensors go to the hand-written kernels of ``csrc/flash_attention.cu``;
CPU tensors go to their plain versions, ``ref.flash_attention_ref`` and
``ref.flash_attention_bwd_ref``. There is no other path: a tensor on any
other device raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

HEAD_DIMS = (16, 32, 64, 128)
STRIDES = ctypes.c_int64 * 3
_SIGNATURES = {
    "flash_attention_fwd": [build.PTR] * 5 + [build.INT] * 6
    + [build.PTR] * 4 + [build.INT, build.FLOAT, build.INT, build.PTR],
    "flash_attention_bwd": [build.PTR] * 10 + [build.INT] * 6
    + [build.PTR] * 7 + [build.INT, build.FLOAT, build.INT, build.PTR],
}


def _strides(t: torch.Tensor):
    """(batch, row, head) element strides of a (B, S, H, D) tensor."""
    return STRIDES(*t.stride()[:3])


def _check(q, k, v) -> None:
    B, Sq, Hq, D = q.shape
    if (k.ndim != 4 or v.shape != k.shape or k.shape[0] != B
            or k.shape[3] != D or Hq % k.shape[2]):
        raise ValueError(f"flash attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    if Sq == 0 or k.shape[1] == 0:
        raise ValueError("flash attention needs at least one query and "
                         "one key")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash attention: q, k and v share one dtype")
    build.dtype_code(q)                 # float32 or bfloat16, else TypeError
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash attention: {name} must be contiguous "
                             f"in its last dimension")


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True):
    """q: (B, Sq, Hq, D), k/v: (B, Skv, Hkv, D), read by stride. Returns
    ``(out, lse)``: out (B, Sq, Hq, D) in q's dtype, lse (B, Hq, Sq) f32
    (NEG_INF where a row sees no key). No autograd: see ``FlashAttention``."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, "
                         f"not {q.device}")
    _check(q, k, v)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    lib = build.load("flash_attention", _SIGNATURES)
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Sq, Skv, Hq, Hkv, D, _strides(q),
            _strides(k), _strides(v), _strides(out), int(causal),
            1.0 / math.sqrt(D), build.dtype_code(q), stream)
    build.launched(rc, "flash_attention_fwd")
    flash_attention_forward.launches += 1
    return out, lse


def flash_attention_backward(q, k, v, out, lse, dout, causal: bool = True):
    """Gradients ``(dq, dk, dv)`` of ``flash_attention_forward``'s out
    against ``dout`` (same shape as out), from the saved ``out`` and
    ``lse``; dk and dv are summed over each kv head's query heads."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, "
                         f"not {q.device}")
    _check(q, k, v)
    if dout.stride(-1) != 1:            # autograd may hand an expanded grad
        dout = dout.contiguous()
    if (dout.shape != q.shape or out.shape != q.shape
            or dout.dtype != q.dtype or out.dtype != q.dtype
            or out.stride(-1) != 1 or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError("flash attention backward: out and dout must be "
                         "q-shaped in q's dtype, lse contiguous f32")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    lib = build.load("flash_attention", _SIGNATURES)
    dq = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Skv, Hkv, D), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, Hq, Hkv, D,
            _strides(q), _strides(k), _strides(v), _strides(out),
            _strides(dout), _strides(dq), _strides(dk), int(causal),
            1.0 / math.sqrt(D), build.dtype_code(q), stream)
    build.launched(rc, "flash_attention_bwd")
    flash_attention_backward.launches += 1
    return dq, dk, dv


# kernel launches since the count was last set to 0 (CPU calls not counted)
flash_attention_forward.launches = 0
flash_attention_backward.launches = 0


class FlashAttention(torch.autograd.Function):
    """out = flash attention of (q, k, v); saves q, k, v, out and lse for
    the backward, which recomputes the probabilities from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout,
                                              ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Differentiable cache-free GQA attention, (B, Sq, Hq, D) out."""
    return FlashAttention.apply(q, k, v, causal)
