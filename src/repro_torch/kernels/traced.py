"""The kernel entry points as single graph nodes under an abstract trace.

``core/graph_trace.py`` traces a step on fake tensors (no storage, no
launch). Under such a trace each entry point of ``kernels/ops.py`` calls
its twin here instead of its body: one ``torch.library`` operator in the
``repro_torch`` namespace whose fake implementation only gives the shapes
and dtypes of what the kernel writes. So the graph holds one node per
kernel call (``repro_torch.paged_decode`` and so on), as a compiled step
holds one custom call per ``pallas_call``, and nothing reaches
``kernels/build.py``. The backward of B4 and B5 is an operator of its
own (``attention_bwd``, ``rmsnorm_bwd``), reached through the operator's
autograd formula. An operator that writes a pool in place declares it
(``mutates_args``), so the graph shows the store.

The operators are for tracing only: their eager bodies raise, and the
entry points call them only when their first argument is a fake tensor
(``core/interpreter.py:recorded``), so an eager call runs exactly as
before. The masked attention over a cache is plain PyTorch on every
device and traces as its composition; the paged scatter is plain too,
but its store of the kept rows is sized by data, so it traces as its
widest store (``paged_update``, ``widest_store``).

``label`` names a node as tier 1 names the entry point (``ops.<name>``),
a backward as ``ops.<name>.bwd``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref as _ref

NS = "repro_torch"
Pair = Tuple[torch.Tensor, torch.Tensor]
Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _trace_only(name: str):
    raise RuntimeError(f"{NS}::{name} is a trace-time operator; eager "
                       f"calls go through kernels/ops.py")


def label(op_name: str) -> str:
    """``ops.<entry point>`` of an operator name (``.bwd`` for a
    backward; both window modes are ``ops.paged_window``)."""
    if op_name.endswith("_bwd"):
        return f"ops.{op_name[:-4]}.bwd"
    if op_name.endswith("_defer"):
        return f"ops.{op_name[:-6]}"
    return f"ops.{op_name}"


# ----------------------------------------------------------------------
# B4: flash attention, forward and backward
# ----------------------------------------------------------------------
@torch.library.custom_op(f"{NS}::attention", mutates_args=())
def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool) -> Pair:
    _trace_only("attention")


@_attention.register_fake
def _(q, k, v, causal):
    B, Sq, Hq, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, Hq, Sq),
                                             dtype=torch.float32)


@torch.library.custom_op(f"{NS}::attention_bwd", mutates_args=())
def _attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   causal: bool) -> Triple:
    _trace_only("attention_bwd")


@_attention_bwd.register_fake
def _(q, k, v, out, lse, dout, causal):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _attention_setup(ctx, inputs, output):
    q, k, v, causal = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal = causal


def _attention_grad(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _attention_bwd(q, k, v, out, lse, dout, ctx.causal)
    return dq, dk, dv, None


_attention.register_autograd(_attention_grad, setup_context=_attention_setup)


def cache_free(q_offset, kv_len, kv_valid) -> bool:
    """Whether ``ops.attention`` takes the flash kernel: no cache mask
    and offset 0 (the training forward and the encoder)."""
    return (kv_len is None and kv_valid is None
            and isinstance(q_offset, int) and q_offset == 0)


def attention(q, k, v, *, causal: bool = True, q_offset=0,
              kv_len: Optional[torch.Tensor] = None,
              kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    if cache_free(q_offset, kv_len, kv_valid):
        return _attention(q, k, v, causal)[0]
    return _ref.attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                              kv_len=kv_len, kv_valid=kv_valid)


# ----------------------------------------------------------------------
# B5: RMSNorm, forward and backward
# ----------------------------------------------------------------------
@torch.library.custom_op(f"{NS}::rmsnorm", mutates_args=())
def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> Pair:
    _trace_only("rmsnorm")


@_rmsnorm.register_fake
def _(x, scale, eps):
    rows = x.numel() // max(x.shape[-1], 1)
    return x.new_empty(x.shape), x.new_empty((rows,), dtype=torch.float32)


@torch.library.custom_op(f"{NS}::rmsnorm_bwd", mutates_args=())
def _rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor,
                 dy: torch.Tensor, eps: float) -> Pair:
    _trace_only("rmsnorm_bwd")


@_rmsnorm_bwd.register_fake
def _(x, scale, rstd, dy, eps):
    return x.new_empty(x.shape), scale.new_empty(scale.shape)


def _rmsnorm_setup(ctx, inputs, output):
    x, scale, eps = inputs
    ctx.save_for_backward(x, scale, output[1])
    ctx.eps = eps


def _rmsnorm_grad(ctx, dy, _drstd):
    x, scale, rstd = ctx.saved_tensors
    dx, dscale = _rmsnorm_bwd(x, scale, rstd, dy, ctx.eps)
    return dx, dscale, None


_rmsnorm.register_autograd(_rmsnorm_grad, setup_context=_rmsnorm_setup)


def rmsnorm(x, scale, eps: float = 1e-5) -> torch.Tensor:
    return _rmsnorm(x, scale, eps)[0]


# ----------------------------------------------------------------------
# B1 / B2: paged decode and window (the store into the pool in place)
# ----------------------------------------------------------------------
def _paged_fake(q, lse_shape):
    B = q.shape[0]
    return (q.new_empty(q.shape), q.new_empty(lse_shape, dtype=torch.float32),
            q.new_empty((B, 3), dtype=torch.int32))


@torch.library.custom_op(f"{NS}::paged_decode",
                         mutates_args=("pool_k", "pool_v"))
def _paged_decode(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                  pool_k: torch.Tensor, pool_v: torch.Tensor,
                  pt: torch.Tensor, idx: torch.Tensor) -> Triple:
    _trace_only("paged_decode")


@_paged_decode.register_fake
def _(q, k_new, v_new, pool_k, pool_v, pt, idx):
    return _paged_fake(q, (q.shape[0], q.shape[2]))


@torch.library.custom_op(f"{NS}::paged_window",
                         mutates_args=("pool_k", "pool_v"))
def _paged_window(q: torch.Tensor, k_win: torch.Tensor, v_win: torch.Tensor,
                  pool_k: torch.Tensor, pool_v: torch.Tensor,
                  pt: torch.Tensor, idx: torch.Tensor) -> Triple:
    _trace_only("paged_window")


@torch.library.custom_op(f"{NS}::paged_window_defer", mutates_args=())
def _paged_window_defer(q: torch.Tensor, k_win: torch.Tensor,
                        v_win: torch.Tensor, pool_k: torch.Tensor,
                        pool_v: torch.Tensor, pt: torch.Tensor,
                        idx: torch.Tensor) -> Triple:
    _trace_only("paged_window_defer")


def _window_fake(q, k_win, v_win, pool_k, pool_v, pt, idx):
    B, S, Hq, _ = q.shape
    return _paged_fake(q, (B, Hq, S))


_paged_window.register_fake(_window_fake)
_paged_window_defer.register_fake(_window_fake)


def paged_decode_lse(q, k_new, v_new, pool_k, pool_v, pt, idx, *,
                     tol: float = 0.0) -> Triple:
    return _paged_decode(q, k_new, v_new, pool_k, pool_v, pt, idx)


def paged_window_lse(q, k_win, v_win, pool_k, pool_v, pt, idx, *,
                     store: bool = True, chunk: bool = False,
                     tol: float = 0.0) -> Triple:
    op = _paged_window if store else _paged_window_defer
    return op(q, k_win, v_win, pool_k, pool_v, pt, idx)


def paged_decode(q, k_new, v_new, pool_k, pool_v, pt, idx, *,
                 counters: bool = False):
    out, _, cnt = paged_decode_lse(q, k_new, v_new, pool_k, pool_v, pt, idx)
    return out, pool_k, pool_v, (cnt if counters else None)


def paged_window(q, k_win, v_win, pool_k, pool_v, pt, idx, *,
                 store: bool = True, counters: bool = False):
    out, _, cnt = paged_window_lse(q, k_win, v_win, pool_k, pool_v, pt, idx,
                                   store=store)
    return out, pool_k, pool_v, (cnt if counters else None)


# ----------------------------------------------------------------------
# Masked row stores (plain PyTorch, not kernels)
# ----------------------------------------------------------------------
def widest_store(dst: torch.Tensor, index, src: torch.Tensor) -> None:
    """A masked store ``dst[index[keep]] = src[keep]`` as a trace records
    it: which rows are kept is data, which a trace cannot size, so every
    candidate row is stored (``index``, a tuple of integer tensors of
    src's leading shape, clamped into dst), the widest store the call can
    make."""
    dst[tuple(i.clamp(0, n - 1) for i, n in zip(index, dst.shape))] = \
        src.to(dst.dtype)


def paged_update(pool_k, pool_v, k_new, v_new, pt, idx, length=None):
    """``ref.paged_update`` as its widest store."""
    P, ps = pool_k.shape[:2]
    _, _, flat = _ref._targets(pool_k, pt, idx, k_new.shape[1])
    for pool, new in ((pool_k, k_new), (pool_v, v_new)):
        widest_store(pool.view((P * ps,) + pool.shape[2:]), (flat,), new)
    return pool_k, pool_v


# ----------------------------------------------------------------------
# B3: the silent compare
# ----------------------------------------------------------------------
@torch.library.custom_op(f"{NS}::silent_count", mutates_args=())
def _silent_count(a: torch.Tensor, b: torch.Tensor,
                  tol: float) -> torch.Tensor:
    _trace_only("silent_count")


@_silent_count.register_fake
def _(a, b, tol):
    return a.new_empty((), dtype=torch.int32)


def silent_count(a, b, tol: float = 0.01) -> torch.Tensor:
    return _silent_count(a, b, tol)
