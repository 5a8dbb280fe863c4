"""Fused paged window attention: an S-token window per slot at offset
``idx`` attends the committed paged history plus the causal part of the
window. Store mode (the admission prefill, speculative verify
"overwrite") also writes the window rows into their pages and counts the
stores as [stored, silent, dropped] elements; defer mode (verify
"rollback") leaves the pool and the counters alone, and defer mode on a
chunk (``chunk=True``: a rank's localized table of a page-chunked pool)
takes a window row only where the table does not mark its page as
another rank's (``ref.NOT_MINE``), so each row counts on one rank.

CUDA tensors go to the hand-written kernels of ``csrc/paged_window.cu``,
one launch a call through the route the C entry picks from the shapes
and dtypes (``ROUTES``); CPU tensors go to their plain version,
``ref.paged_window_ref``. There is no other path: a tensor on any other
device raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

_SIGNATURES = {"paged_window": [build.PTR] * 11 + [build.INT] * 9
               + [build.FLOAT] * 2 + [build.INT] * 2 + [build.PTR],
               "paged_window_workspace": [build.INT] * 8 + [build.PTR]}

# the kernel's routes (csrc/paged_window.cu), for paged_window_on_route
ROUTES = {"cuda_core": 1, "tensor_core": 2, "split": 3}


def paged_window_attention(q: torch.Tensor, k_win: torch.Tensor,
                           v_win: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, pt: torch.Tensor,
                           idx: torch.Tensor, *, store: bool = True,
                           tol: float = 0.0, chunk: bool = False):
    """q: (B, S, Hq, D) at per-slot offsets idx (B,) int32; k_win/v_win:
    (B, S, Hkv, D); pool: (P, page, Hkv, D); pt: (B, M) int32.

    Returns ``(out, lse, counters, pool_k, pool_v)``: out (B, S, Hq, D);
    lse (B, Hq, S) f32 (NEG_INF where nothing was attended); counters
    (B, 3) int32, zero in defer mode. Store mode writes the pools IN
    PLACE and returns the same tensors. Rows that attend nothing (idle
    slots): the kernel returns 0, the plain version NaN.
    """
    if q.device.type == "cpu":
        out, lse, _, _, cnt = ref.paged_window_ref(
            q, k_win, v_win, pool_k, pool_v, pt, idx, store=store, tol=tol,
            chunk=chunk)
        return out, lse, cnt, pool_k, pool_v
    return _launch(0, q, k_win, v_win, pool_k, pool_v, pt, idx,
                   _mode(store, chunk), tol)


def paged_window_on_route(route: str, q: torch.Tensor, k_win: torch.Tensor,
                          v_win: torch.Tensor, pool_k: torch.Tensor,
                          pool_v: torch.Tensor, pt: torch.Tensor,
                          idx: torch.Tensor, *, store: bool = True,
                          tol: float = 0.0, chunk: bool = False):
    """``paged_window_attention`` on CUDA tensors through the kernel route
    ``route`` (a key of ``ROUTES``) instead of the one the kernel picks:
    for measuring and testing each route on the same inputs. Raises when
    the route does not take these inputs."""
    return _launch(ROUTES[route], q, k_win, v_win, pool_k, pool_v, pt, idx,
                   _mode(store, chunk), tol)


def _mode(store: bool, chunk: bool) -> int:
    """The C entry's window mode: 1 store, 0 defer, 2 defer on a chunk
    (csrc/common.cuh's WIN_*)."""
    if store and chunk:
        raise ValueError("chunk=True is a defer mode (store=False)")
    return 1 if store else (2 if chunk else 0)


def _launch(route, q, k_win, v_win, pool_k, pool_v, pt, idx, mode, tol):
    if q.device.type != "cuda":
        raise ValueError(f"paged_window_attention runs on CUDA or CPU "
                         f"tensors, not {q.device}")
    build.check_paged("paged window", q, k_win, v_win, pool_k, pool_v, pt,
                      idx)
    B, S, Hq, D = q.shape
    _, ps, Hkv, _ = pool_k.shape
    M = pt.shape[1]
    act = build.dtype_code(q)
    lib = build.load("paged_window", _SIGNATURES)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    ints, part = build.workspace(lib, "paged_window_workspace", q.device, B,
                                 S, Hq, Hkv, D, M, route, act)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.paged_window(
            q.data_ptr(), k_win.data_ptr(), v_win.data_ptr(),
            pool_k.data_ptr(), pool_v.data_ptr(), pt.data_ptr(),
            idx.data_ptr(), out.data_ptr(), lse.data_ptr(), ints.data_ptr(),
            None if part is None else part.data_ptr(), B, S, Hq, Hkv, D, ps,
            M, mode, route, 1.0 / math.sqrt(D), tol, act,
            build.dtype_code(pool_k), stream)
    build.launched(rc, "paged_window")
    paged_window_attention.launches += 1
    return out, lse, ints[:3 * B].view(B, 3), pool_k, pool_v


# kernel launches since the count was last set to 0 (CPU calls not counted)
paged_window_attention.launches = 0
