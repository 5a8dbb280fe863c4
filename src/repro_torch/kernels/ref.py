"""Plain PyTorch versions of the kernels' functions.

Torch twins of the reference's jnp oracles (and, for the flash
attention backward, of its hand-written VJP), held to them by the CPU
parity tests. They are the compute path for CPU tensors, and
``chip_smoke.py`` holds each hand-written kernel against them on the
card.

Unlike the functional reference, the paged store (``paged_update``)
writes the pool IN PLACE and returns the same tensors: the engine keeps
one stacked pool per sub-block and hands each layer a view of it, where
the reference's functional update costs a pool copy per call.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.events import silent_mask

# masked log-sum-exp: what a kernel reports for a row that attended nothing
NEG_INF = -1e30


# ----------------------------------------------------------------------
# Attention (GQA, causal, optional decode length-mask)
# ----------------------------------------------------------------------
def attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset=0,
                  kv_len: Optional[torch.Tensor] = None,
                  kv_valid: Optional[torch.Tensor] = None):
    """``attention_ref`` plus the per-(slot, head, row) log-sum-exp of the
    masked scaled scores, (B, Hq, Sq) f32, NEG_INF where nothing was
    attended (the kernels' lse layout)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scale = 1.0 / torch.sqrt(torch.tensor(float(D), dtype=torch.float32))
    scores = scores * scale.to(scores.device)

    dev = q.device
    mask = None
    if causal:
        if isinstance(q_offset, int) and q_offset == 0:
            qpos = torch.arange(Sq, device=dev)
        else:
            qpos = (torch.as_tensor(q_offset, device=dev).long()[..., None]
                    + torch.arange(Sq, device=dev))
        mask = qpos[..., :, None] >= torch.arange(Skv, device=dev)
    if kv_len is not None:
        lmask = (torch.arange(Skv, device=dev)
                 < torch.as_tensor(kv_len, device=dev)[..., None])
        lmask = lmask[..., None, :]              # (1,Skv) | (B,1,Skv)
        mask = lmask if mask is None else (mask & lmask)
    if kv_valid is not None:
        vmask = kv_valid[:, None, :]             # (B,1,Skv)
        mask = vmask if mask is None else (mask & vmask)
    if mask is not None:
        bmask = (mask[:, None, None] if mask.ndim == 3
                 else mask[None, None, None])
        scores = torch.where(bmask, scores, -torch.inf)

    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    lse = torch.logsumexp(scores, dim=-1)                 # (B,Hkv,G,Sq)
    lse = torch.where(torch.isfinite(lse), lse, NEG_INF)
    return out.reshape(B, Sq, Hq, D), lse.reshape(B, Hq, Sq)


def attention_ref(q, k, v, *, causal: bool = True, q_offset=0,
                  kv_len=None, kv_valid=None) -> torch.Tensor:
    """q: (B,Sq,Hq,D), k/v: (B,Skv,Hkv,D) -> (B,Sq,Hq,D). f32 scores.

    ``q_offset``/``kv_len`` are scalars or (B,) per-slot vectors;
    ``kv_valid`` is an optional (B,Skv) gather-validity mask."""
    return attention_lse(q, k, v, causal=causal, q_offset=q_offset,
                         kv_len=kv_len, kv_valid=kv_valid)[0]


# ----------------------------------------------------------------------
# Cache-free flash attention (the training forward) and its backward
# ----------------------------------------------------------------------
def _flash_scores(q, k, causal: bool):
    """Masked scaled f32 scores (B, Hkv, G, Sq, Skv) of the flash kernel:
    key kpos is visible to query qpos when kpos <= qpos (top-left
    aligned, both counted from 0) or always when not causal; masked
    entries are -inf."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    s = s * (1.0 / float(D) ** 0.5)
    if causal:
        vis = (torch.arange(Sq, device=q.device)[:, None]
               >= torch.arange(Skv, device=q.device)[None, :])
        s = torch.where(vis, s, -torch.inf)
    return s


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True):
    """The flash kernel's function: ``(out, lse)``. out (B, Sq, Hq, D) in
    q's dtype, from f32 probabilities and an f32 accumulator (the
    Pallas kernel's ``_flash_kernel``); lse (B, Hq, Sq) f32, NEG_INF and
    out 0 on a row that sees no key."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    s = _flash_scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)                       # (B,Hkv,G,Sq)
    seen = torch.isfinite(lse)
    p = torch.exp(s - torch.where(seen, lse, 0.0)[..., None])
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = out.reshape(B, Sq, Hq, D).to(q.dtype)
    return out, torch.where(seen, lse, NEG_INF).reshape(B, Hq, Sq)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, causal: bool = True):
    """The flash backward's function, the formulas of the reference's
    hand-written VJP (``flash_xla._bwd_rule``): p = exp(s - lse),
    delta = rowsum(dO * O), dS = p (dP - delta) scale; dq = dS k,
    dk = dS^T q and dv = p^T dO summed over each kv head's G query
    heads. All in f32; returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / float(D) ** 0.5
    s = _flash_scores(q, k, causal)
    lse_g = lse.reshape(B, Hkv, G, Sq)
    p = torch.where(s == -torch.inf, 0.0, torch.exp(s - lse_g[..., None]))
    dog = dout.reshape(B, Sq, Hkv, G, D).float()
    delta = (dog * out.reshape(B, Sq, Hkv, G, D).float()).sum(-1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float())
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ----------------------------------------------------------------------
# Paged KV cache: page-table scatter (store) and gather (load) between
# the logical per-slot view and the flat page pool (serve/kv_cache.py).
# ----------------------------------------------------------------------
def _targets(pool: torch.Tensor, pt: torch.Tensor, idx: torch.Tensor,
             S: int):
    """Per window row (b, s): logical position idx[b]+s, its page (-1 =
    unmapped or past the table) and its flat pool row."""
    ps = pool.shape[1]
    M = pt.shape[1]
    pos = (idx.long()[:, None]
           + torch.arange(S, device=pool.device)[None, :])     # (B,S)
    page_i = torch.div(pos, ps, rounding_mode="floor")
    inside = (page_i >= 0) & (page_i < M)
    page = torch.where(
        inside, torch.gather(pt.long(), 1, page_i.clamp(0, M - 1)), -1)
    flat = page * ps + torch.remainder(pos, ps)
    return pos, page, flat


def _budget(pos: torch.Tensor, length: Optional[torch.Tensor]):
    """(B, S) mask of the window rows within each slot's row budget
    (all rows when ``length`` is None)."""
    if length is None:
        return torch.ones_like(pos, dtype=torch.bool)
    S = pos.shape[1]
    return (torch.arange(S, device=pos.device)[None, :]
            < torch.as_tensor(length, device=pos.device).long()[:, None])


def paged_update(pool_k: torch.Tensor, pool_v: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 pt: torch.Tensor, idx: torch.Tensor,
                 length: Optional[torch.Tensor] = None):
    """Scatter new K/V rows into the paged pool through the page table,
    in place; returns ``(pool_k, pool_v)``.

    pool: (P, page, Hkv, D); k_new/v_new: (B, S, Hkv, D); pt: (B, M)
    (-1 = unmapped); idx: (B,). Row (b, s) lands at logical position
    idx[b]+s -> page pt[b, pos//page]. Stores at negative positions
    (idle sentinel) or on unmapped pages are dropped, and so are rows
    s >= length[b] when the (B,) row budget ``length`` is given (the
    speculative rollback commits only a verify window's accepted
    prefix this way).
    """
    P, ps = pool_k.shape[:2]
    pos, page, flat = _targets(pool_k, pt, idx, k_new.shape[1])
    land = (page >= 0) & (pos >= 0) & _budget(pos, length)
    rows = flat[land]
    for pool, new in ((pool_k, k_new), (pool_v, v_new)):
        pool.view((P * ps,) + pool.shape[2:])[rows] = \
            new[land].to(pool.dtype)
    return pool_k, pool_v


def paged_store_counts(pool_k: torch.Tensor, pool_v: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       pt: torch.Tensor, idx: torch.Tensor,
                       length: Optional[torch.Tensor] = None,
                       tol: float = 0.0) -> torch.Tensor:
    """Waste counters of a ``paged_update`` store, per slot: (B, 3) int32
    ``[stored, silent, dropped]`` element counts over K and V, measured
    against the pool content before the store (after the new rows'
    round trip through the pool dtype). Idle slots, and rows past the
    row budget ``length``, attempt no store and count nothing."""
    P, ps = pool_k.shape[:2]
    B, S, Hkv, D = k_new.shape
    pos, page, flat = _targets(pool_k, pt, idx, S)
    attempted = (pos >= 0) & _budget(pos, length)
    landing = attempted & (page >= 0)
    flat = torch.where(landing, flat, 0)

    def row_silent(pool, new):
        old = pool.reshape((P * ps,) + pool.shape[2:])[flat]   # (B,S,Hkv,D)
        newf = new.to(pool.dtype).float()
        return silent_mask(old.float(), newf, tol).sum(dim=(2, 3))

    sil = torch.where(landing, row_silent(pool_k, k_new)
                      + row_silent(pool_v, v_new), 0)
    row = 2 * Hkv * D
    stored = torch.where(landing, row, 0).sum(dim=1)
    silent = sil.sum(dim=1)
    dropped = torch.where(attempted & (page < 0), row, 0).sum(dim=1)
    return torch.stack([stored, silent, dropped], dim=1).to(torch.int32)


def paged_gather(pool: torch.Tensor, pt: torch.Tensor):
    """Logical per-slot view of a paged pool: (B, M*page, ...) plus the
    (B, M*page) validity mask (False where the page table is unmapped)."""
    P, ps = pool.shape[:2]
    B, M = pt.shape
    g = pool[pt.long().clamp(0, P - 1)]                    # (B,M,page,...)
    g = g.reshape((B, M * ps) + pool.shape[2:])
    valid = (pt >= 0).repeat_interleave(ps, dim=1)
    return g, valid


def paged_decode_ref(q, k_new, v_new, pool_k, pool_v, pt, idx,
                     tol: float = 0.0):
    """The paged decode kernel's function: store-site counters, the
    store of the new row (in place), then attention over the gathered
    view. Returns ``(out, lse, pool_k, pool_v, counters)``; lse is
    (B, Hq) f32."""
    dt = q.dtype
    cnt = paged_store_counts(pool_k, pool_v, k_new, v_new, pt, idx, tol=tol)
    paged_update(pool_k, pool_v, k_new, v_new, pt, idx)
    gk, valid = paged_gather(pool_k, pt)
    gv, _ = paged_gather(pool_v, pt)
    out, lse = attention_lse(q, gk.to(dt), gv.to(dt), causal=True,
                             q_offset=idx, kv_len=idx + 1, kv_valid=valid)
    return out, lse[..., 0], pool_k, pool_v, cnt


# a rank's localized page table of a page-chunked pool (serve/
# flash_decode.py): another rank's page, and a page unmapped in the whole
# pool whose window rows this rank takes (csrc/common.cuh's WIN_NOT_MINE
# and WIN_UNMAPPED_MINE)
NOT_MINE, UNMAPPED_MINE = -1, -2


def paged_window_ref(q, k_win, v_win, pool_k, pool_v, pt, idx, *,
                     store: bool = True, tol: float = 0.0,
                     chunk: bool = False):
    """The paged window kernel's function (prefill / verify).

    ``store=True``: all S window rows are stored through the page table
    (in place), then attention runs over the gathered view.
    ``store=False``: the window is spliced into the gathered view, the
    pool is untouched and the counters are zero. With ``chunk`` (defer
    on a rank's localized table of a page-chunked pool) a window row is
    spliced only where its page's entry is not ``NOT_MINE``: on a page
    the rank owns, or on an ``UNMAPPED_MINE`` page; history pages count
    where the entry is >= 0, as always. Returns
    ``(out, lse, pool_k, pool_v, counters)``; lse is (B, Hq, S) f32.
    """
    dt = q.dtype
    B, S = q.shape[:2]
    if store:
        cnt = paged_store_counts(pool_k, pool_v, k_win, v_win, pt, idx,
                                 tol=tol)
        paged_update(pool_k, pool_v, k_win, v_win, pt, idx)
        gk, valid = paged_gather(pool_k, pt)
        gv, _ = paged_gather(pool_v, pt)
    else:
        cnt = torch.zeros((B, 3), dtype=torch.int32, device=q.device)
        gk, valid = paged_gather(pool_k, pt)
        gv, _ = paged_gather(pool_v, pt)
        ext = gk.shape[1]
        pos = idx.long()[:, None] + torch.arange(S, device=q.device)[None]
        keep = (pos >= 0) & (pos < ext)
        if chunk:
            ps, M = pool_k.shape[1], pt.shape[1]
            page_i = torch.div(pos, ps, rounding_mode="floor")
            entry = pt.long().gather(1, page_i.clamp(0, M - 1))
            keep = keep & (entry != NOT_MINE)
        bidx = torch.arange(B, device=q.device)[:, None].expand(B, S)
        gk[bidx[keep], pos[keep]] = k_win[keep].to(gk.dtype)
        gv[bidx[keep], pos[keep]] = v_win[keep].to(gv.dtype)
        valid[bidx[keep], pos[keep]] = True
    out, lse = attention_lse(q, gk.to(dt), gv.to(dt), causal=True,
                             q_offset=idx, kv_len=idx + S, kv_valid=valid)
    return out, lse, pool_k, pool_v, cnt


# ----------------------------------------------------------------------
# Silent-compare: count of "silent" (unchanged) elements between two
# buffers (paper Defs. 2-3; tol=0 => exact).
# ----------------------------------------------------------------------
def silent_compare_ref(a: torch.Tensor, b: torch.Tensor,
                       tol: float = 0.01) -> torch.Tensor:
    """Count elements where b is a 'silent' overwrite of a (int32)."""
    a = a.float().reshape(-1)
    b = b.float().reshape(-1)
    return silent_mask(a, b, tol).sum().to(torch.int32)


# ----------------------------------------------------------------------
# RMSNorm
# ----------------------------------------------------------------------
def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Row RMSNorm over the last dimension: f32 mean of squares,
    ``rsqrt(var + eps)``, times the f32 scale, cast back to x's dtype
    (the Pallas ``_rmsnorm_kernel``)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5):
    """Gradients ``(dx, dscale)`` of ``rmsnorm_ref`` against ``dy``, in
    f32: with r = rsqrt(mean(x^2) + eps), xhat = x r and g = dy s,
    dx = r (g - xhat mean(g xhat)) per row and dscale = sum over rows of
    dy xhat. dx comes back in x's dtype, dscale in scale's."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    dyf = dy.float()
    g = dyf * scale.float()
    dx = r * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dscale = (dyf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def rmsnorm_bwd_blocked(x: torch.Tensor, scale: torch.Tensor,
                        rstd: torch.Tensor, dy: torch.Tensor, *,
                        blocks: int, workers: int, group: int):
    """``rmsnorm_bwd_ref`` cut as the CUDA kernel (``csrc/rmsnorm.cu``)
    cuts it, from the forward's f32 ``rstd`` (n,): the n rows split into
    ``blocks * workers`` contiguous balanced ranges, each worker summing
    its rows' dy xhat in row order; a block's partial is its workers'
    summed in worker order; groups of ``group`` blocks summed in block
    order, then the group sums in group order. Every product is rounded
    before it is added, as the kernel's are, so dscale is the kernel's
    bit for bit on the same plan. dx (the kernel sums each row in
    another order) comes back in x's dtype, dscale in scale's."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    dyf = dy.reshape(-1, d).float()
    n = xf.shape[0]
    r = rstd.reshape(n, 1)
    xhat = xf * r
    g = dyf * scale.float()
    dx = r * (g - xhat * ((g * xhat).sum(dim=-1, keepdim=True) / d))
    contrib = dyf * xhat
    nw = blocks * workers
    bounds = torch.arange(nw + 1, device=x.device) * n // nw
    start, count = bounds[:-1], bounds[1:] - bounds[:-1]
    acc = torch.zeros((nw, d), dtype=torch.float32, device=x.device)
    for k in range(int(count.max()) if n else 0):
        live = count > k
        acc[live] = acc[live] + contrib[start[live] + k]
    acc = acc.view(blocks, workers, d)
    part = torch.zeros((blocks, d), dtype=torch.float32, device=x.device)
    for w in range(workers):
        part = part + acc[:, w]
    total = torch.zeros(d, dtype=torch.float32, device=x.device)
    for g0 in range(0, blocks, group):
        gsum = torch.zeros(d, dtype=torch.float32, device=x.device)
        for j in range(g0, min(blocks, g0 + group)):
            gsum = gsum + part[j]
        total = total + gsum
    return dx.to(x.dtype).reshape(x.shape), total.to(scale.dtype)
