"""Flash-decoding over a KV cache chunked across ranks.

Port of src/repro/serve/flash_decode.py. Each reference ``shard_map``
body is a rank-local function here: it takes this rank's chunk of the
cache (a dense cache's sequence chunk, a paged pool's page chunk) and
combines its partial attention with the other ranks' through explicit
collectives (sharding/comm.py). The plan:

  * the cache stays chunked over ``seq_axes``; a new K/V row is written
    by the one rank that owns its position (its page, for a pool);
  * every rank attends its chunk with a running max and denominator;
  * the partials combine by log-sum-exp: out = sum_i e^{m_i - M} o_i /
    sum_i e^{m_i - M} l_i over the ranks, M their largest max. The
    reference reduces with pmax and psum; here the partials are
    all-gathered in one collective and summed in rank order, so every
    rank gets the same bits.

The paged functions read a rank's chunk through its localized page
table ``where(owned, pt - off, -1)``. On CUDA tensors they run the
port's kernels on it — B1 (``ops.paged_decode_lse``) for a decode, B2
(``ops.paged_window_lse``, store mode) for a window — and combine by
each kernel's lse, as the reference's Pallas branches do: a kernel
stores and attends only rows on pages this rank owns (a page unmapped
in the localized table is dropped and masked), so every row is stored
and counted by exactly one rank. On CPU tensors they run the
reference's plain bodies. Under an abstract trace (fake tensors) they
take the kernels' route whatever the device, where ``ops`` makes each
kernel one node, so a traced tick holds the card's program.
The dense and cross functions are plain PyTorch on every device, as
their reference bodies are einsums.

Store counters: a rank's kernel counts [stored, silent, dropped] over
its chunk; ``global_counts`` sums the stored and silent counts over the
ranks and takes the dropped count from the replicated page table (a
rank's own "dropped" also counts rows another rank owns).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import ops, ref
from repro_torch.kernels import traced as _traced
from repro_torch.sharding import comm

_MASK = -1e30


def _kernel_route(q: torch.Tensor) -> bool:
    """Whether a paged function runs a kernel on its chunk (through
    ``kernels/ops.py``): on CUDA tensors, and under an abstract trace
    (fake tensors, whatever their device), where the kernel is one node
    and the trace is the card's program."""
    return q.device.type == "cuda" or isinstance(q, FakeTensor)


def _store_rows(dst: torch.Tensor, index, keep: torch.Tensor,
                src: torch.Tensor) -> None:
    """``dst[index[keep]] = src[keep]`` in place (``index`` a tuple of
    integer tensors of keep's shape); under an abstract trace its widest
    store (``kernels/traced.py:widest_store``)."""
    if isinstance(dst, FakeTensor):
        _traced.widest_store(dst, index, src)
        return
    dst[tuple(i[keep] for i in index)] = src[keep].to(dst.dtype)


def _gather_parts(parts: Sequence[torch.Tensor], seq_axes, mesh
                  ) -> List[List[torch.Tensor]]:
    """Every rank's ``parts`` (float32, same shapes on every rank) over
    ``seq_axes``, in rank order: one all-gather of them packed flat."""
    flat = torch.cat([p.float().reshape(-1) for p in parts])
    n = mesh.axis_size(seq_axes)
    allp = comm.all_gather(flat, seq_axes, mesh, dim=0).view(n, -1)
    out = []
    for r in range(n):
        row, at = [], 0
        for p in parts:
            row.append(allp[r, at:at + p.numel()].view(p.shape))
            at += p.numel()
        out.append(row)
    return out


def _combine_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                      seq_axes, mesh) -> torch.Tensor:
    """The flash-decoding reduction of unnormalized partials: m, l (...)
    running max and denominator, o (..., D) numerator; returns the
    normalized (..., D) float32 output, NaN in a row that no rank
    attended (as the plain unsharded attention's softmax gives)."""
    ranks = _gather_parts((m, l, o), seq_axes, mesh)
    gm = ranks[0][0]
    for mr, _, _ in ranks[1:]:
        gm = torch.maximum(gm, mr)
    den = torch.zeros_like(l, dtype=torch.float32)
    num = torch.zeros_like(o, dtype=torch.float32)
    for mr, lr, orr in ranks:
        corr = torch.exp(mr - gm)
        den = den + lr * corr
        num = num + orr * corr[..., None]
    return torch.where((den > 0)[..., None], num / den.clamp(min=1e-30)[
        ..., None], torch.nan)


def _lse_combine(o_l: torch.Tensor, lse: torch.Tensor, seq_axes, mesh,
                 out_dtype, plain: bool = False) -> torch.Tensor:
    """Cross-rank combine of per-rank normalized outputs and their
    log-sum-exp: out = sum_i e^{lse_i - max} o_i / sum_i e^{lse_i - max}.
    Idle slots (every lse NEG_INF, every o 0) come back zero, no NaNs, as
    the kernels give them; ``plain`` (the plain versions' partials, NaN
    where a rank attended nothing) zeroes a rank's empty rows and gives
    NaN where no rank attended, as the plain unsharded call does.
    o_l: (..., D) with lse broadcastable to o_l.shape[:-1]."""
    lse = lse.float().expand(o_l.shape[:-1])
    empty = lse <= ref.NEG_INF
    if plain:
        o_l = o_l.masked_fill(empty[..., None], 0)
    ranks = _gather_parts((lse, o_l), seq_axes, mesh)
    gm = ranks[0][0]
    for lr, _ in ranks[1:]:
        gm = torch.maximum(gm, lr)
    den = torch.zeros_like(lse)
    num = torch.zeros(o_l.shape, dtype=torch.float32, device=o_l.device)
    for lr, orr in ranks:
        w = torch.exp(lr - gm)
        den = den + w
        num = num + orr * w[..., None]
    out = num / torch.clamp(den, min=1e-30)[..., None]
    if plain:
        for lr, _ in ranks:
            empty = empty & (lr <= ref.NEG_INF)
        out = out.masked_fill(empty[..., None], torch.nan)
    return out.to(out_dtype)


# ----------------------------------------------------------------------
# Dense per-slot cache
# ----------------------------------------------------------------------
def store_dense_rows(ck, cv, k_new, v_new, idx, *, off: int, total: int,
                     spec: Optional[str] = None,
                     rows: Optional[torch.Tensor] = None) -> None:
    """Store S new K/V rows (B,S,Hkv,D) into a dense cache's positions
    [off, off + chunk) (ck/cv (B,chunk,Hkv,D), in place; ``total`` the
    whole cache's extent) where the unsharded cache puts them: the
    window's start clamped into the cache, or, for a verify window
    ``spec``, rows past the extent dropped. ``rows`` ((B,) bool) limits
    the store to those slots."""
    B, S = k_new.shape[:2]
    chunk = ck.shape[1]
    dev = ck.device
    idx_b = torch.as_tensor(idx, device=dev).long().expand(B)
    ar = torch.arange(S, device=dev)
    if spec is not None:
        pos = idx_b[:, None] + ar[None, :]
        keep = (pos >= 0) & (pos < total)
    else:
        pos = idx_b.clamp(0, total - S)[:, None] + ar[None, :]
        keep = torch.ones_like(pos, dtype=torch.bool)
    if rows is not None:
        keep = keep & rows[:, None]
    lpos = pos - off
    mine = keep & (lpos >= 0) & (lpos < chunk)
    bidx = torch.arange(B, device=dev)[:, None].expand(B, S)
    _store_rows(ck, (bidx, lpos), mine, k_new)
    _store_rows(cv, (bidx, lpos), mine, v_new)


def decode_attention_sharded(q, k_new, v_new, ck, cv, idx, *, mesh,
                             batch_axes: Tuple[str, ...],
                             seq_axes: Tuple[str, ...],
                             spec: Optional[str] = None):
    """q: (B,S,Hq,D); k_new/v_new: (B,S,Hkv,D); ck/cv: (B,chunk,Hkv,D)
    this rank's sequence chunk, written IN PLACE; idx: scalar or (B,)
    write positions (the number of valid tokens so far). The reference's
    function is the decode (S 1, scalar idx); here the S new rows land
    where the unsharded cache puts them (``layers.apply_attention``: the
    window's start clamped into the cache, or, for a verify window
    ``spec``, rows past the extent dropped), on the rank that owns each
    row, and row r attends positions <= idx + r. Returns (out (B,S,Hq,D),
    ck, cv)."""
    B, S, Hq, D = q.shape
    chunk, Hkv = ck.shape[1], ck.shape[2]
    G = Hq // Hkv
    off = mesh.index(seq_axes) * chunk
    total = chunk * mesh.axis_size(seq_axes)
    dev = q.device
    idx_b = torch.as_tensor(idx, device=dev).long().expand(B)
    ar = torch.arange(S, device=dev)
    store_dense_rows(ck, cv, k_new, v_new, idx_b, off=off, total=total,
                     spec=spec)

    # local partial attention over my chunk (row r sees pos <= idx + r)
    qg = q.reshape(B, S, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.to(q.dtype).float())
    s = s * (1.0 / math.sqrt(D))
    kpos = off + torch.arange(chunk, device=dev)
    qpos = idx_b[:, None] + ar[None, :]                      # (B,S)
    valid = kpos[None, None, :] <= qpos[:, :, None]          # (B,S,chunk)
    s = torch.where(valid[:, None, None], s, _MASK)
    m = s.amax(dim=-1)                                       # (B,Hkv,G,S)
    p = torch.where(valid[:, None, None], torch.exp(s - m[..., None]), 0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, cv.to(q.dtype).float())
    out = _combine_partials(m, l, o, seq_axes, mesh)         # (B,h,g,S,D)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)
    return out, ck, cv


# ----------------------------------------------------------------------
# Paged pool
# ----------------------------------------------------------------------
def _localize(pt: torch.Tensor, off: int, chunk: int):
    """(localized table, owned mask): pages this rank owns, renumbered
    into its chunk, and -1 everywhere else."""
    lpt = pt - off
    owned = (pt >= 0) & (lpt >= 0) & (lpt < chunk)
    return torch.where(owned, lpt, -1).to(pt.dtype), owned


def _paged_plain(q, k_new, v_new, ck, cv, loc, owned, idx, seq_axes, mesh,
                 tol):
    """The reference's plain shard body (decode and verify): store the
    rows this rank owns (in place), gather its owned pages into the
    slot's logical view, attend per query (position idx+i sees owned
    positions <= idx+i) and combine. Returns (out, counters)."""
    B, S, Hq, D = q.shape
    chunk, ps, Hkv = ck.shape[0], ck.shape[1], ck.shape[2]
    G = Hq // Hkv
    M = loc.shape[1]
    dev = q.device
    cnt = ref.paged_store_counts(ck, cv, k_new, v_new, loc, idx, tol=tol)
    ref.paged_update(ck, cv, k_new, v_new, loc, idx)
    lp = loc.long().clamp(0, chunk - 1)
    kg = ck[lp].reshape(B, M * ps, Hkv, D)
    vg = cv[lp].reshape(B, M * ps, Hkv, D)
    pos = idx.long()[:, None] + torch.arange(S, device=dev)[None, :]
    kpos = torch.arange(M * ps, device=dev)
    valid = (owned.repeat_interleave(ps, dim=1)[:, None, :]
             & (kpos[None, None, :] <= pos[:, :, None]))     # (B,S,Skv)
    qg = q.reshape(B, S, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kg.to(q.dtype).float())
    s = s * (1.0 / math.sqrt(D))
    s = torch.where(valid[:, None, None], s, _MASK)
    m = s.amax(dim=-1)
    # a masked key weighs 0 (a row with no valid key: l 0, no rank's)
    p = torch.where(valid[:, None, None], torch.exp(s - m[..., None]), 0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, vg.to(q.dtype).float())
    out = _combine_partials(m, l, o, seq_axes, mesh)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)
    return out, cnt


def decode_paged_attention_sharded(q, k_new, v_new, ck, cv, pt, idx, *,
                                   mesh, batch_axes: Tuple[str, ...],
                                   seq_axes: Tuple[str, ...],
                                   tol: float = 0.0):
    """Flash-decoding over a block-paged KV pool chunked by pages.

    q: (B,1,Hq,D); k_new/v_new: (B,1,Hkv,D); ck/cv: (chunk,page,Hkv,D)
    this rank's pages of the pool (global pages [off, off+chunk)), written
    IN PLACE; pt: (B,M) the slots' global page table (-1 = unmapped);
    idx: (B,) write positions (negative = idle, store dropped). The rank
    owning the new row's page stores it; every rank attends its owned
    pages (B1 on the localized table, on CUDA) and the partials combine.
    Returns (out (B,1,Hq,D), ck, cv, counters): counters (B,3) int32 of
    this rank's store, as ``global_counts`` takes them."""
    chunk = ck.shape[0]
    loc, owned = _localize(pt, mesh.index(seq_axes) * chunk, chunk)
    if _kernel_route(q):
        o_l, lse, cnt = ops.paged_decode_lse(q, k_new, v_new, ck, cv, loc,
                                             idx, tol=tol)
        out = _lse_combine(o_l, lse[:, None, :], seq_axes, mesh, q.dtype)
        return out, ck, cv, cnt
    out, cnt = _paged_plain(q, k_new, v_new, ck, cv, loc, owned, idx,
                            seq_axes, mesh, tol)
    return out, ck, cv, cnt


def verify_paged_attention_sharded(q, k_new, v_new, ck, cv, pt, idx, *,
                                   mesh, batch_axes: Tuple[str, ...],
                                   seq_axes: Tuple[str, ...],
                                   tol: float = 0.0):
    """Width-W window over a block-paged KV pool chunked by pages: the
    admission prefill and the overwrite verify (store mode).

    q: (B,W,Hq,D) at positions idx[b]..idx[b]+W-1; k_new/v_new:
    (B,W,Hkv,D); ck/cv, pt, idx as in ``decode_paged_attention_sharded``.
    Each rank stores the window rows whose pages it owns (B2's store
    epilogue on the localized table, on CUDA: store-mode window validity
    is "target page mapped", which under that table means owned, so
    every row is attended and stored by exactly one rank), attends its
    owned history with the in-window causal chain, and the per-query
    partials combine. Returns (out (B,W,Hq,D), ck, cv, counters)."""
    chunk = ck.shape[0]
    loc, owned = _localize(pt, mesh.index(seq_axes) * chunk, chunk)
    if _kernel_route(q):
        o_l, lse, cnt = ops.paged_window_lse(q, k_new, v_new, ck, cv, loc,
                                             idx, store=True, tol=tol)
        # lse: (B, Hq, W) -> (B, W, Hq) to match o_l
        out = _lse_combine(o_l, lse.transpose(1, 2), seq_axes, mesh,
                           q.dtype)
        return out, ck, cv, cnt
    out, cnt = _paged_plain(q, k_new, v_new, ck, cv, loc, owned, idx,
                            seq_axes, mesh, tol)
    return out, ck, cv, cnt


def defer_paged_attention_sharded(q, k_new, v_new, ck, cv, pt, idx, *,
                                  mesh, batch_axes: Tuple[str, ...],
                                  seq_axes: Tuple[str, ...]):
    """Width-W window over a block-paged KV pool chunked by pages, the
    pool left as it is: the rollback (defer) verify, whose accepted rows
    ``LM.commit_verify`` stores afterwards.

    The reference splices every window row at a position in [0, M*page)
    into the history, its page mapped or not (``ref.paged_window_ref``).
    On a chunk each row must count on exactly one rank, or the combine
    would weigh it once a rank: a row is taken by the rank that owns its
    page, and a row on a page unmapped in the whole table by seq-rank 0
    (``ref.UNMAPPED_MINE`` in that rank's localized table). The engine
    keeps every draft on a mapped page (``ServeEngine._draft_cap``), so
    only the padding rows past a slot's drafts reach unmapped pages; they
    still count, because an MoE layer routes them with the others. On
    CUDA B2 runs in its defer-on-a-chunk mode on the localized table,
    the partials combined by its lse; on the CPU, its plain version.
    q, k_new/v_new, ck/cv, pt, idx as in ``verify_paged_attention_
    sharded``; returns out (B,W,Hq,D)."""
    chunk = ck.shape[0]
    me = mesh.index(seq_axes)
    loc, _ = _localize(pt, me * chunk, chunk)
    if me == 0:
        loc = torch.where(pt < 0, ref.UNMAPPED_MINE, loc).to(pt.dtype)
    if _kernel_route(q):
        o_l, lse, _ = ops.paged_window_lse(q, k_new, v_new, ck, cv, loc,
                                           idx, store=False, chunk=True)
        return _lse_combine(o_l, lse.transpose(1, 2), seq_axes, mesh,
                            q.dtype)
    o_l, lse, _, _, _ = ref.paged_window_ref(
        q, k_new, v_new, ck, cv, loc, idx, store=False, chunk=True)
    return _lse_combine(o_l, lse.transpose(1, 2), seq_axes, mesh, q.dtype,
                        plain=True)


def global_counts(cnt: torch.Tensor, pt: torch.Tensor, idx: torch.Tensor,
                  S: int, ps: int, row_elems: int, seq_axes, mesh,
                  length: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole pool's [stored, silent, dropped] counters of a chunked
    store from the ranks' own: cnt (..., B, 3) int32 of this rank (any
    leading dims, e.g. the layers); stored and silent summed over the
    ranks, dropped recounted from the replicated table: every attempted
    row (position >= 0, and below its slot's ``length`` (B,) when the
    store had a row budget) whose page is unmapped or past the table,
    times ``row_elems`` (2 * Hkv * D). pt (B, M), idx (B,) as the store
    got them."""
    B, Mp = pt.shape
    summed = comm.all_reduce(cnt[..., :2].contiguous(), seq_axes, mesh)
    ar = torch.arange(S, device=pt.device)[None, :]
    pos = idx.long()[:, None] + ar
    pi = torch.div(pos, ps, rounding_mode="floor")
    inside = (pi >= 0) & (pi < Mp)
    page = torch.where(inside, pt.long().gather(1, pi.clamp(0, Mp - 1)), -1)
    tried = pos >= 0
    if length is not None:
        tried = tried & (ar < length.long()[:, None])
    dropped = (tried & (page < 0)).sum(dim=1) * row_elems         # (B,)
    dropped = dropped.to(cnt.dtype).expand(cnt.shape[:-1])
    return torch.cat([summed, dropped[..., None]], dim=-1)


def cross_attention_sharded(q, ck, cv, *, mesh, batch_axes, seq_axes):
    """Read-only sharded cross-attention over precomputed K/V (an encoder
    output, image tokens): ck/cv (B,chunk,Hkv,D) this rank's chunk of the
    keys. Same combine, no update. Returns (B,Sq,Hq,D)."""
    B, Sq, Hq, D = q.shape
    Hkv = ck.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.to(q.dtype).float())
    s = s * (1.0 / math.sqrt(D))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, cv.to(q.dtype).float())
    out = _combine_partials(m, l, o, seq_axes, mesh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


# ----------------------------------------------------------------------
# Plans
# ----------------------------------------------------------------------
def paged_shard_plan(sharder, batch: int, num_pages: int, page_size: int):
    """Shard plan for a paged pool of ``num_pages`` pages in all: pages
    chunk over 'model' (the dense plan's sequence role); batch over dp
    when divisible. None = the pool is whole on every rank."""
    if sharder is None or "model" not in sharder.mesh.shape:
        return None
    mesh = sharder.mesh
    if num_pages * page_size < 1024 or num_pages % mesh.shape["model"]:
        return None
    dp = ("pod", "data") if "pod" in mesh.shape else ("data",)
    dpn = int(math.prod(mesh.shape[a] for a in dp))
    return (dp if batch % dpn == 0 else ()), ("model",)


def decode_shard_plan(sharder, batch: int, seq: int):
    """Mirror of TpServe.cache_specs: (batch_axes, seq_axes) or None."""
    if sharder is None or "model" not in sharder.mesh.shape:
        return None
    mesh = sharder.mesh
    dp = ("pod", "data") if "pod" in mesh.shape else ("data",)
    dpn = int(math.prod(mesh.shape[a] for a in dp))
    if batch % dpn == 0:
        if seq >= 1024 and seq % mesh.shape["model"] == 0:
            return dp, ("model",)
        return None
    full = dp + ("model",)
    n = int(math.prod(mesh.shape[a] for a in full))
    if seq >= 1024 and seq % n == 0:
        return (), full
    if seq >= 1024 and seq % mesh.shape["model"] == 0:
        return (), ("model",)
    return None
