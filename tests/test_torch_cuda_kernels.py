"""The PyTorch port's hand-written CUDA kernels against their plain
versions, on the card (marked ``cuda``; they skip without a GPU and
nvcc). Run them on a machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Paged kernels: small hostile shapes (the reference's hostile page
table: out-of-order pages, partial last pages, unmapped tails, an idle
slot), at G = Hq/Hkv = 2 and at granite-moe-3b-a800m's G = 3 with
head_dim 64 (a kv group's 3 decode rows in the split kernel's 4-row
block, 21 window rows = 63 of the tensor-core route's 64 stacked rows,
the 64th slack), every activation/pool dtype pair: pools after the store and
counters equal bit for bit; outputs and lse within 1e-5 (float32: the
kernel sums in another order) or 2e-2 (bfloat16: one rounding of the
output) on rows that attend something; rows that attend nothing come
back 0 / NEG_INF.

Flash attention (float32: the CUDA-core kernels; bfloat16: the
tensor-core kernels, also on a fused projection's strided views and on
misaligned views, which take the wrapper's counted copy, and twice for
bit-identical gradients): ragged and unequal Sq/Skv around the 128-row
and 64-key tiles, one query row, GQA G = 1 and 2, causal and not, every
head_dim the kernel takes; the forward's few-row route (G * Sq <= 16)
over 1, 2, 4 and 16 key splits, two calls bit-identical:
out and lse within 1e-4 (float32) or 2e-2 (bfloat16); dq, dk, dv within
2e-4 (float32) or 3e-2 (bfloat16) of the plain gradient's largest
magnitude, and within 1e-5 where every gradient is zero in exact
arithmetic (dq and dk of a single key). Silent compare: counts equal
exactly, on ragged sizes with NaN, +-0, infinities and subnormals.

RMSNorm (CUDA forward and backward): widths 64, 128, 1000, 1536, 2048,
4096, 4104, 8184 and 8192 and every route of both (narrow 64 and 128;
wide 1000 to 8192; general 999, 8200, 10000 and misaligned strided
rows), ragged row
counts, rows read by stride, the main paths' x/scale dtype pairs and
float16: out within 1e-5 relative (float32) or 2e-2 (16-bit, one
rounding of the output), rstd within 1e-5 relative (another summation
order over up to 4096 squares); dx and dscale from the kernel's rstd
within 2e-4 (float32) or 3e-2 (16-bit) of the plain gradient's largest
magnitude; one launch a call each way, two calls bit-identical each way,
and dscale equal bit for bit to the blocked plain version on the
kernel's own plan. The forward gives the same bits at every rows-a-block
its route takes (a row's sum does not depend on the grid). Speculative verify
(window kernel at W = 5 through the verify wrapper): both modes on a
hostile table at head_dim 128, as the window kernel above; defer mode
leaves the pools alone and gives store mode's outputs bit for bit on
slots whose window is mapped. Object tier: the replica digest of a CUDA
tensor (chunks gathered on the card) equals its CPU copy's, float32,
bfloat16 and int32, whole and sampled; the engine's kv_page reader gives
the host copy's bytes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_backward, flash_attention_forward)
from repro_torch.kernels.flash_prefill import (paged_window_attention,
                                               paged_window_on_route)
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.paged_verify import paged_verify_attention
from repro_torch.kernels.rmsnorm import (RMSNorm, fwd_plan_for, plan_for,
                                        rmsnorm_backward, rmsnorm_forward)
from repro_torch.kernels.silent_compare import silent_compare

pytestmark = pytest.mark.cuda

HOSTILE_PT = np.array([[5, 1, 6, -1],
                       [2, 7, -1, -1],
                       [-1, -1, -1, -1]], np.int32)
B, P, PS = 3, 8, 4
HQ, HKV = 4, 2
PAIRS = [("float32", "float32"), ("float32", "bfloat16"),
         ("bfloat16", "float32"), ("bfloat16", "bfloat16")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        build.nvcc()
    except RuntimeError:
        pytest.skip("no nvcc to build the kernels")
    return torch.device("cuda")


def _inputs(dev, S, D, act, pool, seed, b=B, pages=P, ps=PS, hq=HQ,
            hkv=HKV):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(
            getattr(torch, dtype))
    return (randn(b, S, hq, D, dtype=act), randn(b, S, hkv, D, dtype=act),
            randn(b, S, hkv, D, dtype=act),
            randn(pages, ps, hkv, D, dtype=pool),
            randn(pages, ps, hkv, D, dtype=pool))


def _g3(*cases):
    """pytest params (value..., hq, hkv): each case at G 2 (hq 4, hkv 2)
    under its old id (its first value), then the granite shapes at G 3
    (id: the values and G3)."""
    out = [pytest.param(*c, HQ, HKV, id=str(c[0]))
           for c in cases if c[-1] != "G3"]
    out += [pytest.param(*c[:-1], 6, 2, id="-".join(map(str, c)))
            for c in cases if c[-1] == "G3"]
    return out


def _compare(got, want, pools_got, pools_want, act):
    (o_k, l_k, c_k), (o_p, l_p, c_p) = got, want
    assert torch.equal(pools_got[0], pools_want[0])
    assert torch.equal(pools_got[1], pools_want[1])
    assert torch.equal(c_k, c_p)
    b, S, hq = o_k.shape[:3]
    lse_k, lse_p = l_k.reshape(b, hq, S), l_p.reshape(b, hq, S)
    live = lse_p > ref.NEG_INF / 2
    live_o = live.permute(0, 2, 1)[..., None]
    tol = 1e-5 if act == "float32" else 2e-2
    zero = torch.zeros((), device=o_k.device)
    assert float(torch.where(live_o, (o_k.float() - o_p.float()).abs(),
                             zero).max()) <= tol
    assert float(torch.where(live, (lse_k - lse_p).abs(), zero).max()) <= tol
    assert float(torch.where(live_o, zero, o_k.float().abs()).max()) == 0
    assert bool((lse_k[~live] == ref.NEG_INF).all())


@pytest.mark.parametrize("act,pool", PAIRS)
@pytest.mark.parametrize("D,hq,hkv", _g3((8,), (128,), (64, "G3")))
def test_decode_kernel_matches_plain(cuda, act, pool, D, hq, hkv):
    q, k, v, pk, pv = _inputs(cuda, 1, D, act, pool, seed=D, hq=hq,
                              hkv=hkv)
    pt = torch.as_tensor(HOSTILE_PT, device=cuda)
    idx = torch.tensor([9, 5, -1], dtype=torch.int32, device=cuda)
    kk, kv, pk2, pv2 = pk.clone(), pv.clone(), pk.clone(), pv.clone()
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, k, v, kk, kv, pt, idx)
    out, lse, _, _, cnt = ref.paged_decode_ref(q, k, v, pk2, pv2, pt, idx)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    _compare(got, (out, lse, cnt), (kk, kv), (pk2, pv2), act)


@pytest.mark.parametrize("act,pool", PAIRS)
@pytest.mark.parametrize("S,D,hq,hkv", _g3(
    (1, 16), (5, 16), (20, 16), (1, 64, "G3"), (5, 64, "G3"),
    (21, 64, "G3"), (22, 64, "G3")))
@pytest.mark.parametrize("store", [True, False])
def test_window_kernel_matches_plain(cuda, act, pool, S, D, hq, hkv,
                                     store):
    q, k, v, pk, pv = _inputs(cuda, S, D, act, pool, seed=S, hq=hq,
                              hkv=hkv)
    pt = torch.as_tensor(HOSTILE_PT, device=cuda)
    idx = torch.tensor([9, 5, -(S + 1)], dtype=torch.int32, device=cuda)
    kk, kv, pk2, pv2 = pk.clone(), pv.clone(), pk.clone(), pv.clone()
    o_k, l_k, c_k, _, _ = paged_window_attention(q, k, v, kk, kv, pt, idx,
                                                 store=store)
    o_p, l_p, _, _, c_p = ref.paged_window_ref(q, k, v, pk2, pv2, pt, idx,
                                               store=store)
    torch.cuda.synchronize()
    _compare((o_k, l_k, c_k), (o_p, l_p, c_p), (kk, kv), (pk2, pv2), act)


# the split-history layout: pages of 4 rows, 11 pages a slot: 6 splits of
# 2 pages (8 rows) in the split kernel, 3 of 4 pages in the tensor-core
# route
SPLIT_PS, SPLIT_M = 4, 11


def _split_table(b, seed):
    pt = np.random.default_rng(seed).permutation(b * SPLIT_M)
    pt = pt.reshape(b, SPLIT_M).astype(np.int32)
    pt[1, 2] = -1                         # a hole inside a history
    return pt


@pytest.mark.parametrize("act,pool", PAIRS)
@pytest.mark.parametrize("D,hq,hkv", _g3((8,), (128,), (64, "G3")))
def test_decode_history_over_splits(cuda, act, pool, D, hq, hkv):
    """The decode kernel over histories that span 1, 2, 3 and 6 splits (a
    hole in slot 1's history, the table's last row, an idle slot), and
    twice on the same inputs: bit-identical out, lse, pools, counters."""
    b = 6
    q, k, v, pk, pv = _inputs(cuda, 1, D, act, pool, seed=D + 1, b=b,
                              pages=b * SPLIT_M, ps=SPLIT_PS, hq=hq,
                              hkv=hkv)
    pt = torch.as_tensor(_split_table(b, seed=D), device=cuda)
    idx = torch.tensor([5, 12, 20, 40, SPLIT_M * SPLIT_PS - 1, -1],
                       dtype=torch.int32, device=cuda)
    kk, kv, pk2, pv2 = pk.clone(), pv.clone(), pk.clone(), pv.clone()
    k3, v3 = pk.clone(), pv.clone()
    got = paged_decode_attention(q, k, v, kk, kv, pt, idx)
    again = paged_decode_attention(q, k, v, k3, v3, pt, idx)
    out, lse, _, _, cnt = ref.paged_decode_ref(q, k, v, pk2, pv2, pt, idx)
    torch.cuda.synchronize()
    _compare(got, (out, lse, cnt), (kk, kv), (pk2, pv2), act)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert torch.equal(kk, k3) and torch.equal(kv, v3)


@pytest.mark.parametrize("route", ["split", "tensor_core"])
@pytest.mark.parametrize("S,D,hq,hkv", _g3(
    (5, 128), (16, 128), (64, 128), (128, 128), (130, 128), (5, 64, "G3"),
    (21, 64, "G3"), (22, 64, "G3"), (128, 64, "G3")))
@pytest.mark.parametrize("store", [True, False])
def test_window_routes_bf16(cuda, route, S, D, hq, hkv, store):
    """The window kernel's split and tensor-core routes on the same bf16
    inputs (f32 pool, head_dim 128, or 64 at G 3), windows at 0 and after
    a history of 48 rows (6 and 3 history splits: the tensor cores split
    the history of a window of one row tile, S * G <= 64 here), against
    the plain version; the route the kernel picks itself (the tensor
    cores, at S * G > 4) gives the same result bit for bit."""
    from repro_torch.kernels.flash_prefill import paged_window_on_route
    b, M_ = 3, -(-(48 + S) // SPLIT_PS) + 1
    q, k, v, pk, pv = _inputs(cuda, S, D, "bfloat16", "float32", seed=S,
                              b=b, pages=b * M_, ps=SPLIT_PS, hq=hq,
                              hkv=hkv)
    pt_np = np.random.default_rng(S).permutation(b * M_).reshape(b, M_)
    pt = torch.as_tensor(pt_np.astype(np.int32), device=cuda)
    idx = torch.tensor([0, 48, -(S + 1)], dtype=torch.int32, device=cuda)
    kk, kv, pk2, pv2 = pk.clone(), pv.clone(), pk.clone(), pv.clone()
    o_k, l_k, c_k, _, _ = paged_window_on_route(route, q, k, v, kk, kv, pt,
                                                idx, store=store)
    o_p, l_p, _, _, c_p = ref.paged_window_ref(q, k, v, pk2, pv2, pt, idx,
                                               store=store)
    k3, v3 = pk.clone(), pv.clone()
    o_a, l_a, c_a, _, _ = paged_window_attention(q, k, v, k3, v3, pt, idx,
                                                 store=store)
    torch.cuda.synchronize()
    _compare((o_k, l_k, c_k), (o_p, l_p, c_p), (kk, kv), (pk2, pv2),
             "bfloat16")
    if route == "tensor_core":
        assert torch.equal(o_a, o_k) and torch.equal(l_a, l_k)
        assert torch.equal(c_a, c_k) and torch.equal(k3, kk)


# a pool of 16 pages of 4 rows chunked over 2 or 4 ranks (tp_serve): the
# slots' pages spread over every chunk, slot 2 idle
CHUNK_PT = np.array([[0, 9, 4, 14, -1],
                     [13, 6, 1, 11, -1],
                     [3, -1, -1, -1, -1]], np.int32)
CHUNK_IDX = (17, 13, -40)            # the new rows on pages 9/14 and 11/6


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("S,act", [(1, "float32"), (1, "bfloat16"),
                                   (2, "float32"), (5, "float32"),
                                   (5, "bfloat16"), (33, "float32"),
                                   (33, "bfloat16")])
def test_chunked_pool_stores_and_attends_owned_rows_only(cuda, n, S, act):
    """B1 (S 1) and B2's store mode on every route (split: S * G <= 4 or a
    short f32 window; tensor cores: bf16; CUDA cores: a long f32 window)
    on one rank's chunk of a page-chunked pool, read through the
    localized table where(owned, pt - off, -1): a window row whose page
    another rank owns is unmapped there, so this rank's kernel neither
    stores nor attends it. Each chunk's call equals the plain version on
    the same chunk; the chunks' pools together equal the unsharded
    call's bit for bit, their stored and silent counts sum to its, and
    their outputs combined by log-sum-exp equal its output."""
    pages, ps = 16, 4
    q, k, v, pk, pv = _inputs(cuda, S, 16, act, "float32", seed=7 + S,
                              pages=pages, ps=ps)
    pt = torch.as_tensor(CHUNK_PT, device=cuda)
    idx = torch.tensor(CHUNK_IDX, dtype=torch.int32, device=cuda)
    if S > 1:
        idx = idx - torch.tensor([S // 2, 0, 0], dtype=torch.int32,
                                 device=cuda)

    def call(qq, pool_k, pool_v, table):
        if S == 1:
            o, lse, cnt = paged_decode_attention(qq, k, v, pool_k, pool_v,
                                                 table, idx)
            return o, lse[..., None], cnt
        o, lse, cnt, _, _ = paged_window_attention(qq, k, v, pool_k, pool_v,
                                                   table, idx, store=True)
        return o, lse, cnt

    def plain(pool_k, pool_v, table):
        if S == 1:
            o, lse, _, _, cnt = ref.paged_decode_ref(q, k, v, pool_k, pool_v,
                                                     table, idx)
            return o, lse[..., None], cnt
        o, lse, _, _, cnt = ref.paged_window_ref(q, k, v, pool_k, pool_v,
                                                 table, idx, store=True)
        return o, lse, cnt

    wk, wv = pk.clone(), pv.clone()
    whole = call(q, wk, wv, pt)
    chunk = pages // n
    outs, lses, kks, kvs, cnt = [], [], [], [], 0
    for r in range(n):
        lpt = pt - r * chunk
        owned = (pt >= 0) & (lpt >= 0) & (lpt < chunk)
        loc = torch.where(owned, lpt, -1).to(torch.int32)
        kk = pk[r * chunk:(r + 1) * chunk].clone()
        kv = pv[r * chunk:(r + 1) * chunk].clone()
        pk2, pv2 = kk.clone(), kv.clone()
        got = call(q, kk, kv, loc)
        want = plain(pk2, pv2, loc)
        torch.cuda.synchronize()
        _compare(got, want, (kk, kv), (pk2, pv2), act)
        outs.append(got[0].float())
        lses.append(got[1].permute(0, 2, 1))          # (B, S, Hq)
        kks.append(kk)
        kvs.append(kv)
        cnt = cnt + got[2]
    assert torch.equal(torch.cat(kks), wk) and torch.equal(torch.cat(kvs), wv)
    assert torch.equal(cnt[:, :2], whole[2][:, :2])
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.amax(dim=0))
    part = torch.where(w[..., None] > 0, torch.stack(outs) * w[..., None],
                       0.0)
    comb = part.sum(0) / w.sum(0)[..., None]
    live = (whole[1] > ref.NEG_INF / 2).permute(0, 2, 1)[..., None]
    tol = 1e-5 if act == "float32" else 2e-2
    err = torch.where(live, (comb - whole[0].float()).abs(), 0.0)
    assert float(err.max()) <= tol


# the window of slot 1 reaches an unmapped page at the table's end, which
# the pool's rank 0 takes in defer mode on a chunk
DEFER_PT = np.array([[0, 9, 4, 14, -1],
                     [13, 6, 1, 11, -1],
                     [3, -1, -1, -1, -1]], np.int32)
DEFER_IDX = (9, 14, -6)


def _defer_cases():
    """(route, S, act, pool) for every route that takes the inputs (the
    tensor cores: bf16 activations)."""
    out = []
    for S, act, pool in ((2, "float32", "float32"), (5, "float32", "float32"),
                         (5, "bfloat16", "float32"),
                         (5, "bfloat16", "bfloat16"),
                         (33, "float32", "float32"),
                         (33, "bfloat16", "float32")):
        for route in ("split", "tensor_core", "cuda_core"):
            if route != "tensor_core" or act == "bfloat16":
                out.append((route, S, act, pool))
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("route,S,act,pool", _defer_cases())
def test_defer_on_a_chunk_matches_plain_on_every_route(cuda, n, route, S,
                                                       act, pool):
    """B2's defer mode on a chunk (``chunk=True``) through every route that
    takes the inputs: each rank's call on its localized table (rank 0
    taking the window rows of pages unmapped in the whole table) twice,
    bit-identical, against the plain version on the same chunk (pools
    untouched, counters 0), and the chunks combined by log-sum-exp equal
    to the unsharded defer call."""
    pages, ps = 16, 4
    q, k, v, pk, pv = _inputs(cuda, S, 16, act, pool, seed=11 + S,
                              pages=pages, ps=ps)
    pt = torch.as_tensor(DEFER_PT, device=cuda)
    idx = torch.tensor(DEFER_IDX, dtype=torch.int32, device=cuda)
    if S > 5:
        idx = torch.tensor((0, 1, -(S + 1)), dtype=torch.int32, device=cuda)
    whole = paged_window_on_route(route, q, k, v, pk, pv, pt, idx,
                                  store=False)
    chunk = pages // n
    outs, lses = [], []
    for r in range(n):
        lpt = pt - r * chunk
        owned = (pt >= 0) & (lpt >= 0) & (lpt < chunk)
        loc = torch.where(owned, lpt, ref.NOT_MINE)
        if r == 0:
            loc = torch.where(pt < 0, ref.UNMAPPED_MINE, loc)
        loc = loc.to(torch.int32)
        kk = pk[r * chunk:(r + 1) * chunk].clone()
        kv = pv[r * chunk:(r + 1) * chunk].clone()
        pk2, pv2 = kk.clone(), kv.clone()
        got = paged_window_on_route(route, q, k, v, kk, kv, loc, idx,
                                    store=False, chunk=True)
        again = paged_window_on_route(route, q, k, v, kk, kv, loc, idx,
                                      store=False, chunk=True)
        o_p, l_p, _, _, c_p = ref.paged_window_ref(
            q, k, v, pk2, pv2, loc, idx, store=False, chunk=True)
        torch.cuda.synchronize()
        assert torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                             again[1])
        _compare(got[:3], (o_p, l_p, c_p), (kk, kv), (pk2, pv2), act)
        assert not got[2].any()
        outs.append(got[0].float())
        lses.append(got[1].permute(0, 2, 1))
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.amax(dim=0))
    comb = (torch.where(w[..., None] > 0, torch.stack(outs) * w[..., None],
                        0.0).sum(0) / w.sum(0)[..., None])
    live = (whole[1] > ref.NEG_INF / 2).permute(0, 2, 1)[..., None]
    tol = 1e-5 if act == "float32" else 2e-2
    assert float(torch.where(live, (comb - whole[0].float()).abs(),
                             0.0).max()) <= tol


@pytest.mark.parametrize("S,store", [(1, True), (5, True), (5, False),
                                     (20, True)])
def test_paged_slot_independent_of_other_slots(cuda, S, store):
    """A slot's out and lse do not change, bit for bit, when the other
    slots' positions change: the split follows page index."""
    b = 4
    q, k, v, pk, pv = _inputs(cuda, S, 128, "bfloat16", "float32", seed=S,
                              b=b, pages=b * SPLIT_M, ps=SPLIT_PS)
    pt = torch.as_tensor(_split_table(b, seed=S), device=cuda)
    results = []
    for rest in ([5, 30, -(S + 1)], [40 - S, 0, 12]):
        idx = torch.tensor([21] + rest, dtype=torch.int32, device=cuda)
        kk, kv = pk.clone(), pv.clone()
        if S == 1:
            out, lse, _ = paged_decode_attention(q, k, v, kk, kv, pt, idx)
        else:
            out, lse, _, _, _ = paged_window_attention(
                q, k, v, kk, kv, pt, idx, store=store)
        results.append((out[0], lse[0]))
    torch.cuda.synchronize()
    (o0, l0), (o1, l1) = results
    assert torch.equal(o0, o1) and torch.equal(l0, l1)


def test_kernels_reject_bad_inputs(cuda):
    q, k, v, pk, pv = _inputs(cuda, 1, 8, "float32", "float32", seed=0)
    pt = torch.as_tensor(HOSTILE_PT, device=cuda)
    idx = torch.tensor([9, 5, -1], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        paged_decode_attention(q, k, v, pk, pv, pt.long(), idx)
    with pytest.raises(ValueError):
        paged_decode_attention(q, k, v, pk, pv, pt.cpu(), idx)
    strided = torch.empty((B, 1, HQ, 2 * q.shape[-1]),
                          device=cuda)[..., :q.shape[-1]]
    with pytest.raises(ValueError):
        paged_window_attention(strided, k, v, pk, pv, pt, idx)


FLASH_TOL = {"float32": (1e-4, 2e-4), "bfloat16": (2e-2, 3e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,hq,hkv,d,causal", [
    (1, 1, 2, 2, 16, True), (7, 7, 4, 2, 16, True),
    (130, 130, 4, 2, 128, True), (200, 130, 4, 4, 64, True),
    (130, 200, 2, 1, 32, True), (200, 130, 4, 2, 128, False),
    # the bf16 tensor-core kernels' edges: D 64, one query row, one row
    # past a 128-row tile, one key past a 64-key tile
    (64, 64, 4, 2, 64, True), (1, 130, 4, 2, 128, True),
    (1, 65, 4, 2, 64, False), (129, 129, 4, 2, 128, True),
    (129, 65, 4, 2, 64, False), (70, 65, 4, 2, 128, True),
    # the training heads of granite-moe-3b-a800m (G 3: dK and dV gather
    # three q heads) and zamba2-1.2b (G 1) at the training length
    (1024, 1024, 24, 8, 64, True), (1024, 1024, 32, 32, 64, True),
    # whisper-large-v3's heads (G 1, D 64): the encoder's and the
    # cross-attention's non-causal tiles, the decoder's causal ones, 1024
    # queries over the capacity's 1500 frames, and tier 1's one-query
    # cross-attention over 128 frames
    (1024, 1024, 20, 20, 64, False), (1024, 1024, 20, 20, 64, True),
    (1024, 1500, 20, 20, 64, False), (1, 128, 20, 20, 64, False),
    # llama-3.2-vision-90b's heads (G 8, D 128: dK and dV gather eight q
    # heads): training's causal self-attention and 1024 x 1024 image
    # cross-attention, and a decode step's one query over the 1024 image
    # tokens
    (1024, 1024, 64, 8, 128, True), (1024, 1024, 64, 8, 128, False),
    (1, 1024, 64, 8, 128, False),
    # the forward's few-row route at its limit (G * Sq = 16 stacked rows,
    # causal: only the first split sees a key) and below it (12), over
    # several key splits with a ragged last one
    (2, 130, 8, 1, 32, True), (3, 200, 8, 2, 64, False),
])
def test_flash_kernels_match_plain(cuda, dtype, sq, skv, hq, hkv, d, causal):
    g = torch.Generator(device=cuda).manual_seed(sq * 1000 + skv)
    dt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dt)
    q, k, v = randn(2, sq, hq, d), randn(2, skv, hkv, d), randn(2, skv, hkv, d)
    dout = randn(2, sq, hq, d)
    before = (flash_attention_forward.launches,
              flash_attention_backward.launches)
    out, lse = flash_attention_forward(q, k, v, causal)
    grads = flash_attention_backward(q, k, v, out, lse, dout, causal)
    want_out, want_lse = ref.flash_attention_ref(q, k, v, causal)
    want = ref.flash_attention_bwd_ref(q, k, v, want_out, want_lse, dout,
                                       causal)
    torch.cuda.synchronize()
    assert (flash_attention_forward.launches,
            flash_attention_backward.launches) == (before[0] + 1,
                                                   before[1] + 1)
    tol_o, tol_g = FLASH_TOL[dtype]
    assert float((out.float() - want_out.float()).abs().max()) <= tol_o
    assert float((lse - want_lse).abs().max()) <= tol_o
    for got, exp in zip(grads, want):
        atol = max(tol_g * float(exp.float().abs().max()), 1e-5)
        assert float((got.float() - exp.float()).abs().max()) <= atol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,splits", [
    (8, 1, 1024, 64, 8, 128, False, 4),   # llama-3.2-vision-90b decode
    (2, 1, 200, 8, 2, 32, True, 1),       # under 4 tiles: one split
    (2, 2, 600, 4, 4, 32, False, 2),      # 10 tiles: two splits
    (1, 1, 128, 20, 20, 64, False, 1),    # whisper's one-query tier 1
    # 64 tiles over 2 kv heads: 16 splits, the last ragged; causal, only
    # the first sees a key
    (1, 4, 4090, 8, 2, 16, True, 16), (1, 1, 4090, 16, 2, 64, False, 16)])
def test_flash_few_rows_over_key_splits(cuda, dtype, b, sq, skv, hq, hkv, d,
                                        causal, splits):
    """The forward's few-row route (``fwd_route``: G * Sq <= 16) at the
    key splits ``few_splits`` gives these shapes (1, 2, 4 and 16): one
    launch a call, out and lse within the flash tolerance of the plain
    version, two calls bit-identical (the splits' fixed-order merge and
    its ticket, left at zero, reused)."""
    from repro_torch.kernels import flash_attention as fa
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fa.fwd_route(sq, hq, hkv) == "few"
    assert fa.few_splits(b, skv, hkv, sms)[0] == splits
    g = torch.Generator(device=cuda).manual_seed(sq * 100 + skv)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=cuda).to(dt)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    want_out, want_lse = ref.flash_attention_ref(q, k, v, causal)
    tol = FLASH_TOL[dtype][0]
    before = flash_attention_forward.launches
    out, lse = flash_attention_forward(q, k, v, causal)
    again = flash_attention_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention_forward.launches == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert float((out.float() - want_out.float()).abs().max()) <= tol
    assert float((lse - want_lse).abs().max()) <= tol


def test_flash_autograd_and_strided_inputs(cuda):
    """The autograd binding on q/k/v that are views of one fused
    projection (strided rows, contiguous head_dim)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn((2, 70, 4 + 2 * 2, 64), generator=g, device=cuda)
    leaf = qkv.clone().requires_grad_(True)
    q, k, v = leaf[:, :, :4], leaf[:, :, 4:6], leaf[:, :, 6:]
    flash_attention(q, k, v, causal=True).square().sum().backward()
    ref_leaf = qkv.clone().requires_grad_(True)
    rq, rk, rv = ref_leaf[:, :, :4], ref_leaf[:, :, 4:6], ref_leaf[:, :, 6:]
    ref.flash_attention_ref(rq, rk, rv, True)[0].square().sum().backward()
    scale = float(ref_leaf.grad.abs().max())
    assert float((leaf.grad - ref_leaf.grad).abs().max()) <= 2e-4 * scale


@pytest.mark.parametrize("d", [32, 128])
def test_flash_bf16_fused_and_misaligned_views(cuda, d):
    """The bf16 kernels on q/k/v views of one fused projection (read by
    stride, no copy) and on views one element into a wider buffer
    (16-byte copies impossible: the wrapper copies each, counted), within
    the bf16 FLASH_TOL of the plain version; two backward calls give
    bit-identical gradients."""
    g = torch.Generator(device=cuda).manual_seed(d)
    bf = torch.bfloat16
    qkv = torch.randn((2, 150, 4 + 2 * 2, d), generator=g,
                      device=cuda).to(bf)
    fused = (qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:])
    wide = torch.randn((2, 150, 8, d + 2), generator=g, device=cuda).to(bf)
    misaligned = (wide[:, :, :4, 1:d + 1], wide[:, :, 4:6, 1:d + 1],
                  wide[:, :, 6:, 1:d + 1])
    dout = torch.randn((2, 150, 4, d), generator=g, device=cuda).to(bf)
    tol_o, tol_g = FLASH_TOL["bfloat16"]
    for (q, k, v), want_copies in ((fused, 0), (misaligned, 3)):
        before = (flash_attention_forward.copies,
                  flash_attention_backward.copies)
        out, lse = flash_attention_forward(q, k, v, True)
        grads = flash_attention_backward(q, k, v, out, lse, dout, True)
        again = flash_attention_backward(q, k, v, out, lse, dout, True)
        want_out, want_lse = ref.flash_attention_ref(q, k, v, True)
        want = ref.flash_attention_bwd_ref(q, k, v, want_out, want_lse,
                                           dout, True)
        torch.cuda.synchronize()
        assert (flash_attention_forward.copies - before[0],
                flash_attention_backward.copies - before[1]) == (
                    want_copies, 2 * want_copies)
        assert float((out.float() - want_out.float()).abs().max()) <= tol_o
        assert float((lse - want_lse).abs().max()) <= tol_o
        for got, exp, rep in zip(grads, want, again):
            assert torch.equal(got, rep)
            atol = tol_g * float(exp.float().abs().max())
            assert float((got.float() - exp.float()).abs().max()) <= atol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 4095, 4096 * 3 + 17, 1 << 20])
@pytest.mark.parametrize("tol", [0.0, 0.01])
def test_silent_compare_matches_plain(cuda, dtype, n, tol):
    g = torch.Generator(device=cuda).manual_seed(n)
    dt = getattr(torch, dtype)
    a = torch.randn(n, generator=g, device=cuda)
    b = a.clone()
    b[::3] += 1e-3 * torch.randn(b[::3].shape, generator=g, device=cuda)
    b[::7] = torch.randn(b[::7].shape, generator=g, device=cuda)
    special = torch.tensor([float("nan"), 0.0, -0.0, float("inf"),
                            -float("inf"), 1e-40, -1e-40, 0.0],
                           device=cuda)
    m = min(n, special.numel())
    a[:m] = special[:m]
    b[:m] = special.flip(0)[:m]
    if n > 16:
        a[8:16] = special
        b[8:16] = special
    a, b = a.to(dt), b.to(dt)
    before = silent_compare.launches
    got = silent_compare(a, b, tol)
    want = ref.silent_compare_ref(a, b, tol)
    torch.cuda.synchronize()
    assert silent_compare.launches == before + 1
    assert got.dtype == torch.int32 and int(got) == int(want)
    mixed = silent_compare(a.float(), b, tol)
    assert int(mixed) == int(ref.silent_compare_ref(a.float(), b, tol))


VERIFY_PT = np.array([[5, 1, 6, -1, -1, -1],
                      [2, 7, 0, 4, -1, -1],
                      [3, -1, -1, -1, -1, -1]], np.int32)


def test_verify_wrapper_w5_both_modes(cuda):
    """The verify window (W = 5, head_dim 128): slot 0 crosses a page
    boundary, slot 1 runs past its mapped extent (rows drop in store
    mode), slot 2 is idle at -(W+1). Each mode against the plain window
    version; defer leaves the pools alone with zero counters, and its
    outputs on slot 0 equal store mode's bit for bit."""
    W = 5
    q, k, v, pk, pv = _inputs(cuda, W, 128, "bfloat16", "float32", seed=5)
    pt = torch.as_tensor(VERIFY_PT, device=cuda)
    idx = torch.tensor([6, 14, -(W + 1)], dtype=torch.int32, device=cuda)
    outs = {}
    for mode in ("overwrite", "defer"):
        kk, kv, pk2, pv2 = pk.clone(), pv.clone(), pk.clone(), pv.clone()
        before = paged_window_attention.launches
        o_k, l_k, c_k, _, _ = paged_verify_attention(q, k, v, kk, kv, pt,
                                                     idx, mode=mode)
        o_p, l_p, _, _, c_p = ref.paged_window_ref(
            q, k, v, pk2, pv2, pt, idx, store=mode == "overwrite")
        torch.cuda.synchronize()
        assert paged_window_attention.launches == before + 1
        _compare((o_k, l_k, c_k), (o_p, l_p, c_p), (kk, kv), (pk2, pv2),
                 "bfloat16")
        if mode == "defer":
            assert torch.equal(kk, pk) and torch.equal(kv, pv)
            assert int(c_k.abs().sum()) == 0
        else:
            assert int(c_k[1, 2]) > 0 and int(c_k[2].sum()) == 0
        outs[mode] = o_k
    assert torch.equal(outs["defer"][0], outs["overwrite"][0])


RMS_TOL = {"float32": (1e-5, 2e-4), "bfloat16": (2e-2, 3e-2)}


def rms_tol(dtype):
    """(output, gradient) tolerance of an RMSNorm output in ``dtype``:
    float32's, or the 16-bit one (one rounding of the output)."""
    return RMS_TOL["float32" if dtype == "float32" else "bfloat16"]
RMS_PAIRS = [("float32", "float32"), ("bfloat16", "float32"),
             ("bfloat16", "bfloat16"), ("float32", "bfloat16"),
             ("float16", "float16")]


@pytest.mark.parametrize("x_dtype,s_dtype", RMS_PAIRS)
@pytest.mark.parametrize("rows,width,strided", [
    (1, 128, False), (8, 2048, False), (517, 128, True), (131, 2048, True),
    (33, 1000, False), (33, 1000, True), (700, 2048, False), (9, 64, False),
    (77, 64, True), (29, 999, False), (3, 10000, False),
    (1024, 1536, False), (40, 1536, True), (1024, 2048, False),
    (8192, 128, False),
    # zamba2-1.2b's gate norm (two warps a row in the forward, 8
    # elements a thread backward), and 8200, the next width of 8 past
    # the wide route's widest (WIDE_MAX_D 8192), on the general route
    (64, 4096, False), (131, 4096, True), (33, 8200, False),
    # whisper-large-v3's width (decode, serving encoder, training rows),
    # xlstm-1.3b's mLSTM out_norm at its decode rows
    (8, 1280, False), (1024, 1280, False), (4096, 1280, False),
    (131, 1280, True), (8, 4096, False),
    # llama-3.2-vision-90b's width 8192 (the wide route's widest: four
    # warps a row forward, 16 elements a thread backward): decode and
    # training rows
    (8, 8192, False), (4096, 8192, False), (131, 8192, True),
    # wide widths past 4096 that are a multiple of 8 but not of 16: the
    # backward's last thread holds live and dead 16-byte chunks (bf16
    # strided 8184 rows are not 16-byte aligned: the general route)
    (33, 4104, False), (64, 8184, False), (131, 8184, True)])
def test_rmsnorm_kernels_match_plain(cuda, x_dtype, s_dtype, rows, width,
                                     strided):
    g = torch.Generator(device=cuda).manual_seed(rows * 7 + width)
    xdt, sdt = getattr(torch, x_dtype), getattr(torch, s_dtype)
    base = 3 * torch.randn((rows, 2 * width if strided else width),
                           generator=g, device=cuda)
    x = base[:, :width].to(xdt) if not strided else \
        base.to(xdt)[:, width // 2:width // 2 + width]
    scale = torch.randn(width, generator=g, device=cuda).to(sdt)
    dy = torch.randn((rows, width), generator=g, device=cuda).to(xdt)
    before = (rmsnorm_forward.launches, rmsnorm_backward.launches)
    y, rstd = rmsnorm_forward(x, scale, 1e-6, want_rstd=True)
    y_only, none = rmsnorm_forward(x, scale, 1e-6)
    y2, rstd2 = rmsnorm_forward(x, scale, 1e-6, want_rstd=True)
    dx, ds = rmsnorm_backward(x, scale, rstd, dy, 1e-6)
    want = ref.rmsnorm_ref(x, scale, 1e-6)
    want_rstd = torch.rsqrt(x.float().square().mean(-1) + 1e-6)
    want_dx, want_ds = ref.rmsnorm_bwd_ref(x, scale, dy, 1e-6)
    torch.cuda.synchronize()
    assert (rmsnorm_forward.launches, rmsnorm_backward.launches) == \
        (before[0] + 3, before[1] + 1)
    assert torch.equal(y, y2) and torch.equal(rstd, rstd2)
    dx2, ds2 = rmsnorm_backward(x, scale, rstd, dy, 1e-6)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)
    plan = plan_for(x, dy)
    _, blocked_ds = ref.rmsnorm_bwd_blocked(
        x, scale, rstd, dy, blocks=plan.blocks, workers=plan.workers,
        group=plan.group)
    assert torch.equal(ds, blocked_ds), plan
    assert none is None and torch.equal(y, y_only)
    assert y.dtype == xdt and dx.dtype == xdt and ds.dtype == sdt
    # each output held at its own dtype's tolerance: y and dx in x's,
    # dscale in scale's
    assert float(((y.float() - want.float()).abs()
                  / want.float().abs().clamp_min(1e-3)).max()) <= \
        rms_tol(x_dtype)[0]
    assert float(((rstd - want_rstd).abs() / want_rstd).max()) <= 1e-5
    for got, exp, dt in ((dx, want_dx, x_dtype), (ds, want_ds, s_dtype)):
        scale_g = float(exp.float().abs().max())
        assert float((got.float() - exp.float()).abs().max()) <= \
            rms_tol(dt)[1] * scale_g


@pytest.mark.parametrize("x_dtype,s_dtype", RMS_PAIRS)
@pytest.mark.parametrize("rows,width,strided,route", [
    (8192, 128, False, "narrow"), (300, 64, False, "narrow"),
    (1024, 1536, False, "wide"), (1024, 2048, False, "wide"),
    (517, 4096, False, "wide"), (133, 1000, True, "general")])
def test_rmsnorm_forward_same_bits_at_every_rows_a_block(
        cuda, x_dtype, s_dtype, rows, width, strided, route):
    """The forward on every rows-a-block its route takes (1 to 32):
    the route, a launch a call, and y and rstd equal bit for bit to the
    wrapper's own plan's."""
    g = torch.Generator(device=cuda).manual_seed(rows + width)
    xdt, sdt = getattr(torch, x_dtype), getattr(torch, s_dtype)
    base = 3 * torch.randn((rows, 2 * width), generator=g, device=cuda)
    x = base.to(xdt)[:, 1:1 + width] if strided else \
        base[:, :width].to(xdt).contiguous()
    scale = torch.randn(width, generator=g, device=cuda).to(sdt)
    y, rstd = rmsnorm_forward(x, scale, 1e-6, want_rstd=True)
    assert fwd_plan_for(x, scale).route == route
    for k in (1, 2, 4, 8, 16, 32):
        plan = fwd_plan_for(x, scale, k)
        before = rmsnorm_forward.launches
        yk, rk = rmsnorm_forward(x, scale, 1e-6, want_rstd=True, rows=k)
        torch.cuda.synchronize()
        assert rmsnorm_forward.launches == before + 1
        assert plan.route == route
        assert torch.equal(yk, y) and torch.equal(rk, rstd), plan


def test_rmsnorm_autograd_on_qk_norm_layout(cuda):
    """The autograd binding on qk-norm's (B, S, H, D) reshape of a
    projection (bf16 x, bf16 scale as the training compute params):
    outputs and gradients against autograd of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x0 = torch.randn((2, 70, 4 * 128), generator=g, device=cuda)
    s0 = torch.randn(128, generator=g, device=cuda)
    dy = torch.randn((2, 70, 4, 128), generator=g, device=cuda)
    outs = []
    for fn in (lambda x, s: RMSNorm.apply(x, s, 1e-6),
               lambda x, s: ref.rmsnorm_ref(x, s, 1e-6)):
        x = x0.to(torch.bfloat16).requires_grad_(True)
        s = s0.to(torch.bfloat16).requires_grad_(True)
        y = fn(x.reshape(2, 70, 4, 128), s)
        y.backward(dy.to(torch.bfloat16))
        outs.append((y.float(), x.grad.float(), s.grad.float()))
    for got, want in zip(*outs):
        assert float((got - want).abs().max()) <= \
            3e-2 * float(want.abs().max())


# ----------------------------------------------------------------------
# Object tier: the replica digest and the KV page reader on the card
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("shape", [(96,), (8, 12), (1 << 14,), (256, 256),
                                   (50001,), (3, 1000, 37)])
def test_object_digest_on_card_equals_cpu(cuda, dtype, shape):
    """A CUDA tensor's digest (its sampled chunks gathered on the card)
    equals its CPU copy's: whole below 64 KiB, sampled above."""
    from repro_torch.core.replicas import object_digest
    g = torch.Generator(device=cuda).manual_seed(len(shape))
    if dtype == "int32":
        t = torch.randint(-2**31, 2**31 - 1, shape, generator=g,
                          device=cuda, dtype=torch.int32)
    else:
        t = torch.randn(shape, generator=g, device=cuda).to(
            getattr(torch, dtype))
    want = object_digest(t.cpu())
    assert object_digest(t) == want
    if t.ndim == 2:
        assert object_digest(t.t()) == object_digest(t.t().cpu())
    other = t.clone()
    other.view(-1)[-1] += 1
    assert object_digest(other) != want


def test_kv_page_reader_on_card(cuda):
    """The engine's kv_page reader on the card: the pool's page p of every
    layer, k then v, as flat bytes equal to the host copy's, and a digest
    equal to the host copy's."""
    import dataclasses
    from repro_torch.configs import registry as cfgs
    from repro_torch.core.objects import ObjectRegistry
    from repro_torch.core.replicas import object_digest
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = dataclasses.replace(cfgs.get_config("qwen3-1.7b").smoke(),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    reg = ObjectRegistry()
    eng = ServeEngine(model, params, num_slots=2, max_len=40,
                      kv_layout="paged", page_size=8, registry=reg,
                      owner="replica0")
    rng = np.random.RandomState(0)
    for i in range(3):
        eng.submit(Request(rid=f"r{i}", max_new_tokens=4,
                           tokens=rng.randint(0, cfg.vocab_size, 20)
                           .astype(np.int32)))
    eng.run()
    pages = reg.live("kv_page")
    assert pages
    for rec in pages:
        p = int(rec.name.rsplit("page", 1)[1])
        got = rec.reader()
        assert got.device.type == "cuda" and got.dtype == torch.uint8
        host = b"".join(
            np.ascontiguousarray(sub[key][:, p].cpu().numpy()).tobytes()
            for sub in eng.cache["main"].values() if "pt" in sub
            for key in ("k", "v"))
        assert got.cpu().numpy().tobytes() == host
        assert got.numel() == rec.nbytes
        assert object_digest(got) == object_digest(got.cpu())
