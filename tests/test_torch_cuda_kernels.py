"""The PyTorch port's hand-written CUDA kernels against their plain
versions, on the card (marked ``cuda``; they skip without a GPU and
nvcc). Run them on a machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Paged kernels: small hostile shapes (the reference's hostile page
table: out-of-order pages, partial last pages, unmapped tails, an idle
slot), every activation/pool dtype pair: pools after the store and
counters equal bit for bit; outputs and lse within 1e-5 (float32: the
kernel sums in another order) or 2e-2 (bfloat16: one rounding of the
output) on rows that attend something; rows that attend nothing come
back 0 / NEG_INF.

Flash attention: ragged and unequal Sq/Skv, GQA G = 1 and 2, causal and
not, every head_dim the kernel takes: out and lse within 1e-4 (float32)
or 2e-2 (bfloat16); dq, dk, dv within 2e-4 (float32) or 3e-2 (bfloat16)
of the plain gradient's largest magnitude, and within 1e-5 where every
gradient is zero in exact arithmetic (dq and dk of a single key). Silent compare: counts equal
exactly, on ragged sizes with NaN, +-0, infinities and subnormals.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_backward, flash_attention_forward)
from repro_torch.kernels.flash_prefill import paged_window_attention
from repro_torch.kernels.paged_attention import paged_decode_attention
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


def _inputs(dev, S, D, act, pool, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(
            getattr(torch, dtype))
    return (randn(B, S, HQ, D, dtype=act), randn(B, S, HKV, D, dtype=act),
            randn(B, S, HKV, D, dtype=act), randn(P, PS, HKV, D, dtype=pool),
            randn(P, PS, HKV, D, dtype=pool))


def _compare(got, want, pools_got, pools_want, act):
    (o_k, l_k, c_k), (o_p, l_p, c_p) = got, want
    assert torch.equal(pools_got[0], pools_want[0])
    assert torch.equal(pools_got[1], pools_want[1])
    assert torch.equal(c_k, c_p)
    S = o_k.shape[1]
    lse_k, lse_p = l_k.reshape(B, HQ, S), l_p.reshape(B, HQ, S)
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
@pytest.mark.parametrize("D", [8, 128])
def test_decode_kernel_matches_plain(cuda, act, pool, D):
    q, k, v, pk, pv = _inputs(cuda, 1, D, act, pool, seed=D)
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
@pytest.mark.parametrize("S", [1, 5, 20])
@pytest.mark.parametrize("store", [True, False])
def test_window_kernel_matches_plain(cuda, act, pool, S, store):
    q, k, v, pk, pv = _inputs(cuda, S, 16, act, pool, seed=S)
    pt = torch.as_tensor(HOSTILE_PT, device=cuda)
    idx = torch.tensor([9, 5, -(S + 1)], dtype=torch.int32, device=cuda)
    kk, kv, pk2, pv2 = pk.clone(), pv.clone(), pk.clone(), pv.clone()
    o_k, l_k, c_k, _, _ = paged_window_attention(q, k, v, kk, kv, pt, idx,
                                                 store=store)
    o_p, l_p, _, _, c_p = ref.paged_window_ref(q, k, v, pk2, pv2, pt, idx,
                                               store=store)
    torch.cuda.synchronize()
    _compare((o_k, l_k, c_k), (o_p, l_p, c_p), (kk, kv), (pk2, pv2), act)


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
