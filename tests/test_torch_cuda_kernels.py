"""The PyTorch port's hand-written CUDA kernels against their plain
versions, on the card (marked ``cuda``; they skip without a GPU and
nvcc). Run them on a machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Small hostile shapes (the reference's hostile page table: out-of-order
pages, partial last pages, unmapped tails, an idle slot), every
activation/pool dtype pair: pools after the store and counters equal bit
for bit; outputs and lse within 1e-5 (float32: the kernel sums in
another order) or 2e-2 (bfloat16: one rounding of the output) on rows
that attend something; rows that attend nothing come back 0 / NEG_INF.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_prefill import paged_window_attention
from repro_torch.kernels.paged_attention import paged_decode_attention

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
