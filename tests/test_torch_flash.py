"""The plain versions of the flash attention kernel (B4, forward and
backward) and of the silent-compare kernel (B3) against the reference on
the CPU: the reference's Pallas kernels in interpret mode, and for the
backward the hand-written VJP of ``flash_xla`` that the reference trains
through. The port's CPU entry points (``ops.attention``,
``ops.silent_count``) are these plain versions.

Tolerances: float32 outputs and lse within 2e-5 (the same f32 arithmetic
summed in another order); bfloat16 outputs within 2e-2 (one bf16
rounding of an output below 4 in magnitude: 2 ulps); float32 gradients
within 1e-5 of the largest gradient magnitude (and 1e-6 where every
gradient is zero in exact arithmetic, as dq and dk of a single key).
Silent counts equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_fa
from repro.kernels import flash_xla as ref_fx
from repro.kernels import silent_compare as ref_sc
from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (Sq, Skv, Hq, Hkv): ragged lengths around the 128-row Pallas block,
# Sq != Skv both ways, GQA groups of 1 and 2
SHAPES = [(1, 200, 4, 4), (7, 7, 4, 2), (200, 130, 4, 2), (130, 200, 2, 2)]


def _qkv(sq, skv, hq, hkv, d, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((2, s, h, d)).astype(np.float32)
            for s, h in ((sq, hq), (skv, hkv), (skv, hkv))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    pt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, pt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_forward_matches_pallas_interpret(shape, causal, dtype):
    sq, skv, hq, hkv = shape
    (q, k, v), (tq, tk, tv) = _qkv(sq, skv, hq, hkv, 32, dtype, seed=sq + skv)
    want = ref_fa.flash_attention(q, k, v, causal=causal, interpret=True)
    out, lse = ref.flash_attention_ref(tq, tk, tv, causal)
    assert out.dtype == tq.dtype and lse.shape == (2, hq, sq)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])
    if dtype == "float32":
        # lse against flash_xla's forward, (B, Sq, Hkv, G) -> (B, Hq, Sq)
        _, want_lse = ref_fx._fwd_impl(q, k, v, causal, 0,
                                       ref_fx.DEFAULT_CHUNK)
        want_lse = np.asarray(want_lse).reshape(2, sq, hq).transpose(0, 2,
                                                                     1)
        np.testing.assert_allclose(lse.numpy(), want_lse, atol=TOL[dtype],
                                   rtol=TOL[dtype])
    # the port's CPU entry point is this plain version
    got = ops.attention(tq, tk, tv, causal=causal)
    assert torch.equal(got, out)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_backward_matches_flash_xla_vjp(shape, causal):
    sq, skv, hq, hkv = shape
    (q, k, v), (tq, tk, tv) = _qkv(sq, skv, hq, hkv, 16, "float32",
                                   seed=7 * sq + skv)
    dout = np.random.default_rng(sq).standard_normal(
        (2, sq, hq, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: ref_fx.flash_xla(a, b, c, causal, 0),
                     q, k, v)
    want = vjp(jnp.asarray(dout))
    out, lse = ref.flash_attention_ref(tq, tk, tv, causal)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse,
                                      torch.from_numpy(dout), causal)
    # and through autograd at the CPU entry point
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    auto = torch.autograd.grad(ops.attention(*leaves, causal=causal),
                               leaves, torch.from_numpy(dout))
    for g, a, w in zip(got, auto, want):
        w = np.asarray(w)
        atol = max(1e-5 * np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=0)
        assert torch.equal(a, g)


def _compare_operands(n, dtype, seed):
    """a and b of n elements: silent within 1%, changed, NaN, +-0 and
    infinities (no subnormals: XLA's CPU backend flushes them)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32)
    b = a.copy()
    b[::3] *= 1 + rng.uniform(-0.02, 0.02, b[::3].shape).astype(np.float32)
    b[::7] = rng.standard_normal(b[::7].shape)
    special = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0, np.inf,
                        np.nan], np.float32)
    m = min(n, special.size)
    a[:m] = special[:m]
    b[:m] = special[::-1][:m]
    if n > 16:
        a[8:16] = b[8:16] = special
    return (jnp.asarray(a).astype(dtype), jnp.asarray(b).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)),
            torch.from_numpy(b).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tol", [0.0, 0.01])
@pytest.mark.parametrize("n", [1, 1000, 256 * 128 + 5, 70001])
def test_silent_count_matches_pallas_interpret(n, tol, dtype):
    a, b, ta, tb = _compare_operands(n, dtype, seed=n)
    want = int(ref_sc.silent_compare(a, b, tol, interpret=True))
    got = ops.silent_count(ta, tb, tol)
    assert got.dtype == torch.int32 and int(got) == want
    assert int(ref.silent_compare_ref(ta.reshape(-1, 1), tb.reshape(-1, 1),
                                      tol)) == want
    assert ops.silent_fraction(ta, tb, tol) == pytest.approx(want / n,
                                                             rel=1e-6)


# ----------------------------------------------------------------------
# The arithmetic of the bfloat16 tensor-core kernels, emulated on the CPU
# ----------------------------------------------------------------------
def _tc_forward(q, k, v, causal, bk=32):
    """The tensor-core forward's arithmetic: bf16 q, k, v; S in f32;
    online softmax in steps of 32 keys in log2 units; P rounded to bf16
    before P.V; f32 sums. Returns (out in bf16, lse f32 (B, Hq, Sq))."""
    B, Sq, Hq, D = q.shape
    Skv, G = k.shape[1], Hq // k.shape[2]
    qf = q.float().transpose(1, 2)                           # (B, Hq, Sq, D)
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    scale_log2 = torch.tensor(1.0 / np.sqrt(D) * np.log2(np.e),
                              dtype=torch.float32)
    m = torch.full((B, Hq, Sq), -torch.inf)
    l = torch.zeros((B, Hq, Sq))
    o = torch.zeros((B, Hq, Sq, D))
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, bk):
        s = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        if causal:
            kpos = torch.arange(k0, min(k0 + bk, Skv))[None, :]
            s = torch.where(kpos <= qpos, s, -torch.inf)
        mn = torch.maximum(m, s.amax(-1) * scale_log2)
        mu = torch.where(mn == -torch.inf, 0.0, mn)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(s * scale_log2 - mu[..., None])
        l = l * alpha + p.sum(-1)
        m = mn
        o = (o * alpha[..., None]
             + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + bk])
    out = torch.where(l[..., None] > 0, o / l[..., None], 0.0)
    lse = torch.where(l > 0, (m + torch.log2(l)) * np.log(2), ref.NEG_INF)
    return out.transpose(1, 2).to(torch.bfloat16), lse


def _tc_backward(q, k, v, out, lse, dout, causal):
    """The tensor-core backward's arithmetic: S and dP in f32 from bf16
    operands, p = exp2(S scale log2 e - lse log2 e), delta in f32, P and
    dS rounded to bf16 before dV = P^T dO, dK = dS^T Q, dQ = dS K; f32
    sums. Returns (dq, dk, dv) in bf16."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / np.sqrt(D)
    qf, dof = (x.float().transpose(1, 2) for x in (q, dout))
    kf, vf = (x.float().repeat_interleave(G, dim=2).transpose(1, 2)
              for x in (k, v))
    s = qf @ kf.transpose(-1, -2)
    p = torch.exp2(s * float(scale * np.log2(np.e))
                   - (lse * float(np.log2(np.e)))[..., None])
    if causal:
        p = torch.where(torch.arange(Skv)[None, :]
                        <= torch.arange(Sq)[:, None], p, 0.0)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None]) * scale
    pb, dsb = (x.to(torch.bfloat16).float() for x in (p, ds))
    dq = (dsb @ kf).transpose(1, 2)
    dk = (dsb.transpose(-1, -2) @ qf).reshape(B, Hkv, G, Skv, D).sum(2)
    dv = (pb.transpose(-1, -2) @ dof).reshape(B, Hkv, G, Skv, D).sum(2)
    return (dq.to(torch.bfloat16), dk.transpose(1, 2).to(torch.bfloat16),
            dv.transpose(1, 2).to(torch.bfloat16))


# chip_smoke's and the card tests' bf16 tolerance: out and lse, and the
# gradients relative to the plain gradient's largest magnitude
FLASH_TOL_BF16 = (2e-2, 3e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_tc_rounding_within_flash_tol_at_training_length(causal):
    """Rounding P and dS to bf16 as the tensor-core kernels do stays
    within the bf16 FLASH_TOL of the f32 plain versions at S 1024, D 128
    (one batch, Hq 4, Hkv 2)."""
    rng = np.random.default_rng(14)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        (1, 1024, h, 128)).astype(np.float32)).to(torch.bfloat16)
        for h in (4, 2, 2, 4))
    out, lse = _tc_forward(q, k, v, causal)
    grads = _tc_backward(q, k, v, out, lse, dout, causal)
    want_out, want_lse = ref.flash_attention_ref(q, k, v, causal)
    want = ref.flash_attention_bwd_ref(q, k, v, want_out, want_lse, dout,
                                       causal)
    tol_o, tol_g = FLASH_TOL_BF16
    assert float((out.float() - want_out.float()).abs().max()) <= tol_o
    assert float((lse - want_lse).abs().max()) <= tol_o
    for got, exp in zip(grads, want):
        rel = (float((got.float() - exp.float()).abs().max())
               / float(exp.float().abs().max()))
        assert rel <= tol_g, rel


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_tc_rounding_matches_pallas_interpret(shape, causal):
    """The emulated tensor-core forward against the reference's Pallas
    kernel in interpret mode, bf16 inputs, within the file's bf16 TOL."""
    sq, skv, hq, hkv = shape
    (q, k, v), (tq, tk, tv) = _qkv(sq, skv, hq, hkv, 32, "bfloat16",
                                   seed=3 * sq + skv)
    want = ref_fa.flash_attention(q, k, v, causal=causal, interpret=True)
    out, _ = _tc_forward(tq, tk, tv, causal)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


# ----------------------------------------------------------------------
# The forward's few-row route (G * Sq <= 16 query rows a kv head),
# emulated on the CPU
# ----------------------------------------------------------------------
def _few_forward(q, k, v, causal, splits, split_keys, tc):
    """The few-row route's arithmetic: a kv head's G query heads x Sq rows
    stacked (row i = r G + g); its keys cut into ``splits`` splits of
    ``split_keys`` (none past the last query row under the causal mask);
    in a split, four warps each keep an online softmax in log2 units over
    their keys (tensor cores, ``tc``: 16 keys of every 64-key tile, P
    rounded to bf16 before P.V; CUDA cores: every 4th key, one at a
    time), merged in warp order into the split's partial (m, l, acc);
    the partials merged in split order. Returns (out in q's dtype, lse
    f32 (B, Hq, Sq))."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G, R = Hq // Hkv, Hq // Hkv * Sq
    qs = q.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 1, 3, 4)
    qs = qs.reshape(B, Hkv, R, D)
    kf, vf = (x.float().transpose(1, 2) for x in (k, v))  # (B, Hkv, Skv, D)
    row = torch.arange(R) // G                            # each row's query
    scale_log2 = torch.tensor(1.0 / np.sqrt(D) * np.log2(np.e),
                              dtype=torch.float32)
    kend = min(Skv, Sq) if causal else Skv
    neg = torch.tensor(-torch.inf)

    def merge(states):
        """(m, l, acc) states merged in order (log2 units)."""
        mx = torch.stack([m for m, _, _ in states]).amax(0)
        L, A = torch.zeros_like(mx), torch.zeros(mx.shape + (D,))
        for m, l, acc in states:
            w = torch.where(l > 0, torch.exp2(m - mx), 0.0)
            L, A = L + l * w, A + acc * w[..., None]
        return mx, L, A

    parts = []
    for sp in range(splits):
        lo, hi = sp * split_keys, min((sp + 1) * split_keys, kend)
        warps = []
        for w in range(4):
            if tc:
                chunks = [list(range(t + 16 * w, min(t + 16 * w + 16, hi)))
                          for t in range(lo, hi, 64)]
            else:
                chunks = [[j] for j in range(lo + w, hi, 4)]
            m = torch.full((B, Hkv, R), -torch.inf)
            l, acc = torch.zeros((B, Hkv, R)), torch.zeros((B, Hkv, R, D))
            for keys in (c for c in chunks if c):
                s = qs @ kf[:, :, keys].transpose(-1, -2)
                if causal:
                    s = torch.where(torch.tensor(keys)[None, :]
                                    <= row[:, None], s, neg)
                mn = torch.maximum(m, s.amax(-1) * scale_log2)
                mu = torch.where(mn == -torch.inf, 0.0, mn)
                alpha = torch.exp2(m - mu)
                p = torch.exp2(s * scale_log2 - mu[..., None])
                pv = p.to(torch.bfloat16).float() if tc else p
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + pv @ vf[:, :, keys]
                m = mn
            warps.append((m, l, acc))
        parts.append(merge(warps))
    mx, L, A = merge(parts)
    out = torch.where(L[..., None] > 0, A / L[..., None], 0.0)
    lse = torch.where(L > 0, (mx + torch.log2(L)) * np.log(2), ref.NEG_INF)
    out = out.reshape(B, Hkv, Sq, G, D).permute(0, 2, 1, 3, 4)
    lse = lse.reshape(B, Hkv, Sq, G).permute(0, 1, 3, 2)
    return (out.reshape(B, Sq, Hq, D).to(q.dtype),
            lse.reshape(B, Hq, Sq))


# (Sq, Skv, Hq, Hkv): one query of 4 heads a kv head over 4 splits of 64
# keys, the last ragged (causal: every split after the first is empty),
# and two queries of one head a kv head over 3 splits
FEW_SHAPES = [(1, 200, 8, 2), (2, 130, 4, 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FEW_SHAPES)
def test_few_row_route_matches_pallas_interpret(shape, causal, dtype):
    """The few-row route's emulated arithmetic (tensor cores for bf16, CUDA
    cores for f32, a key split a 64-key tile) against the reference's Pallas
    kernel in interpret mode and the plain version, within the file's TOL;
    lse against the plain version."""
    from repro_torch.kernels import flash_attention as fa
    sq, skv, hq, hkv = shape
    (q, k, v), (tq, tk, tv) = _qkv(sq, skv, hq, hkv, 32, dtype,
                                   seed=5 * sq + skv)
    assert fa.fwd_route(sq, hq, hkv) == "few"
    # a split a tile (the most there are), to hold the merge of several
    splits, split_keys = -(-skv // fa.FEW_KEYS), fa.FEW_KEYS
    out, lse = _few_forward(tq, tk, tv, causal, splits, split_keys,
                            tc=dtype == "bfloat16")
    want = ref_fa.flash_attention(q, k, v, causal=causal, interpret=True)
    want_out, want_lse = ref.flash_attention_ref(tq, tk, tv, causal)
    for w in (np.asarray(want.astype(jnp.float32)), want_out.float().numpy()):
        np.testing.assert_allclose(out.float().numpy(), w,
                                   atol=TOL[dtype], rtol=TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("Sq,Hq,Hkv,route", [
    (1, 64, 8, "few"),       # llama-3.2-vision-90b decode
    (1, 20, 20, "few"),      # whisper's one-query tier 1
    (1024, 16, 8, "tile"),   # the training shape (4, 1024, 16, 8, 128)
    (2, 16, 2, "few"),       # G * Sq = 16: the limit
    (3, 12, 2, "tile"),      # 18
    (16, 4, 4, "few"),       # G 1, 16 rows
    (17, 4, 4, "tile")])
def test_fwd_route_by_stacked_rows(Sq, Hq, Hkv, route):
    from repro_torch.kernels import flash_attention as fa
    assert fa.fwd_route(Sq, Hq, Hkv) == route


@pytest.mark.parametrize("B,Skv,Hkv,splits", [
    (8, 1024, 8, (4, 256)),    # the vlm decode: 256 blocks
    (1, 128, 20, (1, 128)),    # whisper: no split under 4 tiles
    (2, 520, 2, (2, 320)),     # 9 tiles: 2 splits, the last ragged
    (64, 1024, 8, (1, 1024)),  # enough (kv head, batch) blocks
    (2, 1100, 2, (4, 320)),    # balanced: 4 splits of 5 tiles, the last 3
    (1, 4090, 2, (16, 256)),   # 64 tiles: 16 splits, the last ragged
    (1, 8192, 2, (16, 512))])  # at most FEW_MAX_SPLITS
def test_few_splits_cover_the_keys(B, Skv, Hkv, splits):
    """``few_splits``: the C entry's conditions (keys a split a multiple
    of FEW_KEYS, the last split holding the last key) at every case."""
    from repro_torch.kernels import flash_attention as fa
    ns, sk = fa.few_splits(B, Skv, Hkv, 132)
    assert (ns, sk) == splits
    assert sk % fa.FEW_KEYS == 0 and (ns - 1) * sk < Skv <= ns * sk


def test_bf16_alignment_copy_rule():
    """The wrapper's rule for the bf16 kernels' 16-byte copies: a view of a
    fused projection is read in place; a view one element into a wider
    row is copied (contiguous, equal) and counted; f32 is never copied."""
    from repro_torch.kernels import flash_attention as fa

    class Counter:
        copies = 0
    fused = torch.randn((2, 5, 8, 64)).to(torch.bfloat16)[:, :, 4:6]
    assert fa._aligned(fused, Counter) is fused and Counter.copies == 0
    wide = torch.randn((2, 5, 8, 66)).to(torch.bfloat16)
    view = wide[..., 1:65]
    got = fa._aligned(view, Counter)
    assert Counter.copies == 1 and got.is_contiguous()
    assert torch.equal(got, view) and got.data_ptr() % 16 == 0
    f32 = torch.randn((2, 5, 8, 66))[..., 1:65]
    assert fa._aligned(f32, Counter) is f32 and Counter.copies == 1
