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
