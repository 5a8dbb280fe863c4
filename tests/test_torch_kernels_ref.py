"""The PyTorch port's plain kernel versions (``repro_torch.kernels.ref``)
and its device dispatch (``repro_torch.kernels.ops``) against the
reference's jnp oracles on HOSTILE page tables: out-of-order pages,
partially filled last pages, unmapped tails, idle slots.

Pools after the store and the store-site counters must be equal bit for
bit. Attention outputs must agree within 2e-5 (float32: the same f32
arithmetic summed in another order) or 2e-2 (bfloat16 activations or
pools: one bf16 rounding of the output) on rows that attend something.
The reference's Pallas kernels do not run under the installed JAX, so the
jnp oracles are the reference here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as kref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref

HOSTILE_PT = np.array([[5, 1, 6, -1],
                       [2, 7, -1, -1],
                       [-1, -1, -1, -1]], np.int32)
HOSTILE_IDX = np.array([9, 5, -1], np.int32)
HOSTILE_IDX_W = np.array([9, 5, -8], np.int32)
B, P, PS, M = 3, 8, 4, 4
HQ, HKV, D = 4, 2, 8
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(S, pool_dtype, act_dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    f = {k: rng.standard_normal(shape).astype(np.float32) for k, shape in
         (("q", (B, S, HQ, D)), ("k", (B, S, HKV, D)), ("v", (B, S, HKV, D)),
          ("pk", (P, PS, HKV, D)), ("pv", (P, PS, HKV, D)))}
    jd_a, td_a = DTYPES[act_dtype]
    jd_p, td_p = DTYPES[pool_dtype]
    jx = {k: jnp.asarray(v, jd_p if k in ("pk", "pv") else jd_a)
          for k, v in f.items()}
    tx = {k: torch.from_numpy(v).to(td_p if k in ("pk", "pv") else td_a)
          for k, v in f.items()}
    return jx, tx


def _np(x):
    return (x.float().numpy() if torch.is_tensor(x)
            else np.asarray(x.astype(jnp.float32)))


def _tables(idx):
    return ((jnp.asarray(HOSTILE_PT), jnp.asarray(idx)),
            (torch.from_numpy(HOSTILE_PT), torch.from_numpy(idx)))


def _lse_oracle(q, pk, pt, idx, S):
    """log-sum-exp of the reference's masked scaled scores (store mode:
    over the gathered pool after the store), (B, Hq, S)."""
    gk, valid = kref.paged_gather(pk, pt)
    gk = np.asarray(gk.astype(q.dtype).astype(jnp.float32))
    qf = np.asarray(q.astype(jnp.float32)).reshape(B, S, HKV, HQ // HKV, D)
    s = np.einsum("bqhgd,bkhd->bhgqk", qf, gk) / np.sqrt(D)
    qpos = np.asarray(idx)[:, None] + np.arange(S)
    mask = ((np.arange(gk.shape[1])[None, None] <= qpos[..., None])
            & np.asarray(valid)[:, None, :])[:, None, None]
    s = np.where(mask, s, -np.inf)
    mx = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        lse = (np.log(np.exp(s - mx).sum(-1, keepdims=True)) + mx)[..., 0]
    lse = np.where(np.isfinite(lse), lse, pref.NEG_INF)
    return lse.reshape(B, HQ, S)


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_reference_oracle(pool_dtype, act_dtype):
    jx, tx = _inputs(1, pool_dtype, act_dtype)
    (jpt, jidx), (tpt, tidx) = _tables(HOSTILE_IDX)
    want, ck, cv, cnt = kref.paged_decode_ref(
        jx["q"], jx["k"], jx["v"], jx["pk"], jx["pv"], jpt, jidx, tol=0.0)
    out, lse, pk, pv, got_cnt = pref.paged_decode_ref(
        tx["q"], tx["k"], tx["v"], tx["pk"], tx["pv"], tpt, tidx)
    assert pk is tx["pk"] and pv is tx["pv"]            # stored in place
    np.testing.assert_array_equal(_np(pk), _np(ck))
    np.testing.assert_array_equal(_np(pv), _np(cv))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(cnt))
    live = HOSTILE_IDX >= 0
    tol = 2e-5 if "bfloat16" not in (pool_dtype, act_dtype) else 2e-2
    np.testing.assert_allclose(_np(out)[live], _np(want)[live],
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(
        lse.numpy()[live], _lse_oracle(jx["q"], ck, jpt, jidx, 1)[live, :, 0],
        atol=tol, rtol=tol)
    assert lse.shape == (B, HQ) and (lse.numpy()[~live] == pref.NEG_INF).all()


@pytest.mark.parametrize("S", [1, 3, 5])
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("store", [True, False])
def test_window_plain_matches_reference_oracle(S, pool_dtype, store):
    jx, tx = _inputs(S, pool_dtype, seed=S)
    (jpt, jidx), (tpt, tidx) = _tables(HOSTILE_IDX_W)
    want, ck, cv, cnt = kref.paged_window_ref(
        jx["q"], jx["k"], jx["v"], jx["pk"], jx["pv"], jpt, jidx,
        store=store, tol=0.0)
    pool_before = _np(tx["pk"]).copy()
    out, lse, pk, pv, got_cnt = pref.paged_window_ref(
        tx["q"], tx["k"], tx["v"], tx["pk"], tx["pv"], tpt, tidx,
        store=store)
    np.testing.assert_array_equal(_np(pk), _np(ck))
    np.testing.assert_array_equal(_np(pv), _np(cv))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(cnt))
    if not store:
        np.testing.assert_array_equal(_np(pk), pool_before)
        assert got_cnt.sum() == 0
    live = HOSTILE_IDX_W >= 0
    tol = 2e-5 if pool_dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(out)[live], _np(want)[live],
                               atol=tol, rtol=tol)
    assert lse.shape == (B, HQ, S)
    if store:
        np.testing.assert_allclose(
            lse.numpy()[live], _lse_oracle(jx["q"], ck, jpt, jidx, S)[live],
            atol=tol, rtol=tol)


def test_store_counts_past_table_and_silent_restore():
    """Rows past the last mapped page count as dropped; storing what the
    pool already holds counts every element as silent (Def. 2 at tol 0);
    idle slots count nothing."""
    jx, tx = _inputs(5, "float32", seed=13)
    (jpt, jidx), (tpt, tidx) = _tables(HOSTILE_IDX_W)
    cnt = pref.paged_store_counts(tx["pk"], tx["pv"], tx["k"], tx["v"],
                                  tpt, tidx)
    want = kref.paged_store_counts(jx["pk"], jx["pv"], jx["k"], jx["v"],
                                   jpt, jidx, tol=0.0)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want))
    assert cnt[1, 2] > 0 and cnt[2].sum() == 0
    pref.paged_update(tx["pk"], tx["pv"], tx["k"], tx["v"], tpt, tidx)
    again = pref.paged_store_counts(tx["pk"], tx["pv"], tx["k"], tx["v"],
                                    tpt, tidx)
    assert torch.equal(again[:, 1], again[:, 0])         # all stored silent


def test_ops_dispatch_cpu_matches_plain_versions():
    """On CPU tensors ``ops.paged_decode``/``ops.paged_window`` are the
    plain versions (counters only when asked for)."""
    for S, fn, idx in ((1, ops.paged_decode, HOSTILE_IDX),
                       (3, ops.paged_window, HOSTILE_IDX_W)):
        _, tx = _inputs(S, "float32", seed=7)
        _, (tpt, tidx) = _tables(idx)
        _, tx2 = _inputs(S, "float32", seed=7)
        if S == 1:
            want = pref.paged_decode_ref(tx2["q"], tx2["k"], tx2["v"],
                                         tx2["pk"], tx2["pv"], tpt, tidx)
        else:
            want = pref.paged_window_ref(tx2["q"], tx2["k"], tx2["v"],
                                         tx2["pk"], tx2["pv"], tpt, tidx)
        out, ck, cv, cnt = fn(tx["q"], tx["k"], tx["v"], tx["pk"], tx["pv"],
                              tpt, tidx, counters=True)
        live = idx >= 0
        np.testing.assert_array_equal(out.numpy()[live], want[0].numpy()[live])
        assert torch.equal(ck, want[2]) and torch.equal(cv, want[3])
        assert torch.equal(cnt, want[4])
        *_, none = fn(tx["q"], tx["k"], tx["v"], tx["pk"], tx["pv"], tpt,
                      tidx, counters=False)
        assert none is None
    assert ops.COUNTER_TOL == 0.0


def test_kernels_refuse_other_devices():
    """Neither kernel entry point carries on with tensors that are on
    neither the CPU nor a CUDA device."""
    q = torch.empty((B, 1, HQ, D), device="meta")
    kv = torch.empty((B, 1, HKV, D), device="meta")
    pool = torch.empty((P, PS, HKV, D), device="meta")
    pt = torch.empty((B, M), dtype=torch.int32, device="meta")
    idx = torch.empty((B,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.paged_decode(q, kv, kv, pool, pool, pt, idx)
    with pytest.raises(ValueError):
        ops.paged_window(q, kv, kv, pool, pool, pt, idx)


@pytest.mark.parametrize("kv_len", [None, "vector", "scalar"])
def test_attention_and_small_refs_match_reference(kv_len):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    kw = {}
    if kv_len == "vector":
        kw = {"q_offset": np.array([1, 3], np.int32),
              "kv_len": np.array([4, 6], np.int32)}
    elif kv_len == "scalar":
        kw = {"q_offset": np.int32(2), "kv_len": np.int32(5)}
    want = kref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              **{n: jnp.asarray(a) for n, a in kw.items()})
    got = pref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             **{n: torch.as_tensor(a) for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    a = rng.standard_normal((5, 7)).astype(np.float32)
    b = a.copy()
    b[::2] += 1e-3
    for tol in (0.0, 0.01):
        assert int(pref.silent_compare_ref(torch.from_numpy(a),
                                           torch.from_numpy(b), tol)) == \
            int(kref.silent_compare_ref(jnp.asarray(a), jnp.asarray(b), tol))
    scale = rng.standard_normal(7).astype(np.float32)
    np.testing.assert_allclose(
        pref.rmsnorm_ref(torch.from_numpy(a), torch.from_numpy(scale)).numpy(),
        np.asarray(kref.rmsnorm_ref(jnp.asarray(a), jnp.asarray(scale))),
        atol=1e-6, rtol=1e-6)
