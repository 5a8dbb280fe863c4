"""The rest of the rarer tp_serve layouts, on gloo CPU ranks against the
reference:

* The token-loop families under tp_serve (``make_serve_step(model,
  strategy)``, as the reference's dry run lowers them): zamba2-1.2b,
  whisper-large-v3 (its cross K/V over frames without ``xvalid``) and
  llama-3.2-vision-90b at one period, their smoke configs in float32 on
  2 ranks, a cache of 1024 positions chunked over 'model' and 1024 frames
  or image tokens chunked too. Logits within 1e-5 of the largest of the
  reference's unsharded ``decode_step`` and greedy tokens equal; the
  chunked and the sharded-cross branches must have run.
* B2's defer mode on a chunk, plain version (``ref.paged_window_ref``,
  ``chunk=True``) and the tensor-core route's bf16 arithmetic
  (``test_torch_paged_split.tc_emulation``): each rank of 2 or 4 takes
  the window rows of its pages (seq-rank 0 those of unmapped pages) on a
  hostile table; the ranks' partials combined by their lse must equal
  the reference's unsharded defer call within 1e-5 (f32) / 2e-2 (bf16).
* The train driver with ``objects=True`` under dp_tp and fsdp on 2
  ranks: the replica scan at init equals the unsharded driver's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
import test_torch_paged_split as PSX
from repro_torch.kernels import ref as pref
from repro_torch.launch.mesh import launch

from _torch_parity import smoke_models

ARCHS = tuple(R.LOOP_ARCHS)
GATES = ("gate_attn", "gate_mlp")


def _set_gates(host, seed=11):
    """Every xattn block's gates at seeded non-zero values (the
    reference initialises them to zero, which hides the cross path)."""
    rng = np.random.default_rng(seed)
    for name, blk in host["main"].items():
        if name.endswith("_xattn"):
            for g in GATES:
                sign = np.where(rng.random(blk[g].shape) < 0.5, -1.0, 1.0)
                blk[g] = (sign * rng.uniform(0.3, 1.2, blk[g].shape)
                          ).astype(blk[g].dtype)
    return host


def _ref_loop(arch, host):
    """The reference's unsharded greedy loop of ``_torch_ranks.loop_run``:
    (logits (steps, B, 1, V), tokens (B, steps))."""
    ref_model = smoke_models(arch=arch, **R.LOOP_ARCHS[arch])[0]
    params = jax.tree_util.tree_map(jnp.asarray, host)
    cfg = ref_model.cfg
    toks, kw = R.loop_inputs(cfg)
    cache = ref_model.init_cache(params, R.LOOP_BATCH, R.LOOP_LEN,
                                 kv_dtype=jnp.float32,
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    dparams = ref_model.decode_params(params)
    tok = jnp.asarray(toks)
    logits, out = [], []
    for _ in range(R.LOOP_STEPS):
        lg, cache = ref_model.decode_step(dparams, cache, tok)
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.stack(logits), np.concatenate(out, axis=1)


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    hosts = {}
    for arch in ARCHS:
        host = jax.device_get(smoke_models(arch=arch,
                                           **R.LOOP_ARCHS[arch])[1])
        hosts[arch] = _set_gates(host) if "vision" in arch else host
    port = launch(R.loop_rank, (1, 2), args=(hosts,),
                  init_dir=str(tmp_path_factory.mktemp("tp_loop")))
    return {arch: _ref_loop(arch, hosts[arch]) for arch in ARCHS}, port


@pytest.mark.parametrize("arch", ARCHS)
def test_token_loop_family_under_tp_serve_matches_reference(loops, arch):
    refs, port = loops
    want_logits, want_tokens = refs[arch]
    scale = float(np.abs(want_logits).max())
    for rank in port:
        logits, tokens, calls = rank[arch]
        np.testing.assert_allclose(logits, want_logits, rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_array_equal(tokens, want_tokens)
        # the chunked self-attention ran in every attention block, the
        # sharded cross-attention in every cross block
        assert calls["dense"] > 0
        assert (calls["cross"] > 0) == ("zamba2" not in arch)


# ----------------------------------------------------------------------
# B2's defer mode on a chunk
# ----------------------------------------------------------------------
def _chunk_tables(pt, n):
    """Each of n ranks' localized table of the pool's chunk of P / n
    pages: its own pages renumbered, NOT_MINE elsewhere, and on rank 0
    UNMAPPED_MINE where the whole table is unmapped."""
    chunk = PSX.P // n
    out = []
    for r in range(n):
        lpt = pt - r * chunk
        own = (pt >= 0) & (lpt >= 0) & (lpt < chunk)
        loc = np.where(own, lpt, pref.NOT_MINE)
        if r == 0:
            loc = np.where(pt < 0, pref.UNMAPPED_MINE, loc)
        out.append(loc.astype(np.int32))
    return out


def _combine(parts):
    """The ranks' (out (B,S,Hq,D), lse (B,Hq,S)) combined by lse in rank
    order, as flash_decode._lse_combine does (a rank's empty rows 0)."""
    lse = torch.stack([lse.transpose(1, 2) for _, lse in parts]).float()
    gm = lse.amax(0)
    num = 0.0
    den = 0.0
    for (o, _), l in zip(parts, lse):
        w = torch.exp(l - gm)
        o = torch.where((l <= pref.NEG_INF)[..., None], 0.0, o.float())
        num, den = num + o * w[..., None], den + w
    out = num / den.clamp(min=1e-30)[..., None]
    live = gm > pref.NEG_INF / 2
    lse_all = torch.where(live, gm + torch.log(den), pref.NEG_INF)
    return out, lse_all.transpose(1, 2)


def _chunk_keys(tx, pt, i0, b, h, store):
    """test_torch_paged_split._keys under the defer-on-a-chunk rule: the
    window rows whose page entry is not NOT_MINE (``store`` is False)."""
    hist, rows, _, _, _ = _plain_keys(tx, pt, i0, b, h, store)
    act, pool = tx["q"].dtype, tx["pk"].dtype
    S = tx["q"].shape[1]
    win = [c for c in range(S) if 0 <= i0 + c < PSX.M * PSX.PS
           and pt[b, (i0 + c) // PSX.PS] != pref.NOT_MINE]
    wk = tx["k"][b, win, h].to(pool).to(act).float()
    wv = tx["v"][b, win, h].to(pool).to(act).float()
    return hist, rows, win, wk, wv


_plain_keys = PSX._keys


def _chunk_inputs(tx, r, n):
    chunk = PSX.P // n
    return {**tx, "pk": tx["pk"][r * chunk:(r + 1) * chunk],
            "pv": tx["pv"][r * chunk:(r + 1) * chunk]}


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("act,pool,shape", PSX._with_granite(PSX.PAIRS))
def test_defer_on_chunks_plain_matches_unsharded_reference(act, pool, shape,
                                                           n):
    """W = 5 windows at W5_IDX (one crossing onto an unmapped page at the
    table's end, one idle) on a hostile table, chunked over n ranks: the
    plain version's partials combined equal the reference's unsharded
    defer call (f32 within 1e-5; bf16 activations within 2e-2)."""
    jx, tx = PSX._inputs(5, act, pool, seed=7, shape=shape)
    pt = PSX._table(1)
    want_out, want_lse = PSX._oracle(jx, tx, pt, PSX.W5_IDX, 5, False)
    idx = torch.from_numpy(PSX.W5_IDX)
    parts = []
    for r, loc in enumerate(_chunk_tables(pt, n)):
        c = _chunk_inputs(tx, r, n)
        out, lse, _, _, cnt = pref.paged_window_ref(
            c["q"], c["k"], c["v"], c["pk"].clone(), c["pv"].clone(),
            torch.from_numpy(loc), idx, store=False, chunk=True)
        assert not cnt.any()
        parts.append((out, lse))
    out, lse = _combine(parts)
    PSX._check((out.to(tx["q"].dtype), lse), want_out, want_lse,
               PSX.W5_IDX, act)
    # the unmapped-page rows count once: on rank 0 only
    loc0 = _chunk_tables(pt, n)[0]
    assert (loc0 == pref.UNMAPPED_MINE).any()


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("pool,shape", PSX._with_granite(["float32",
                                                         "bfloat16"]))
def test_defer_on_chunks_tensor_core_rounding(monkeypatch, pool, shape, n):
    """The tensor-core route's arithmetic (bf16 activations, the verify
    width: one row tile, its history split by page index) on each rank's
    chunk under the defer-on-a-chunk rule, combined: within the bf16
    tolerance of the reference's unsharded defer call."""
    monkeypatch.setattr(PSX, "_keys", _chunk_keys)
    jx, tx = PSX._inputs(5, "bfloat16", pool, seed=8, shape=shape)
    pt = PSX._table(3)
    want_out, want_lse = PSX._oracle(jx, tx, pt, PSX.W5_IDX, 5, False)
    parts = []
    for r, loc in enumerate(_chunk_tables(pt, n)):
        c = _chunk_inputs(tx, r, n)
        parts.append(PSX.tc_emulation(c, loc, PSX.W5_IDX, store=False))
    out, lse = _combine(parts)
    PSX._check((out.to(torch.bfloat16), lse), want_out, want_lse,
               PSX.W5_IDX, "bfloat16")


# ----------------------------------------------------------------------
# The object registry under a training strategy
# ----------------------------------------------------------------------
def test_train_object_scan_under_strategies_matches_unsharded(tmp_path):
    from repro_torch.launch import train
    _, prof = train.run("qwen3-1.7b", smoke=True, steps=1, batch=4, seq=32,
                        device="cpu", objects=True)
    want = R.scan_of(prof)
    assert want
    got = launch(R.objects_rank, (1, 2), args=(("dp_tp", "fsdp"),),
                 init_dir=str(tmp_path))
    for rank in got:
        assert rank == {"dp_tp": want, "fsdp": want}
