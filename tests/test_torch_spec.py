"""Speculative decoding of the PyTorch port against the reference, on the
CPU, on the qwen3 smoke config in float32 with the same weights
(``from_reference``).

Integer results must match exactly: generated tokens, the engine's spec
counters (``spec_ticks``, ``draft_proposed``, ``draft_accepted``,
``verified_positions``) and every other non-wall-clock stat, page tables,
the drafters' proposals, the paged store counters with a row budget, and
the tier-3 ``rejected_draft_store`` / tier-4
``kernel_rejected_draft_store`` checked and flagged counts. After a
rollback commit the same pool rows hold new values as in the reference,
within 1e-5 of its values (float32 K/V computed in other summation
orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ProfilerConfig as RefProfilerConfig
from repro.core.detectors import ServingDetectors as RefDetectors
from repro.kernels import ref as kref
from repro.serve import spec as ref_spec
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.configs.base import ProfilerConfig
from repro_torch.core.detectors import ServingDetectors
from repro_torch.kernels import ref as pref
from repro_torch.kernels.paged_verify import paged_verify_attention
from repro_torch.serve import spec as pt_spec
from repro_torch.serve.engine import Request, ServeEngine

from _torch_parity import smoke_models, to_np

WALL_CLOCK = ("prefill_s", "decode_s", "draft_s", "verify_s")


def _workload(cfg):
    """(rid, tokens, max_new_tokens, arrival): staggered arrivals and a
    late exact duplicate of the first prompt (its donor's served sequence
    drafts it from the n-gram corpus). On this seed the n-gram drafter
    is accepted in part, so overwrite runs store rejected drafts."""
    rng = np.random.RandomState(1)
    p0 = rng.randint(0, cfg.vocab_size, size=8).astype(np.int32)
    p1 = rng.randint(0, cfg.vocab_size, size=5).astype(np.int32)
    p2 = rng.randint(0, cfg.vocab_size, size=6).astype(np.int32)
    return [("q0", p0, 10, 0), ("q1", p1, 9, 0), ("q2", p2, 6, 1),
            ("q3", p0.copy(), 8, 5)]


def _engines(kind, kv, rollback, *, kernel_counters=False):
    """The reference and the port engine run the same workload with the
    same drafter kind; returns (ref engine, port engine, ref det, port
    det)."""
    ref_model, ref_params, pt_model, pt_params = smoke_models()
    reqs = _workload(pt_model.cfg)

    def drafter(pkg, model, params, engine_cls, request_cls):
        if kind == "oracle":
            plain = engine_cls(model, params, num_slots=2, max_len=24,
                               kv_layout=kv, page_size=4)
            for rid, toks, gen, arr in reqs:
                plain.submit(request_cls(rid=rid, tokens=toks.copy(),
                                         max_new_tokens=gen, arrival=arr))
            plain.run(max_steps=200)
            return pkg.make_drafter("oracle", sequences=[
                np.concatenate([toks, np.asarray(
                    plain.finished[rid].generated, np.int32)])
                for rid, toks, _, _ in reqs])
        return pkg.make_drafter(kind, model=model, params=params)

    out = []
    for pkg, model, params, engine_cls, request_cls, det_cls, pc_cls in (
            (ref_spec, ref_model, ref_params, RefEngine, RefRequest,
             RefDetectors, RefProfilerConfig),
            (pt_spec, pt_model, pt_params, ServeEngine, Request,
             ServingDetectors, ProfilerConfig)):
        det = det_cls(pc_cls(enabled=True, num_watchpoints=8, seed=0),
                      sites_per_step=4)
        kw = {"kv_dtype": jnp.float32 if engine_cls is RefEngine
              else torch.float32}
        eng = engine_cls(model, params, num_slots=2, max_len=24,
                         detectors=det, kv_layout=kv, page_size=4,
                         drafter=drafter(pkg, model, params, engine_cls,
                                         request_cls),
                         spec_k=3, spec_rollback=rollback,
                         kernel_counters=kernel_counters, **kw)
        for rid, toks, gen, arr in reqs:
            eng.submit(request_cls(rid=rid, tokens=toks.copy(),
                                   max_new_tokens=gen, arrival=arr))
        eng.run(max_steps=200)
        out.append((eng, det))
    (ref, ref_det), (pt, pt_det) = out
    return ref, pt, ref_det, pt_det


def _assert_same_profile(ref_prof, pt_prof):
    assert pt_prof.tiers == ref_prof.tiers
    assert pt_prof.checked == ref_prof.checked
    assert pt_prof.flagged == ref_prof.flagged
    ref_f = {f.key: f for f in ref_prof.findings}
    pt_f = {f.key: f for f in pt_prof.findings}
    assert sorted(pt_f) == sorted(ref_f)
    for key, f in ref_f.items():
        assert (pt_f[key].count, pt_f[key].bytes) == (f.count, f.bytes), key


CASES = [("dense", False), ("paged", False), ("paged", True)]


@pytest.mark.parametrize("kv,rollback", CASES)
@pytest.mark.parametrize("kind", ["ngram", "oracle", "lm"])
def test_spec_engine_matches_reference(kind, kv, rollback):
    """Tokens, stats (spec counters included), page tables and the
    tier-3 report (``rejected_draft_store`` with the sampled kinds) equal
    the reference's; on the paged layout with kernel counters on, the
    tier-4 report (``kernel_rejected_draft_store`` included) too."""
    paged = kv == "paged"
    ref, pt, ref_det, pt_det = _engines(kind, kv, rollback,
                                        kernel_counters=paged)
    assert sorted(pt.finished) == sorted(ref.finished)
    for rid, req in ref.finished.items():
        assert pt.finished[rid].generated == req.generated, rid
    for key, value in pt.stats.items():
        if key not in WALL_CLOCK:
            assert value == ref.stats[key], key
    assert pt.stats["spec_ticks"] > 0
    if paged:
        np.testing.assert_array_equal(pt.kv.pt, ref.kv.pt)
        pt.kv.check()
        _assert_same_profile(ref_det.kernel, pt_det.kernel)
        checked = pt_det.kernel.checked["kernel_rejected_draft_store"]
        assert checked == pt.stats["draft_proposed"] > 0
    _assert_same_profile(ref_det.report, pt_det.report)
    assert pt_det.report.checked.get("rejected_draft_store", 0) > 0
    tp = pt.throughput()
    assert set(tp) >= {"verify_tok_s", "draft_tok_s", "accept_rate"}
    if kind in ("oracle", "lm"):
        # the replayed plain continuation and the target drafting for
        # itself are always accepted
        assert pt.stats["draft_accepted"] == pt.stats["draft_proposed"]
        assert tp["accept_rate"] == 1.0
        assert pt_det.report.flagged.get("rejected_draft_store", 0) == 0
    if paged:
        rejected = pt.stats["draft_proposed"] - pt.stats["draft_accepted"]
        flagged = pt_det.kernel.flagged.get("kernel_rejected_draft_store",
                                            0)
        assert flagged == (0 if rollback else rejected)


def test_spec_outputs_equal_plain_decode_and_rejections_happen():
    """Inside the port: every speculative mode emits plain greedy
    decode's tokens, and the n-gram drafter on this workload is partly
    rejected, so the overwrite runs do store rejected drafts."""
    _, _, pt_model, pt_params = smoke_models()
    reqs = _workload(pt_model.cfg)

    def serve(kv, drafter=None, rollback=True):
        eng = ServeEngine(pt_model, pt_params, num_slots=2, max_len=24,
                          kv_layout=kv, page_size=4, drafter=drafter,
                          spec_k=3, spec_rollback=rollback)
        for rid, toks, gen, arr in reqs:
            eng.submit(Request(rid=rid, tokens=toks.copy(),
                               max_new_tokens=gen, arrival=arr))
        eng.run(max_steps=200)
        return {rid: r.generated for rid, r in eng.finished.items()}, eng
    base, _ = serve("dense")
    for kv, rollback in CASES:
        out, eng = serve(kv, pt_spec.NGramDrafter(), rollback)
        assert out == base, (kv, rollback)
        assert 0 < eng.stats["draft_accepted"] < eng.stats["draft_proposed"]


def _paged_setup(seed=0):
    """A paged cache holding a 5- and a 7-token prompt (pages 4 rows, a
    shuffled table), in both packages, with the same weights."""
    ref_model, ref_params, pt_model, pt_params = smoke_models()
    rng = np.random.RandomState(seed)
    pt_np = np.array([[5, 1, 6, 3, -1, -1], [2, 7, 0, 4, -1, -1]],
                     np.int32)
    toks = rng.randint(0, pt_model.cfg.vocab_size, size=(2, 8)) \
        .astype(np.int32)
    lengths = np.array([5, 7], np.int32)
    rc = ref_model.init_paged_cache(ref_params, 2, 24, page_size=4,
                                    num_pages=8, kv_dtype=jnp.float32,
                                    kernel_counters=True)
    rc = ref_model.with_page_table(rc, jnp.asarray(pt_np))
    rc = ref_model.with_cache_index(rc, jnp.zeros(2, jnp.int32))
    _, rc = ref_model.prefill(ref_params, rc, jnp.asarray(toks),
                              lengths=jnp.asarray(lengths))
    pc = pt_model.init_paged_cache(pt_params, 2, 24, page_size=4,
                                   num_pages=8, kv_dtype=torch.float32,
                                   kernel_counters=True)
    pc = pt_model.with_page_table(pc, torch.as_tensor(pt_np))
    pc = pt_model.with_cache_index(pc, torch.zeros(2, dtype=torch.int32))
    _, pc = pt_model.prefill(pt_params, pc, torch.as_tensor(toks),
                             lengths=torch.as_tensor(lengths))
    return (ref_model, ref_params, rc), (pt_model, pt_params, pc), lengths


def test_verify_defer_equals_overwrite_logits_and_leaves_pool():
    """The port's verify forward in defer mode gives overwrite mode's
    logits bit for bit (the window rows make the pool-dtype round trip),
    leaves the pools untouched, carries the window K/V and zero counters;
    both modes' logits equal the reference's within f32 noise."""
    (ref_model, ref_params, rc), (pt_model, pt_params, pc), lengths = \
        _paged_setup()
    window = np.random.RandomState(1).randint(
        0, pt_model.cfg.vocab_size, size=(2, 4)).astype(np.int32)
    sub = pc["main"]["b0_dense"]
    before = (sub["k"].clone(), sub["v"].clone())
    lg_d, cd = pt_model.verify(pt_params, pc, torch.as_tensor(window),
                               commit=False)
    sd = cd["main"]["b0_dense"]
    assert torch.equal(sd["k"], before[0]) and torch.equal(sd["v"],
                                                           before[1])
    assert int(sd["kcnt"].abs().sum()) == 0
    n = pt_model.sched.n_super
    assert sd["win_k"].shape == (n, 2, 4, pt_model.cfg.num_kv_heads,
                                 pt_model.cfg.head_dim)
    np.testing.assert_array_equal(to_np(sd["idx"][0]), lengths + 4)
    lg_o, _ = pt_model.verify(pt_params, pc, torch.as_tensor(window),
                              commit=True)
    assert torch.equal(lg_d, lg_o)
    lg_r, _ = ref_model.verify(ref_params, rc, jnp.asarray(window),
                               commit=False)
    np.testing.assert_allclose(to_np(lg_d), np.asarray(lg_r), atol=1e-4,
                               rtol=1e-4)


def test_commit_verify_stores_exactly_the_accepted_prefix():
    """After a deferred verify, ``commit_verify(start, length)`` stores
    rows [0, length) of each slot's window and nothing else: the same
    pool rows change as in the reference, to the reference's values
    within 1e-5 (the K/V rows are computed in f32 in other summation
    orders), the commit's kernel counters equal the reference's, and
    every pool row outside the committed positions is what it was."""
    (ref_model, ref_params, rc), (pt_model, pt_params, pc), lengths = \
        _paged_setup()
    window = np.random.RandomState(2).randint(
        0, pt_model.cfg.vocab_size, size=(2, 4)).astype(np.int32)
    keep = np.array([2, 0], np.int32)          # slot 1: idle, nothing
    rc_pre = rc
    _, rc = ref_model.verify(ref_params, rc, jnp.asarray(window),
                             commit=False)
    rc = ref_model.commit_verify(rc, jnp.asarray(lengths),
                                 jnp.asarray(keep))
    sub = pc["main"]["b0_dense"]
    before = sub["k"].clone()
    ref_before = np.asarray(rc_pre["main"]["b0_dense"]["k"])
    _, pc = pt_model.verify(pt_params, pc, torch.as_tensor(window),
                            commit=False)
    pc = pt_model.commit_verify(pc, torch.as_tensor(lengths),
                                torch.as_tensor(keep))
    rs, ps = rc["main"]["b0_dense"], pc["main"]["b0_dense"]
    assert "win_k" not in ps and "win_v" not in ps
    for key in ("k", "v"):
        np.testing.assert_allclose(to_np(ps[key]), np.asarray(rs[key]),
                                   atol=1e-5, rtol=0)
    np.testing.assert_array_equal(to_np(ps["kcnt"]), np.asarray(rs["kcnt"]))
    cnt = to_np(ps["kcnt"])
    row = 2 * pt_model.cfg.num_kv_heads * pt_model.cfg.head_dim
    assert (cnt[:, 0, 0] == 2 * row).all() and (cnt[:, 1] == 0).all()
    # slot 0 wrote positions 5 and 6: page pt[0, 1] = 1, offsets 1 and 2
    changed = (ps["k"] != before).any(dim=(0, 3, 4))      # (P, page)
    ref_changed = (np.asarray(rs["k"]) != ref_before).any(axis=(0, 3, 4))
    assert sorted(map(tuple, changed.nonzero().tolist())) == [(1, 1), (1, 2)]
    np.testing.assert_array_equal(changed.numpy(), ref_changed)


@pytest.mark.parametrize("S", [1, 5])
def test_paged_update_and_store_counts_with_length(S):
    """``paged_update``/``paged_store_counts`` with a row budget equal the
    reference's on a hostile table (unmapped pages, an idle slot, budgets
    0, partial and past the window)."""
    rng = np.random.default_rng(S)
    P, ps, Hkv, D, B = 8, 4, 2, 8, 4
    pk = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    pv = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    k[:, ::2] = pk[1, 0]                 # some rows restore pool values
    table = np.array([[5, 1, -1], [2, 7, 0], [3, 4, 6], [-1, -1, -1]],
                     np.int32)
    idx = np.array([2, 6, 9, -(S + 1)], np.int32)
    length = np.array([S, max(S - 3, 1), 0, S], np.int32)
    want_c = kref.paged_store_counts(*map(jnp.asarray, (pk, pv, k, v)),
                                     jnp.asarray(table), jnp.asarray(idx),
                                     length=jnp.asarray(length), tol=0.0)
    want_k, want_v = kref.paged_update(
        *map(jnp.asarray, (pk, pv, k, v)), jnp.asarray(table),
        jnp.asarray(idx), length=jnp.asarray(length))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    args = (torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(table), torch.from_numpy(idx))
    cnt = pref.paged_store_counts(tk, tv, *args,
                                  length=torch.from_numpy(length))
    pref.paged_update(tk, tv, *args, length=torch.from_numpy(length))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(want_v))
    assert cnt[2].sum() == 0 and cnt[3].sum() == 0


@pytest.mark.parametrize("mode", ["overwrite", "defer"])
def test_paged_verify_wrapper_modes(mode):
    """The verify wrapper is the window kernel's function in store
    (overwrite) or defer mode: on CPU tensors it equals the plain window
    version; a mode it does not know raises."""
    rng = np.random.default_rng(0)
    B, W, Hq, Hkv, D, P, ps = 3, 5, 4, 2, 8, 8, 4

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))
    q, k, v = t(B, W, Hq, D), t(B, W, Hkv, D), t(B, W, Hkv, D)
    pk, pv = t(P, ps, Hkv, D), t(P, ps, Hkv, D)
    table = torch.tensor([[5, 1, 6, -1], [2, 7, -1, -1], [-1] * 4],
                         dtype=torch.int32)
    idx = torch.tensor([3, 6, -(W + 1)], dtype=torch.int32)
    kk, kv_ = pk.clone(), pv.clone()
    out, lse, cnt, _, _ = paged_verify_attention(q, k, v, kk, kv_, table,
                                                 idx, mode=mode)
    rk, rv = pk.clone(), pv.clone()
    w_out, w_lse, _, _, w_cnt = pref.paged_window_ref(
        q, k, v, rk, rv, table, idx, store=mode == "overwrite")
    assert torch.equal(kk, rk) and torch.equal(kv_, rv)
    assert torch.equal(cnt, w_cnt)
    assert torch.equal(out[:2], w_out[:2]) and torch.equal(lse, w_lse)
    if mode == "defer":
        assert torch.equal(kk, pk) and int(cnt.abs().sum()) == 0
    with pytest.raises(ValueError):
        paged_verify_attention(q, k, v, kk, kv_, table, idx, mode="store")


def test_drafters_propose_like_reference():
    """The same histories give the same proposals: n-gram self-lookup
    and corpus lookup (most recent first, flush matches skipped), the
    replay oracle's prefix semantics, and the draft LM's greedy tokens
    on the same weights."""
    rng = np.random.RandomState(7)
    ref_ng, pt_ng = ref_spec.NGramDrafter(), pt_spec.NGramDrafter()
    seqs = [rng.randint(0, 6, size=n).astype(np.int32)
            for n in (12, 30, 9, 17)]
    for s in seqs[:2]:
        ref_ng.observe(s)
        pt_ng.observe(s)
    ref_rp = ref_spec.ReplayDrafter(seqs[:3])
    pt_rp = pt_spec.ReplayDrafter(seqs[:3])
    hists = [rng.randint(0, 6, size=n).astype(np.int32)
             for n in (1, 2, 3, 5, 8, 13, 21)] + [s[:7] for s in seqs]
    for hist in hists:
        for k in (0, 1, 3, 5):
            for ref_d, pt_d in ((ref_ng, pt_ng), (ref_rp, pt_rp)):
                want = ref_d.propose(hist, k)
                got = pt_d.propose(hist, k)
                assert got.dtype == np.int32
                np.testing.assert_array_equal(got, want)
    ref_model, ref_params, pt_model, pt_params = smoke_models()
    ref_lm = ref_spec.LMDrafter(ref_model, ref_params)
    pt_lm = pt_spec.LMDrafter(pt_model, pt_params)
    for hist in (seqs[2] % pt_model.cfg.vocab_size, seqs[3][:5]):
        np.testing.assert_array_equal(pt_lm.propose(hist, 3),
                                      ref_lm.propose(hist, 3))
    assert pt_lm.propose(np.zeros(0, np.int32), 3).size == 0
    with pytest.raises(ValueError):
        pt_spec.make_drafter("draft")
    with pytest.raises(ValueError):
        pt_spec.make_drafter("lm")


@pytest.mark.parametrize("draft,rollback", [("ngram", True),
                                            ("ngram", False),
                                            ("oracle", False)])
def test_launch_serve_spec_matches_reference(draft, rollback, monkeypatch):
    """``launch.serve.run --spec on`` in the port gives the reference
    driver's tokens and stats on the same weights and prompts (the oracle
    run also asserts, inside the driver, that it equals plain decode)."""
    from repro.launch import serve as ref_serve
    from repro_torch.configs import registry as pt_registry
    from repro_torch.launch import serve as pt_serve
    from repro_torch.models import lm as pt_lm

    ref_model, ref_params, pt_model, pt_params = smoke_models()
    monkeypatch.setattr(pt_registry, "get_config",
                        lambda arch: pt_model.cfg)
    monkeypatch.setattr(pt_lm.LM, "init",
                        lambda self, seed=0, **kw: pt_params)
    out, merged, stats = pt_serve.run(
        "qwen3-1.7b", batch=2, prompt_len=8, gen=12, kv="paged",
        spec=True, spec_k=3, draft=draft, spec_rollback=rollback,
        profile=True, device="cpu")
    prompts = jnp.asarray(ref_serve.batch_at(
        ref_model.cfg, 2, 8, seed=0, step=0)["tokens"])
    ref_out, ref_tp, _, _, ref_stats = ref_serve._run_engine(
        ref_model.cfg, ref_model, ref_params, prompts, 12, 0, False,
        kv="paged", spec=True, spec_k=3, draft=draft,
        spec_rollback=rollback)
    np.testing.assert_array_equal(out, np.asarray(ref_out))
    for key, value in ref_stats.items():
        if key in stats and key not in WALL_CLOCK:
            assert stats[key] == value, key
    assert stats["accept_rate"] == ref_tp["accept_rate"]
    assert stats["draft_proposed"] > 0
    assert merged.checked["kernel_rejected_draft_store"] == \
        stats["draft_proposed"]
    assert merged.flagged.get("kernel_rejected_draft_store", 0) == (
        0 if rollback else stats["draft_proposed"] - stats["draft_accepted"])
