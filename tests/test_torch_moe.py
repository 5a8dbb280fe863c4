"""The MoE family of the PyTorch port against the reference, on the CPU:
the MoE layer (``models/moe.py``: routing, both dispatches,
``dispatch_stats``, regrouping), the moe block in the LM (loss and
``moe_aux``), and granite-moe-3b-a800m's smoke config served through
the engine (dense and paged KV, duplicated-prefix traffic with idle
slots, speculative decoding with rollback and overwrite) and the serve
driver, on the reference's weights (``from_reference``).

Integer results must match exactly: expert choices, capacity slots, the
keep mask and the capacity, ``dispatch_stats``, greedy tokens, engine
stats, page tables, store counters and findings. Float tolerances:
gates and aux within 1e-6 (f32 softmax and sums in other orders), the
layer's output within 1e-5 of its largest magnitude under either
dispatch (the combine's sum over k is not bitwise in either framework),
``LM.loss``'s nll and ``moe_aux`` within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import ProfilerConfig as RefProfilerConfig
from repro.core.detectors import ServingDetectors as RefDetectors
from repro.models import moe as ref_moe
from repro.models.zoo import build_model as ref_build
from repro.models.zoo import count_params_analytic as ref_count
from repro.serve import spec as ref_spec
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.configs import registry as pt_registry
from repro_torch.configs.base import ProfilerConfig
from repro_torch.core.detectors import ServingDetectors
from repro_torch.models import moe as pt_moe
from repro_torch.models.params import from_reference
from repro_torch.models.zoo import count_params_analytic as pt_count
from repro_torch.serve import spec as pt_spec
from repro_torch.serve.engine import Request, ServeEngine

from _torch_parity import smoke_models, to_np

GRANITE, LLAMA4 = "granite-moe-3b-a800m", "llama4-scout-17b-a16e"
WALL_CLOCK = ("prefill_s", "decode_s", "draft_s", "verify_s")
# the granite smoke config as is (G = Hq/Hkv = 2) and at the full
# config's G = 3
HEADS = {"G2": {}, "G3": {"num_heads": 6, "num_kv_heads": 2}}


def _layer_params(arch, seed=0, **moe):
    """(ref cfg, port cfg, ref layer-0 MoE params, port copy): the smoke
    config with ``moe`` fields replaced, float32."""
    rc = ref_registry.get_config(arch).smoke()
    pc = pt_registry.get_config(arch).smoke()
    rc = dataclasses.replace(rc, dtype="float32",
                             moe=dataclasses.replace(rc.moe, **moe))
    pc = dataclasses.replace(pc, dtype="float32",
                             moe=dataclasses.replace(pc.moe, **moe))
    params = jax.device_get(ref_build(rc).init(jax.random.PRNGKey(seed)))
    pm = jax.tree.map(lambda a: np.asarray(a[0]),
                      params["main"]["b0_moe"]["moe"])
    return rc, pc, pm, from_reference(pm, device="cpu")


def _tokens(cfg, shape, seed=1):
    x = np.random.RandomState(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    return x


LAYER_CASES = [(arch, cf) for arch in (GRANITE, LLAMA4)
               for cf in (1.25, 0.25)]


@pytest.mark.parametrize("arch,cf", LAYER_CASES)
def test_route_matches_reference(arch, cf):
    """Expert choices, capacity slots, keep mask and capacity equal the
    reference's exactly; gates and aux within 1e-6. Ties in the router
    probabilities (equal rows) break toward the lower expert, as
    ``jax.lax.top_k`` breaks them."""
    rc, pc, pm_r, pm_p = _layer_params(arch, capacity_factor=cf)
    x = _tokens(rc, (3, 256))
    x[1, 7:40] = x[0, 3]              # equal rows: ties in priority order
    x[2, 5:9] = 0.0                   # zero rows: all-equal probabilities
    want = ref_moe._route(pm_r, rc, jnp.asarray(x))
    got = pt_moe._route(pm_p, pc, torch.from_numpy(x))
    idx_r, keep_gate_r, pos_r, keep_r, c_r, aux_r = want
    idx_p, keep_gate_p, pos_p, keep_p, c_p, aux_p = got
    np.testing.assert_array_equal(to_np(idx_p), np.asarray(idx_r))
    np.testing.assert_array_equal(to_np(pos_p), np.asarray(pos_r))
    np.testing.assert_array_equal(to_np(keep_p), np.asarray(keep_r))
    assert c_p == c_r
    np.testing.assert_allclose(to_np(keep_gate_p), np.asarray(keep_gate_r),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(aux_p), float(aux_r), atol=1e-6,
                               rtol=1e-6)
    if cf < 1:
        assert not bool(keep_p.all())     # tokens drop
    top = pt_moe.top_k(torch.zeros(2, 5), 3)[1]
    np.testing.assert_array_equal(top.numpy(), [[0, 1, 2], [0, 1, 2]])


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("arch,cf", LAYER_CASES)
def test_apply_moe_matches_reference(arch, cf, dispatch):
    """The layer's output within 1e-5 of its largest magnitude and aux
    within 1e-6 of the reference's, in float32, under both dispatches and
    at a capacity factor of 0.25 (tokens drop). llama4's smoke config
    covers the shared expert and top-1."""
    rc, pc, pm_r, pm_p = _layer_params(arch, capacity_factor=cf,
                                       dispatch=dispatch)
    x = _tokens(rc, (4, 128))         # 512 tokens: 2 groups of 256
    out_r, aux_r = ref_moe.apply_moe(pm_r, rc, jnp.asarray(x))
    out_p, aux_p = pt_moe.apply_moe(pm_p, pc, torch.from_numpy(x))
    assert out_p.shape == x.shape and out_p.dtype == torch.float32
    scale = float(np.abs(np.asarray(out_r)).max())
    np.testing.assert_allclose(to_np(out_p), np.asarray(out_r),
                               atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(float(aux_p), float(aux_r), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
@pytest.mark.parametrize("arch,cf", LAYER_CASES)
def test_dispatch_stats_equal_reference(arch, cf, dispatch):
    """``dispatch_stats`` returns the reference's dict exactly: every row
    stored and the unrouted ones dead under einsum (some, while capacity
    is left over), none dead under scatter."""
    rc, pc, pm_r, pm_p = _layer_params(arch, capacity_factor=cf,
                                       dispatch=dispatch)
    x = _tokens(rc, (4, 50), seed=3)   # 200 tokens: one group of 200
    want = ref_moe.dispatch_stats(pm_r, rc, jnp.asarray(x))
    got = pt_moe.dispatch_stats(pm_p, pc, torch.from_numpy(x))
    assert got == want
    if dispatch == "scatter":
        assert got["dead_rows"] == 0 and got["dead_fraction"] == 0.0
    else:
        assert got["dead_rows"] == got["rows_total"] - got["rows_routed"]
        assert (got["dead_rows"] > 0) == (cf > 1)


@pytest.mark.parametrize("shape", [(3, 100), (1, 300)])
def test_token_count_that_cannot_regroup_raises_in_both(shape):
    """300 tokens are not a multiple of the 256-token group: the
    reference's reshape fails, and so does the port (no padding)."""
    rc, pc, pm_r, pm_p = _layer_params(GRANITE)
    x = _tokens(rc, shape)
    with pytest.raises(TypeError):
        ref_moe.apply_moe(pm_r, rc, jnp.asarray(x))
    with pytest.raises(ValueError):
        pt_moe.apply_moe(pm_p, pc, torch.from_numpy(x))
    with pytest.raises(ValueError):
        pt_moe.dispatch_stats(pm_p, pc, torch.from_numpy(x))


@pytest.mark.parametrize("arch", [GRANITE, LLAMA4])
def test_param_tree_and_counts_equal_reference(arch):
    """The moe tree (router, stacked (L, E, d, f) experts, llama4's shared
    expert) loads 1:1 from the reference's init, and the analytic counts
    (total and active) equal the reference's at the published width."""
    ref_model, ref_params, pt_model, pt_params = smoke_models(arch=arch)
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    decl = pt_model.decl()
    for path, leaf in ref_leaves:
        keys = [p.key for p in path]
        got, d = pt_params, decl
        for k in keys:
            got, d = got[k], d[k]
        assert tuple(got.shape) == leaf.shape == d.shape, keys
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    moe = pt_params["main"]["b0_moe"]["moe"]
    cfg = pt_model.cfg
    assert tuple(moe["w_up"].shape) == (cfg.num_layers, cfg.moe.num_experts,
                                        cfg.d_model, cfg.moe.expert_d_ff)
    assert ("shared" in moe) == cfg.moe.shared_expert
    full = pt_registry.get_config(arch)
    for active in (False, True):
        assert pt_count(full, active_only=active) == ref_count(
            ref_registry.get_config(arch), active_only=active)


@pytest.mark.parametrize("arch", [GRANITE, LLAMA4])
def test_lm_loss_and_moe_aux_match_reference(arch):
    """``LM.loss`` (nll and the aux summed over the layers) and
    ``LM.forward``'s logits within 1e-5 of the reference's, float32."""
    ref_model, ref_params, pt_model, pt_params = smoke_models(arch=arch)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, pt_model.cfg.vocab_size, size=(2, 64))
    labels = rng.randint(0, pt_model.cfg.vocab_size, size=(2, 64))
    loss_r, m_r = ref_model.loss(ref_params, {
        "tokens": jnp.asarray(toks, jnp.int32),
        "labels": jnp.asarray(labels, jnp.int32)})
    loss_p, m_p = pt_model.loss(pt_params, {
        "tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)})
    for a, b in ((loss_p, loss_r), (m_p["nll"], m_r["nll"]),
                 (m_p["moe_aux"], m_r["moe_aux"])):
        np.testing.assert_allclose(float(a), float(b), atol=1e-5, rtol=1e-5)
    assert float(m_p["moe_aux"]) > 0
    lg_r, aux_r = ref_model.forward(ref_params, jnp.asarray(toks, jnp.int32))
    lg_p, aux_p = pt_model.forward(pt_params, torch.as_tensor(toks))
    np.testing.assert_allclose(to_np(lg_p), np.asarray(lg_r), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux_p), float(aux_r), atol=1e-5,
                               rtol=1e-5)


# ----------------------------------------------------------------------
# granite smoke through the engine
# ----------------------------------------------------------------------
def _dup_requests(cfg):
    """(rid, tokens, max_new_tokens, arrival): more requests than slots
    sharing a 10-token prefix (w0's whole prompt: a partial page, copied
    on write), staggered arrivals, so slots idle and recycle and prefill
    groups carry padded positions and non-admitted rows."""
    rng = np.random.RandomState(11)
    shared = rng.randint(0, cfg.vocab_size, size=10).astype(np.int32)
    reqs = []
    for i, (tail, gen, arr) in enumerate([(0, 3, 0), (6, 6, 0), (4, 2, 1),
                                          (3, 4, 2), (5, 3, 3)]):
        toks = np.concatenate([shared, rng.randint(
            1, cfg.vocab_size, size=tail).astype(np.int32)])
        reqs.append((f"w{i}", toks, gen, arr))
    return reqs


def _spec_requests(cfg):
    """Staggered arrivals and a late exact duplicate of the first prompt,
    whose donor's served sequence drafts it from the n-gram corpus."""
    rng = np.random.RandomState(1)
    p0 = rng.randint(0, cfg.vocab_size, size=8).astype(np.int32)
    p1 = rng.randint(0, cfg.vocab_size, size=5).astype(np.int32)
    p2 = rng.randint(0, cfg.vocab_size, size=6).astype(np.int32)
    return [("q0", p0, 10, 0), ("q1", p1, 9, 0), ("q2", p2, 6, 1),
            ("q3", p0.copy(), 8, 5)]


def _serve_both(heads, kv, *, spec=None, rollback=True, moe=None):
    """The reference and the port engine on granite smoke (float32, the
    same weights), detectors on, kernel counters on when paged; ``spec``
    names a drafter kind. Returns ((ref engine, ref det), (port engine,
    port det))."""
    overrides = dict(HEADS[heads])
    if moe:
        cfg = pt_registry.get_config(GRANITE).smoke()
        overrides["moe"] = dataclasses.replace(cfg.moe, **moe)
    ref_model, ref_params, pt_model, pt_params = smoke_models(
        arch=GRANITE, **overrides)
    reqs = (_spec_requests if spec else _dup_requests)(pt_model.cfg)
    out = []
    for pkg, model, params, engine_cls, request_cls, det_cls, pc_cls, kvd \
            in ((ref_spec, ref_model, ref_params, RefEngine, RefRequest,
                 RefDetectors, RefProfilerConfig, jnp.float32),
                (pt_spec, pt_model, pt_params, ServeEngine, Request,
                 ServingDetectors, ProfilerConfig, torch.float32)):
        det = det_cls(pc_cls(enabled=True, num_watchpoints=8, seed=0),
                      sites_per_step=4)
        drafter = (pkg.make_drafter(spec, model=model, params=params)
                   if spec else None)
        eng = engine_cls(model, params, num_slots=2, max_len=24,
                         detectors=det, kv_dtype=kvd, kv_layout=kv,
                         page_size=4, kernel_counters=kv == "paged",
                         drafter=drafter, spec_k=3, spec_rollback=rollback)
        for rid, toks, gen, arr in reqs:
            eng.submit(request_cls(rid=rid, tokens=toks.copy(),
                                   max_new_tokens=gen, arrival=arr))
        eng.run(max_steps=200)
        out.append((eng, det))
    return out


def _assert_same_profile(ref_prof, pt_prof):
    assert pt_prof.tiers == ref_prof.tiers
    assert pt_prof.checked == ref_prof.checked
    assert pt_prof.flagged == ref_prof.flagged
    ref_f = {f.key: f for f in ref_prof.findings}
    pt_f = {f.key: f for f in pt_prof.findings}
    assert sorted(pt_f) == sorted(ref_f)
    for key, f in ref_f.items():
        assert (pt_f[key].count, pt_f[key].bytes) == (f.count, f.bytes), key


def _assert_same_engine(ref_side, pt_side):
    (ref, ref_det), (pt, pt_det) = ref_side, pt_side
    assert sorted(pt.finished) == sorted(ref.finished)
    for rid, req in ref.finished.items():
        assert pt.finished[rid].generated == req.generated, rid
        assert pt.finished[rid].reuse_len == req.reuse_len, rid
    for key, value in pt.stats.items():
        if key not in WALL_CLOCK:
            assert value == ref.stats[key], key
    _assert_same_profile(ref_det.report, pt_det.report)
    assert sum(pt_det.report.checked.values()) > 0
    if ref.paged:
        np.testing.assert_array_equal(pt.kv.pt, ref.kv.pt)
        np.testing.assert_array_equal(pt.kv.alloc.refcount,
                                      ref.kv.alloc.refcount)
        pt.kv.check()
        _assert_same_profile(ref_det.kernel, pt_det.kernel)


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("heads", sorted(HEADS))
def test_engine_matches_reference(heads, kv):
    """Duplicated-prefix traffic with idle slots: greedy tokens, stats,
    page tables, tier-3 findings and (paged) tier-4 store counts equal
    the reference's."""
    ref_side, pt_side = _serve_both(heads, kv)
    _assert_same_engine(ref_side, pt_side)
    if kv == "paged":
        st = pt_side[0].stats
        assert st["prefix_hits"] >= 1 and st["cow_copies"] >= 1


def test_engine_matches_reference_when_tokens_drop():
    """At a capacity factor of 0.25 a prefill group's tokens drop (and
    its padded and idle rows take capacity too): the engine still gives
    the reference's tokens, stats and findings."""
    ref_side, pt_side = _serve_both("G2", "paged",
                                    moe={"capacity_factor": 0.25})
    _assert_same_engine(ref_side, pt_side)


@pytest.mark.parametrize("kv,rollback", [("paged", True), ("paged", False),
                                         ("dense", False)])
@pytest.mark.parametrize("heads", sorted(HEADS))
def test_spec_engine_matches_reference(heads, kv, rollback):
    """n-gram speculative decoding, rollback and overwrite: tokens, spec
    counters, page tables, tier-3 ``rejected_draft_store`` and tier-4
    ``kernel_rejected_draft_store`` equal the reference's."""
    ref_side, pt_side = _serve_both(heads, kv, spec="ngram",
                                    rollback=rollback)
    _assert_same_engine(ref_side, pt_side)
    pt, pt_det = pt_side
    assert pt.stats["spec_ticks"] > 0 and pt.stats["draft_proposed"] > 0
    if kv == "paged":
        rejected = pt.stats["draft_proposed"] - pt.stats["draft_accepted"]
        assert pt_det.kernel.flagged.get("kernel_rejected_draft_store",
                                         0) == (0 if rollback else rejected)


@pytest.mark.parametrize("spec,rollback", [(False, True), (True, True),
                                           (True, False)])
def test_launch_serve_matches_reference(spec, rollback, monkeypatch):
    """``launch.serve.run --arch granite-moe-3b-a800m --smoke --kv paged
    --profile`` at the CLI's defaults (batch 4, prompt 32, gen 16; and
    ``--spec on`` in both rollback modes) in the port gives the reference
    driver's tokens, stats and tier-3 findings on the same weights and
    prompts in float32, with tier-3 and tier-4 findings in the merged
    profile."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve as pt_serve
    from repro_torch.models import lm as pt_lm

    ref_model, ref_params, pt_model, pt_params = smoke_models(arch=GRANITE)
    monkeypatch.setattr(pt_registry, "get_config",
                        lambda arch: pt_model.cfg)
    monkeypatch.setattr(pt_lm.LM, "init",
                        lambda self, seed=0, **kw: pt_params)
    kw = dict(spec=True, spec_k=4, draft="ngram",
              spec_rollback=rollback) if spec else {}
    out, merged, stats = pt_serve.run(
        GRANITE, smoke=True, batch=4, prompt_len=32, gen=16, kv="paged",
        profile=True, device="cpu", **kw)
    prompts = jnp.asarray(ref_serve.batch_at(
        ref_model.cfg, 4, 32, seed=0, step=0)["tokens"])
    ref_out, _, tier3, _, ref_stats = ref_serve._run_engine(
        ref_model.cfg, ref_model, ref_params, prompts, 16, 0, True,
        kv="paged", **kw)
    np.testing.assert_array_equal(out, np.asarray(ref_out))
    for key, value in ref_stats.items():
        if key in stats and key not in WALL_CLOCK:
            assert stats[key] == value, key
    assert merged.tiers == [1, 2, 3, 4]
    for kind, n in tier3.checked.items():
        assert merged.checked[kind] == n, kind
        assert merged.flagged.get(kind, 0) == tier3.flagged.get(kind, 0)
    if spec:
        assert merged.checked["kernel_rejected_draft_store"] == \
            stats["draft_proposed"] > 0


def test_oracle_identity_breaks_as_in_reference(monkeypatch):
    """An MoE layer routes the verify window's rows (drafts and padding)
    in the same capacity group as the live tokens, so speculative decode
    need not reproduce plain decode: on the same weights (the port's
    init, carried into the reference) the reference driver's
    ``--draft oracle`` identity check fails, and so does the port's."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve as pt_serve
    from repro_torch.models import lm as pt_lm
    from repro_torch.models.params import tree_map
    from repro_torch.models.zoo import build_model as pt_build

    ref_cfg = dataclasses.replace(
        ref_registry.get_config(GRANITE).smoke(), dtype="float32")
    pt_cfg = dataclasses.replace(
        pt_registry.get_config(GRANITE).smoke(), dtype="float32")
    pt_params = pt_build(pt_cfg).init(0, device="cpu")
    ref_params = tree_map(lambda t: jnp.asarray(t.numpy()), pt_params)
    monkeypatch.setattr(pt_registry, "get_config", lambda arch: pt_cfg)
    monkeypatch.setattr(pt_lm.LM, "init",
                        lambda self, seed=0, **kw: pt_params)
    kw = dict(kv="paged", spec=True, spec_k=4, draft="oracle")
    prompts = jnp.asarray(ref_serve.batch_at(ref_cfg, 4, 32, seed=0,
                                             step=0)["tokens"])
    with pytest.raises(AssertionError, match="diverged"):
        ref_serve._run_engine(ref_cfg, ref_build(ref_cfg), ref_params,
                              prompts, 12, 0, False, spec_rollback=True,
                              **kw)
    with pytest.raises(AssertionError, match="diverged"):
        pt_serve.run(GRANITE, batch=4, prompt_len=32, gen=12, device="cpu",
                     **kw)
