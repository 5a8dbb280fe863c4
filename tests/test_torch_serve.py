"""Serving parity of the PyTorch port against the reference, on the CPU:
the continuous-batching engine (dense and paged KV), its tier-3
detectors and tier-4 kernel counters, and the serve driver.

Integer results must match exactly: greedy tokens (float32 config, same
weights), engine stats without the wall-clock keys, page tables, and the
findings' checked/flagged/count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ProfilerConfig as RefProfilerConfig
from repro.core.detectors import ServingDetectors as RefDetectors
from repro.core.report import load_json as ref_load_json
from repro.core.findings import merge_profiles as ref_merge
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.configs.base import ProfilerConfig
from repro_torch.core.detectors import ServingDetectors
from repro_torch.core.report import dump_json
from repro_torch.serve.engine import Request, ServeEngine

from _torch_parity import smoke_models

WALL_CLOCK = ("prefill_s", "decode_s")


def _requests(cfg, kind: str):
    """(rid, tokens, max_new_tokens, arrival) request sets."""
    rng = np.random.RandomState(11)
    if kind == "launch":
        # what `--batch 2 --prompt-len 8 --gen 4` submits: all at step 0
        return [(f"r{b}", rng.randint(0, cfg.vocab_size, size=8)
                 .astype(np.int32), 4, 0) for b in range(2)]
    # duplicated-prefix traffic: more requests than slots sharing a
    # 10-token prefix that is w0's whole prompt, staggered arrivals. The
    # followers reuse w0's prompt (10 positions: a partial page, so a
    # copy-on-write) and slots recycle. No prompt is a full duplicate: a
    # recomputed duplicate position is a silent store only if both
    # computations agree bit for bit, which differs between the two
    # frameworks' kernels (see ROADMAP.md § C).
    shared = rng.randint(0, cfg.vocab_size, size=10).astype(np.int32)
    reqs = []
    for i, (tail, gen, arr) in enumerate([(0, 3, 0), (6, 6, 0), (4, 2, 1),
                                          (3, 4, 2), (5, 3, 3)]):
        toks = np.concatenate(
            [shared, rng.randint(1, cfg.vocab_size, size=tail)
             .astype(np.int32)])
        reqs.append((f"w{i}", toks, gen, arr))
    return reqs


def _run_both(kind, kv, *, detectors=False, kernel_counters=False,
              num_slots=2, max_len=24, page_size=4):
    ref_model, ref_params, pt_model, pt_params = smoke_models()
    reqs = _requests(ref_model.cfg, kind)
    ref_det = pt_det = None
    if detectors:
        ref_det = RefDetectors(RefProfilerConfig(
            enabled=True, num_watchpoints=8, seed=0), sites_per_step=4)
        pt_det = ServingDetectors(ProfilerConfig(
            enabled=True, num_watchpoints=8, seed=0), sites_per_step=4)
    ref = RefEngine(ref_model, ref_params, num_slots=num_slots,
                    max_len=max_len, detectors=ref_det,
                    kv_dtype=jnp.float32, kv_layout=kv,
                    page_size=page_size, kernel_counters=kernel_counters)
    pt = ServeEngine(pt_model, pt_params, num_slots=num_slots,
                     max_len=max_len, detectors=pt_det,
                     kv_dtype=torch.float32, kv_layout=kv,
                     page_size=page_size, kernel_counters=kernel_counters)
    for rid, toks, gen, arr in reqs:
        ref.submit(RefRequest(rid=rid, tokens=toks.copy(),
                              max_new_tokens=gen, arrival=arr))
        pt.submit(Request(rid=rid, tokens=toks.copy(), max_new_tokens=gen,
                          arrival=arr))
    ref.run(max_steps=200)
    pt.run(max_steps=200)
    return ref, pt, ref_det, pt_det


def _assert_same_serving(ref, pt):
    assert sorted(ref.finished) == sorted(pt.finished)
    for rid, req in ref.finished.items():
        assert pt.finished[rid].generated == req.generated, rid
        assert pt.finished[rid].reuse_len == req.reuse_len, rid
    for key, value in pt.stats.items():
        if key not in WALL_CLOCK:
            assert value == ref.stats[key], key
    if ref.paged:
        np.testing.assert_array_equal(pt.kv.pt, ref.kv.pt)
        np.testing.assert_array_equal(pt.kv.alloc.refcount,
                                      ref.kv.alloc.refcount)
        pt.kv.check()


def _assert_same_profile(ref_prof, pt_prof):
    assert pt_prof.tiers == ref_prof.tiers
    assert pt_prof.checked == ref_prof.checked
    assert pt_prof.flagged == ref_prof.flagged
    assert pt_prof.totals == ref_prof.totals
    ref_f = {f.key: f for f in ref_prof.findings}
    pt_f = {f.key: f for f in pt_prof.findings}
    assert sorted(pt_f) == sorted(ref_f)
    for key, f in ref_f.items():
        assert (pt_f[key].count, pt_f[key].bytes) == (f.count, f.bytes), key


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_engine_tokens_and_stats_match_reference(kv):
    ref, pt, _, _ = _run_both("launch", kv)
    _assert_same_serving(ref, pt)


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_engine_duplicated_prefix_matches_reference(kv):
    ref, pt, _, _ = _run_both("dup", kv)
    _assert_same_serving(ref, pt)
    if kv == "paged":
        assert pt.stats["prefix_hits"] >= 1
        assert pt.stats["cow_copies"] >= 1
        assert pt.stats["pages_freed"] > 0


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_engine_tier3_findings_match_reference(kv):
    ref, pt, ref_det, pt_det = _run_both("dup", kv, detectors=True)
    _assert_same_serving(ref, pt)
    _assert_same_profile(ref_det.report, pt_det.report)
    assert sum(pt_det.report.checked.values()) > 0


def test_engine_tier4_kernel_counters_match_reference():
    ref, pt, ref_det, pt_det = _run_both("dup", "paged", detectors=True,
                                         kernel_counters=True)
    _assert_same_serving(ref, pt)
    _assert_same_profile(ref_det.report, pt_det.report)
    _assert_same_profile(ref_det.kernel, pt_det.kernel)
    # padded prefill rows past a slot's pages are dropped stores, padded
    # rows re-storing layer-0 K/V of the same (token, position) are silent
    assert pt_det.kernel.flagged["kernel_dead_store"] > 0
    assert pt_det.kernel.flagged["kernel_silent_store"] > 0


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_launch_serve_run_matches_reference_engine(kv, monkeypatch):
    """`launch.serve.run --batch 2 --prompt-len 8 --gen 4` in the port
    gives the reference engine's tokens and stats on the same weights and
    prompts."""
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
        "qwen3-1.7b", smoke=False, batch=2, prompt_len=8, gen=4, kv=kv,
        device="cpu")
    prompts = jnp.asarray(ref_serve.batch_at(
        ref_model.cfg, 2, 8, seed=0, step=0)["tokens"])
    ref_out, _, _, _, ref_stats = ref_serve._run_engine(
        ref_model.cfg, ref_model, ref_params, prompts, 4, 0, False, kv=kv)
    np.testing.assert_array_equal(out, np.asarray(ref_out))
    for key, value in ref_stats.items():
        if key in stats and key not in WALL_CLOCK:
            assert stats[key] == value, key
    assert merged is None


def test_merged_profile_json_round_trips_through_reference(tmp_path,
                                                          monkeypatch):
    """The port's merged serving profile (tiers 1, 2, 3, 4) is a reference
    WasteProfile: it loads with ``repro.core.report.load_json``, equals
    itself after the round trip, and merges with a reference profile."""
    from repro_torch.configs import registry as pt_registry
    from repro_torch.launch import serve as pt_serve
    from repro_torch.models import lm as pt_lm

    _, _, pt_model, pt_params = smoke_models()
    monkeypatch.setattr(pt_registry, "get_config",
                        lambda arch: pt_model.cfg)
    monkeypatch.setattr(pt_lm.LM, "init",
                        lambda self, seed=0, **kw: pt_params)
    path = str(tmp_path / "profile.json")
    _, merged, _ = pt_serve.run(
        "qwen3-1.7b", batch=2, prompt_len=8, gen=4, kv="paged",
        profile=True, profile_out=path, sarif_out=str(tmp_path / "p.sarif"),
        device="cpu")
    assert merged.tiers == [1, 2, 3, 4]
    loaded = ref_load_json(path)
    assert loaded.to_dict() == merged.to_dict()
    ref_det = RefDetectors(RefProfilerConfig(enabled=True))
    ref_det.report.observe("silent_prefix_load", True)
    both = ref_merge([loaded, ref_det.report])
    assert both.checked["silent_prefix_load"] == \
        merged.checked["silent_prefix_load"] + 1
    dump_json(merged, str(tmp_path / "again.json"))
    assert ref_load_json(str(tmp_path / "again.json")) == loaded


def test_serve_profile_runs_tier1_on_the_decode_microstep(monkeypatch,
                                                          capsys):
    """``--profile`` runs tier 1 on one decode microstep, as the
    reference's driver: the merged profile has tier 1, whose loads cover
    at least every parameter byte of the decode step (each weight is read
    for its cast) and whose stores are non-zero; each norm and attention
    entry point is one recorded kernel operation; the rendered header
    names tiers 1-4, with tier 2 (the traced tick) in it and no tier
    reported as not ported."""
    from repro_torch.configs import registry as pt_registry
    from repro_torch.launch import serve as pt_serve
    from repro_torch.models import lm as pt_lm
    from repro_torch.models.params import tree_leaves

    _, _, pt_model, pt_params = smoke_models()
    monkeypatch.setattr(pt_registry, "get_config",
                        lambda arch: pt_model.cfg)
    monkeypatch.setattr(pt_lm.LM, "init",
                        lambda self, seed=0, **kw: pt_params)
    out, merged, stats = pt_serve.run(
        "qwen3-1.7b", batch=2, prompt_len=8, gen=4, kv="paged",
        profile=True, device="cpu")
    text = capsys.readouterr().out
    assert "(tiers 1,2,3,4)" in text
    assert "not ported" not in text
    assert "[serve] tier 2 (decode tick)" in text
    assert 1 in merged.tiers and stats["tier1_s"] > 0

    tier1, interp = pt_serve.tier1_decode_profile(
        pt_model, pt_params, torch.as_tensor(out[:, -1:]), 8 + 4 + 1, 0)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(pt_params))
    assert tier1.tiers == [1]
    assert tier1.total_store_events > 0 and tier1.total_load_events > 0
    assert tier1.total_load_bytes >= param_bytes
    assert merged.total_load_bytes >= tier1.total_load_bytes
    assert sum(tier1.checked.values()) > 0
    layers = pt_model.cfg.num_layers
    assert interp.stats["kernel_ops"] == (4 * layers + 1) + layers
    assert len(interp.stats["epoch_s"]) == 2
    assert tier1.to_dict() == merged.__class__.from_json(
        tier1.to_json()).to_dict()


def test_engines_share_one_step_cache():
    """Engines built on one StepCache run the same step functions and
    serve the same tokens as an engine with its own."""
    from repro_torch.serve.decode import StepCache
    _, _, pt_model, pt_params = smoke_models()
    shared = StepCache(pt_model)
    outs = []
    for step_cache in (shared, shared, None):
        eng = ServeEngine(pt_model, pt_params, num_slots=2, max_len=24,
                          kv_layout="paged", page_size=4,
                          step_cache=step_cache)
        for rid, toks, gen, arr in _requests(pt_model.cfg, "dup"):
            eng.submit(Request(rid=rid, tokens=toks, max_new_tokens=gen,
                               arrival=arr))
        eng.run(max_steps=200)
        outs.append({rid: r.generated for rid, r in eng.finished.items()})
    assert outs[0] == outs[1] == outs[2]
    assert shared.get("tick", paged=True) is shared.get("tick", paged=True)


def test_engine_rejects_malformed_requests():
    _, _, pt_model, pt_params = smoke_models()
    eng = ServeEngine(pt_model, pt_params, num_slots=2, max_len=8)
    for toks, gen in ((np.zeros((2, 3), np.int32), 2),
                      (np.zeros(0, np.int32), 2),
                      (np.zeros(8, np.int32), 2),
                      (np.zeros(3, np.int32), 0)):
        with pytest.raises(ValueError):
            eng.submit(Request(rid="bad", tokens=toks, max_new_tokens=gen))
    assert eng.pending == 0
