"""Fleet tier of the PyTorch port against the reference, on the CPU:
seeded and replayable traces, prefix-aware routing over `ServeEngine`
replicas, the global prefix tier's refcount-safe publish/lease/evict
protocol, the fleet-level Def.-3 profile and its JSON and SARIF round
trips, and the fleet driver's deterministic claims.

Equal means exact: trace JSON character for character, routes (the
replica of every request), router and engine stats without wall-clock
keys, ``fleet_silent_prefix_load`` bytes and tokens, finding counts and
(float32 config, same weights) greedy tokens. Wall-clock TTFT is
printed, not asserted.
"""
import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypo import given, settings, st

from repro.configs.base import ProfilerConfig as RefProfilerConfig
from repro.core.detectors import ServingDetectors as RefDetectors
from repro.core.findings import merge_fleet as ref_merge_fleet
from repro.core.sarif import to_sarif as ref_to_sarif
from repro.serve.decode import StepCache as RefStepCache
from repro.serve.engine import ServeEngine as RefEngine
from repro.serve.router import FleetRouter as RefRouter
from repro.serve.workload import duplicated_prefix_trace as ref_dup_trace
from repro.serve.workload import make_trace as ref_make_trace
from repro_torch.configs.base import ProfilerConfig
from repro_torch.core.detectors import ServingDetectors
from repro_torch.core.findings import WasteProfile, merge_fleet
from repro_torch.core.report import dump_json, load_json
from repro_torch.core.sarif import write_sarif
from repro_torch.launch import fleet as pt_fleet
from repro_torch.serve.decode import StepCache
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.router import FleetRouter
from repro_torch.serve.workload import (Trace, TraceRequest,
                                        duplicated_prefix_trace, make_trace)

from _torch_parity import smoke_models

# models, weights and step caches shared by every test (a dict, not a
# fixture, so the property test's shim can reach it too)
_ENV = {}


def _env():
    if not _ENV:
        ref_model, ref_params, pt_model, pt_params = smoke_models()
        _ENV.update(
            cfg=pt_model.cfg,
            ref=(ref_model, ref_params, RefStepCache(ref_model), RefEngine,
                 RefRouter, jnp.float32),
            pt=(pt_model, pt_params, StepCache(pt_model), ServeEngine,
                FleetRouter, torch.float32))
    return _ENV


def _engines(pkg, n, *, max_len, slots=2, page_size=8, num_pages=None,
             detectors=None):
    model, params, sc, Engine, _, kv_dtype = _env()[pkg]
    return [Engine(model, params, num_slots=slots, max_len=max_len,
                   kv_layout="paged", page_size=page_size,
                   num_pages=num_pages, kv_dtype=kv_dtype,
                   detectors=detectors[i] if detectors else None,
                   step_cache=sc)
            for i in range(n)]


def _fleet(pkg, trace, *, policy, max_len, page_size=8, num_pages=None,
           detectors=None, **kw):
    Router = _env()[pkg][4]
    fleet = Router(_engines(pkg, 2, max_len=max_len, page_size=page_size,
                            num_pages=num_pages, detectors=detectors),
                   policy=policy, seed=0, **kw)
    fleet.submit_trace(trace)
    fleet.run()
    fleet.check()
    return fleet


def _outputs(fleet):
    return {rid: list(r.generated) for rid, r in fleet.finished.items()}


def _single_outputs(trace, *, max_len, slots=4, page_size=8):
    model, params, sc = _env()["pt"][:3]
    eng = ServeEngine(model, params, num_slots=slots, max_len=max_len,
                      kv_layout="paged", page_size=page_size, step_cache=sc)
    for treq in sorted(trace.requests, key=lambda r: r.arrival):
        eng.submit(Request(rid=treq.rid, tokens=np.asarray(treq.tokens),
                           max_new_tokens=treq.max_new_tokens))
    eng.run()
    return {rid: list(r.generated) for rid, r in eng.finished.items()}


def _assert_same_fleet(fleet, ref):
    """Routes, stats, fleet waste and tokens equal the reference's."""
    assert dict(fleet.stats) == dict(ref.stats)
    assert ({rid: m.get("replica") for rid, m in fleet.metrics.items()}
            == {rid: m.get("replica") for rid, m in ref.metrics.items()})
    assert ({rid: m["global_match_len"] for rid, m in fleet.metrics.items()}
            == {rid: m["global_match_len"] for rid, m in ref.metrics.items()})
    for eng, ref_eng in zip(fleet.engines, ref.engines):
        assert ({k: v for k, v in eng.stats.items() if not k.endswith("_s")}
                == {k: v for k, v in ref_eng.stats.items()
                    if not k.endswith("_s")})
        np.testing.assert_array_equal(eng.kv.alloc.refcount,
                                      ref_eng.kv.alloc.refcount)
    assert fleet.prefix_hit_fraction() == ref.prefix_hit_fraction()
    assert fleet.fleet_waste_bytes() == ref.fleet_waste_bytes()
    assert fleet.profile.checked == ref.profile.checked
    assert fleet.profile.flagged == ref.profile.flagged
    assert fleet.profile.totals == ref.profile.totals
    assert ({f.key: (f.count, f.bytes, f.meta.get("tokens"))
             for f in fleet.profile.findings}
            == {f.key: (f.count, f.bytes, f.meta.get("tokens"))
                for f in ref.profile.findings})
    assert fleet.queue_summary() == ref.queue_summary()
    assert _outputs(fleet) == _outputs(ref)


# ----------------------------------------------------------------------
# Trace generator: seeded, replayable, JSON equal to the reference's
# ----------------------------------------------------------------------
TRACE_KW = [
    dict(n_requests=16, vocab_size=997, seed=3, arrival="poisson", rate=0.7,
         dup_rate=0.6, n_prefixes=2, prefix_len=20, prompt_len=(8, 40),
         gen_len=(2, 6)),
    dict(n_requests=9, vocab_size=101, seed=1, arrival="uniform", rate=0.5,
         prompt_len=(8, 12), gen_len=(2, 3)),
    dict(n_requests=9, vocab_size=101, seed=1, arrival="bursty",
         burst_size=3, burst_gap=5, prompt_len=(8, 12), gen_len=(2, 3)),
    dict(n_requests=12, vocab_size=151936, seed=0, arrival="poisson",
         rate=0.3, prompt_len=(48, 48), gen_len=(4, 4), dup_rate=0.8,
         n_prefixes=1, prefix_len=40),
]


@pytest.mark.parametrize("kw", TRACE_KW)
def test_trace_json_equals_reference_and_roundtrips(kw, tmp_path):
    a, b = make_trace(**kw), make_trace(**kw)
    assert a.to_json() == b.to_json() == ref_make_trace(**kw).to_json()
    assert a.to_json(indent=1) == ref_make_trace(**kw).to_json(indent=1)
    assert make_trace(**{**kw, "seed": kw["seed"] + 1}).to_json() \
        != a.to_json()
    back = Trace.from_json(a.to_json())
    assert back.to_json() == a.to_json()
    for r, s in zip(a.requests, back.requests):
        assert (r.rid, r.arrival, r.max_new_tokens, r.prefix_id) == \
               (s.rid, s.arrival, s.max_new_tokens, s.prefix_id)
        assert np.array_equal(r.tokens, s.tokens)
        assert s.tokens.dtype == np.int32
    p = tmp_path / "trace.json"
    a.save(str(p))
    assert Trace.load(str(p)).to_json() == a.to_json()
    arr = [r.arrival for r in a.requests]
    assert arr == sorted(arr)
    t = duplicated_prefix_trace(n_requests=6, vocab_size=97, seed=0)
    assert t.to_json() == ref_dup_trace(n_requests=6, vocab_size=97,
                                        seed=0).to_json()
    assert [r.arrival for r in t.requests] == [0, 0, 2, 2, 4, 4]


def test_trace_arrival_patterns_and_validation():
    base = dict(n_requests=9, vocab_size=101, seed=1, prompt_len=(8, 12),
                gen_len=(2, 3))
    uni = make_trace(arrival="uniform", rate=0.5, **base)
    assert [r.arrival for r in uni.requests] == [2 * i for i in range(9)]
    bur = make_trace(arrival="bursty", burst_size=3, burst_gap=5, **base)
    assert [r.arrival for r in bur.requests] == \
           [(i // 3) * 5 for i in range(9)]
    poi = make_trace(arrival="poisson", rate=2.0, **base)
    assert [r.arrival for r in poi.requests] == [
        r.arrival for r in ref_make_trace(arrival="poisson", rate=2.0,
                                          **base).requests]
    with pytest.raises(ValueError):
        make_trace(arrival="adversarial", **base)


# ----------------------------------------------------------------------
# Routing: cross-replica prefix reuse, bit-identity to a single engine
# ----------------------------------------------------------------------
def _dup_trace(seed=0, **kw):
    return duplicated_prefix_trace(n_requests=8,
                                   vocab_size=_env()["cfg"].vocab_size,
                                   seed=seed, prompt_len=24, prefix_len=20,
                                   gen=4, **kw)


def test_fleet_routes_across_replicas_and_matches_reference():
    trace = _dup_trace()
    max_len = trace.max_prompt_len + trace.max_new_tokens + 1
    pages = 4 * (-(-max_len // 8))      # 2 slots + 2 slots of pin headroom
    fleet = _fleet("pt", trace, policy="prefix", max_len=max_len,
                   num_pages=pages)
    ref = _fleet("ref", trace, policy="prefix", max_len=max_len,
                 num_pages=pages)
    _assert_same_fleet(fleet, ref)
    assert fleet.stats["dispatched"] == 8 and len(fleet.finished) == 8
    assert fleet.stats["prefix_routes"] >= 1
    assert fleet.stats["cross_replica_prefix_routes"] >= 1
    assert 0.0 < fleet.prefix_hit_fraction() < 1.0
    lat = fleet.latency_summary()
    assert lat["ttft_p99"] >= lat["ttft_p50"] > 0
    assert lat["tpot_p99"] >= lat["tpot_p50"] > 0
    assert _outputs(fleet) == _single_outputs(trace, max_len=max_len)


def test_backpressure_admission_control_and_least_policy():
    trace = _dup_trace(seed=2, burst_size=8, burst_gap=1)
    max_len = trace.max_prompt_len + trace.max_new_tokens + 1
    kw = dict(policy="least", max_len=max_len,
              num_pages=4 * (-(-max_len // 8)), max_inflight=2)
    fleet, ref = _fleet("pt", trace, **kw), _fleet("ref", trace, **kw)
    _assert_same_fleet(fleet, ref)
    assert fleet.stats["backpressure_ticks"] > 0
    assert fleet.stats["backpressure_requests"] > 0
    assert fleet.stats["dispatched"] == 8 and len(fleet.finished) == 8
    assert max(q["max_depth"] for q in fleet.queue_summary()) <= 2
    assert _outputs(fleet) == _single_outputs(trace, max_len=max_len)


def test_prefix_policy_requires_paged_replicas():
    model, params, sc = _env()["pt"][:3]
    dense = [ServeEngine(model, params, num_slots=1, max_len=16,
                         kv_layout="dense", step_cache=sc)
             for _ in range(2)]
    with pytest.raises(ValueError, match="paged"):
        FleetRouter(dense, policy="prefix")
    with pytest.raises(ValueError, match="policy"):
        FleetRouter(dense, policy="round-robin")


# ----------------------------------------------------------------------
# Prefix routing pays no fleet Def.-3 bytes; random does, as in the
# reference (bytes and tokens equal; wall-clock TTFT printed)
# ----------------------------------------------------------------------
def test_prefix_routing_beats_random_on_fleet_waste():
    cfg = _env()["cfg"]
    rng = np.random.RandomState(0)
    PFX, SUF, GEN = 256, 256, 2
    prefix = rng.randint(0, cfg.vocab_size, PFX).astype(np.int32)
    reqs = [TraceRequest("r0", 0, prefix.copy(), GEN, 0)]
    for i in range(6):
        suf = rng.randint(0, cfg.vocab_size, SUF).astype(np.int32)
        reqs.append(TraceRequest(f"d{i}", 4 + 4 * (i // 2),
                                 np.concatenate([prefix, suf]), GEN, 0))
    trace = Trace(reqs)
    max_len = PFX + SUF + GEN + 1
    kw = dict(max_len=max_len, page_size=16,
              num_pages=4 * (-(-max_len // 16)))
    results = {}
    for policy in ("prefix", "random"):
        fleet = _fleet("pt", trace, policy=policy, **kw)
        _assert_same_fleet(fleet, _fleet("ref", trace, policy=policy, **kw))
        results[policy] = fleet
        print(f"[fleet:{policy}] p99 TTFT "
              f"{fleet.latency_summary()['ttft_p99'] * 1e3:.1f} ms (CPU)")
    fp, fr = results["prefix"], results["random"]
    assert fp.stats["prefix_routes"] >= 4
    assert fp.fleet_waste_bytes() == 0.0 < fr.fleet_waste_bytes()
    # 4 bytes a token: the int32 prompt tokens the charge is counted in
    waste_tokens = fr.profile.totals["fleet_silent_prefix_tokens"]
    assert fr.fleet_waste_bytes() == 4 * waste_tokens
    assert _outputs(fp) == _outputs(fr) == _single_outputs(
        trace, max_len=max_len, page_size=16)


# ----------------------------------------------------------------------
# Property: no freed page is ever reachable from the global tier, and
# greedy outputs stay those of one engine, under random arrival/
# eviction/pool-pressure schedules
# ----------------------------------------------------------------------
_PROP = {}


def _prop_requests():
    if not _PROP:
        cfg = _env()["cfg"]
        rng = np.random.RandomState(7)
        prefix = rng.randint(0, cfg.vocab_size, 16).astype(np.int32)
        toks = []
        for i in range(6):
            if i < 4:       # duplicated-prefix traffic
                t = np.concatenate([prefix, rng.randint(
                    0, cfg.vocab_size, 8).astype(np.int32)])
            else:           # unique fillers
                t = rng.randint(0, cfg.vocab_size, 24).astype(np.int32)
            toks.append(t)
        trace = Trace([TraceRequest(f"p{i}", 0, t, 2, None)
                       for i, t in enumerate(toks)])
        _PROP["tokens"] = toks
        _PROP["ref"] = _single_outputs(trace, max_len=27)
    return _PROP


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(10, 16),
       st.sampled_from(["prefix", "least", "random"]))
def test_no_freed_page_reachable_under_random_schedules(
        seed, num_pages, policy):
    env = _prop_requests()
    rng = np.random.RandomState(seed)
    arrivals = np.sort(rng.randint(0, 8, size=6))
    trace = Trace([TraceRequest(f"p{i}", int(arrivals[i]), t, 2, None)
                   for i, t in enumerate(env["tokens"])])
    fleet = FleetRouter(_engines("pt", 2, max_len=27, num_pages=num_pages),
                        policy=policy, seed=seed)
    fleet.submit_trace(trace)
    for _ in range(300):
        if not fleet.pending:
            break
        fleet.step()
        # adversarial interleaving: global evictions (LRU and targeted)
        # while dispatch leases and live slots are outstanding
        if rng.rand() < 0.3:
            fleet.gpi.evict_one()
        if rng.rand() < 0.2:
            fleet.gpi.evict_for(int(rng.randint(2)), int(rng.randint(1, 4)))
        fleet.check()
    assert not fleet.pending, "fleet failed to drain under eviction churn"
    fleet.check()
    assert _outputs(fleet) == env["ref"], \
        f"outputs diverged under schedule seed={seed} policy={policy}"


# ----------------------------------------------------------------------
# §5.6 at fleet scale: merged profile round-trips JSON and SARIF
# ----------------------------------------------------------------------
def test_fleet_profile_merges_roundtrips_json_and_sarif(tmp_path):
    trace = _dup_trace()
    max_len = trace.max_prompt_len + trace.max_new_tokens + 1
    kw = dict(policy="random", max_len=max_len,
              num_pages=4 * (-(-max_len // 8)))
    dets = [ServingDetectors(ProfilerConfig(enabled=True, seed=i))
            for i in range(2)]
    ref_dets = [RefDetectors(RefProfilerConfig(enabled=True, seed=i))
                for i in range(2)]
    fleet = _fleet("pt", trace, detectors=dets, **kw)
    ref = _fleet("ref", trace, detectors=ref_dets, **kw)
    _assert_same_fleet(fleet, ref)
    assert fleet.fleet_waste_bytes() > 0
    assert {f.kind for f in fleet.profile.findings} == \
        {"fleet_silent_prefix_load"}
    for f in fleet.profile.findings:
        assert f.c1[0] == "serve.global_prefix:resident"
        assert f.c2[0] == "serve.router:dispatch"
        assert f.c1[1] != f.c2[1], "waste charged to the resident replica"

    members = {f"replica{i}": d.combined() for i, d in enumerate(dets)}
    members["router"] = fleet.profile
    merged = merge_fleet(members)
    ref_members = {f"replica{i}": d.combined()
                   for i, d in enumerate(ref_dets)}
    ref_members["router"] = ref.profile
    ref_merged = ref_merge_fleet(ref_members)
    assert merged.meta["fleet"] == ref_merged.meta["fleet"]
    assert merged.checked == ref_merged.checked
    assert merged.flagged == ref_merged.flagged
    assert sorted(f.key for f in merged.findings) == \
        sorted(f.key for f in ref_merged.findings)
    total = sum(m["findings"] for m in merged.meta["fleet"].values())
    assert len(merged.findings) <= total   # coalescing never invents

    again = merge_fleet({"a": merge_fleet({"replica0": members["replica0"],
                                           "router": members["router"]}),
                         "b": members["replica1"]})
    assert {f.key for f in again.findings} == \
           {f.key for f in merged.findings}

    back = WasteProfile.from_json(merged.to_json())
    assert back == merged
    p = str(tmp_path / "fleet_profile.json")
    dump_json(merged, p)
    assert load_json(p) == merged

    doc = write_sarif(merged, str(tmp_path / "fleet.sarif"))
    ref_doc = ref_to_sarif(ref_merged)

    def rules_and_results(d):
        run = d["runs"][0]
        counts = {}
        for r in run["results"]:
            counts[r["ruleId"]] = counts.get(r["ruleId"], 0) + 1
        return sorted(r["id"] for r in run["tool"]["driver"]["rules"]), counts
    assert rules_and_results(doc) == rules_and_results(ref_doc)
    assert "fleet_silent_prefix_load" in rules_and_results(doc)[0]
    assert rules_and_results(doc)[1]["fleet_silent_prefix_load"] >= 1


# ----------------------------------------------------------------------
# The driver: the reference's deterministic lines, objects, dedup, SARIF
# ----------------------------------------------------------------------
DETERMINISTIC = ("cross-replica prefix routes:", "silent-prefix-load bytes:",
                 "bit-identical to single-engine:")


def _claims(text):
    out = []
    for line in text.splitlines():
        for key in DETERMINISTIC:
            if key in line:
                out.append(line[line.index(key):])
    return out


def test_driver_deterministic_claims_match_reference(tmp_path):
    from repro.launch import fleet as ref_fleet
    kw = dict(smoke=True, replicas=2, policy="prefix", compare=True,
              check_single=True, profile=True)
    with redirect_stdout(io.StringIO()) as out:
        fleet, merged, info = pt_fleet.run(
            "qwen3-1.7b", device="cpu",
            sarif_out=str(tmp_path / "f.sarif"), **kw)
    with redirect_stdout(io.StringIO()) as ref_out:
        ref_fleet.run("qwen3-1.7b", **kw)
    claims = _claims(out.getvalue())
    assert claims == _claims(ref_out.getvalue())
    assert fleet.stats["cross_replica_prefix_routes"] >= 1
    assert "silent-prefix-load bytes: True (0 vs " in out.getvalue()
    assert "bit-identical to single-engine: True" in out.getvalue()
    assert info["compared"].fleet_waste_bytes() > 0
    assert set(merged.meta["fleet"]) == {"replica0", "replica1", "router"}
    assert (tmp_path / "f.sarif").exists()


@pytest.mark.parametrize("dedup", [False, True])
def test_driver_objects_same_burst_trace(dedup, tmp_path):
    """``--objects`` on the same-burst trace of test_torch_objects.py:
    cross-replica KV replica bytes above 0, and 0 with ``--dedup``; the
    object findings carry their allocation site into SARIF."""
    with redirect_stdout(io.StringIO()) as out:
        fleet, merged, info = pt_fleet.run(
            "qwen3-1.7b", smoke=True, device="cpu", requests=6,
            arrival="bursty", burst_size=2, burst_gap=4, dup_rate=1.0,
            prefix_len=36, check_single=True, profile=True, objects=True,
            dedup=dedup, sarif_out=str(tmp_path / "o.sarif"))
    from repro_torch.core.replicas import cross_replica_bytes
    kv_x = cross_replica_bytes(info["scan"], "replica_kv_page")
    line = next(x for x in out.getvalue().splitlines()
                if "cross-replica kv replica bytes:" in x)
    assert line.endswith(f"cross-replica kv replica bytes: {kv_x:.0f}")
    assert (kv_x == 0) if dedup else (kv_x > 0)
    assert "top objects by attributed waste" in out.getvalue()
    assert 5 in merged.tiers
    import json
    doc = json.loads((tmp_path / "o.sarif").read_text())
    phys = [r["locations"][0]["physicalLocation"]
            for r in doc["runs"][0]["results"]
            if r["ruleId"].startswith("replica_")]
    assert phys and all(p["region"]["startLine"] > 0 for p in phys)
    assert all(p["artifactLocation"]["uri"].endswith(".py") for p in phys)


def test_driver_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        pt_fleet.run("qwen3-1.7b", smoke=True)
