"""Object tier of the PyTorch port against the reference, on the CPU: the
object registry with allocation-site provenance, the replica detector
and its content digest, the engine/allocator/optimizer/train-state
registry hooks, and the content-addressed dedup that drives the
cross-replica KV bytes to 0.

Equal means exact: names, kinds, sizes, owners, digests, replica groups
and bytes, routes, engine stats and (float32 config, same weights)
greedy tokens. Object keys carry each package's own allocation site
(file basename and line), so findings are compared with the site
stripped from their keys.
"""
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.findings import WasteProfile as RefProfile
from repro.core.objects import ObjectRegistry as RefRegistry
from repro.core.objects import register_tree as ref_register_tree
from repro.core.replicas import ReplicaDetector as RefDetector
from repro.core.replicas import cross_replica_bytes as ref_cross_bytes
from repro.core.replicas import object_digest as ref_digest
from repro.serve.decode import StepCache as RefStepCache
from repro.serve.engine import ServeEngine as RefEngine
from repro.serve.router import FleetRouter as RefRouter
from repro.serve.workload import make_trace as ref_make_trace
from repro.train import state as ref_state
from repro_torch.core.findings import TIER_OBJECT, WasteProfile
from repro_torch.core.objects import ObjectRegistry, register_tree
from repro_torch.core.replicas import (FIXES, ReplicaDetector,
                                       cross_replica_bytes, object_digest)
from repro_torch.launch import serve as pt_serve
from repro_torch.launch import train as pt_train
from repro_torch.serve.decode import StepCache
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.router import FleetRouter
from repro_torch.serve.workload import make_trace

from _torch_parity import smoke_models


def _unsite(key: str) -> str:
    """An object key (kind|name|site) without its site."""
    return key.rsplit("|", 1)[0]


def _groups(prof):
    """The replica findings of a scan, comparable across packages."""
    out = {}
    for f in prof.findings:
        out[(f.kind, _unsite(f.c1[0]))] = (
            tuple(_unsite(k) for k in f.c2), f.count, f.bytes, f.fraction,
            tuple(f.meta["replicas"]), f.meta["cross_replica"],
            f.meta["fix"])
    return out


def _records(reg):
    return [(r.name, r.kind, r.nbytes, r.owner) for r in reg.live()]


# ----------------------------------------------------------------------
# Registry basics: provenance, lifecycle, ownership
# ----------------------------------------------------------------------
def test_registry_provenance_and_lifecycle():
    reg, ref = ObjectRegistry(), RefRegistry()
    rec = reg.register("replica0/kv/page3", "kv_page", 4096)
    ref_rec = ref.register("replica0/kv/page3", "kv_page", 4096)
    assert rec.site.startswith("test_torch_objects.py:")
    assert rec.func == "test_registry_provenance_and_lifecycle"
    assert rec.owner == ref_rec.owner == "replica0"
    assert rec.object_key == f"kv_page|replica0/kv/page3|{rec.site}"
    assert _unsite(rec.object_key) == _unsite(ref_rec.object_key)
    assert len(reg) == 1 and reg.get(rec.oid) is rec
    assert reg.nbytes_live("kv_page") == ref.nbytes_live("kv_page") == 4096
    reg.release(rec.oid)
    assert len(reg) == 0 and reg.get(rec.oid) is None
    reg.release(rec.oid)                 # double release is a no-op
    with pytest.raises(AssertionError):
        reg.register("x", "not_a_kind", 1)


def test_register_tree_names_match_reference_on_smoke_tree():
    """jax's keystr names, in its sorted-key order, on qwen3's smoke
    tree; readers return the tensors themselves, with the reference's
    bytes."""
    _, ref_params, _, pt_params = smoke_models()
    reg, ref = ObjectRegistry(), RefRegistry()
    recs = register_tree(reg, "replica1/params", pt_params)
    ref_recs = ref_register_tree(ref, "replica1/params", ref_params)
    assert [r.name for r in recs] == [r.name for r in ref_recs]
    assert _records(reg) == _records(ref)
    assert "replica1/params/main.b0_dense.attn.wq.w" in {r.name for r in recs}
    assert all(r.kind == "param" and r.owner == "replica1" for r in recs)
    assert all(r.site.startswith("test_torch_objects.py:") for r in recs)
    for r, q in zip(recs, ref_recs):
        t = r.reader()
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), np.asarray(q.reader()))
        assert object_digest(t) == ref_digest(q.reader())
    assert register_tree(None, "x", pt_params) == []   # registry off


# ----------------------------------------------------------------------
# Content digest: the reference's for the same bytes, shape and dtype
# ----------------------------------------------------------------------
def _shared_arrays(dtype: str, n: int):
    """(reference numpy array, port tensor) with the same bytes."""
    rng = np.random.RandomState(n)
    if dtype == "int32":
        a = rng.randint(-2**31, 2**31 - 1, size=n, dtype=np.int64)
        a = a.astype(np.int32)
        return a, torch.from_numpy(a.copy())
    a = rng.standard_normal(n).astype(np.float32)
    if dtype == "float32":
        return a, torch.from_numpy(a.copy())
    b = a.astype(ml_dtypes.bfloat16)
    bits = b.view(np.uint16).astype(np.int16)
    return b, torch.from_numpy(bits.copy()).view(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("n,shape", [(100, (100,)), (96, (8, 12)),
                                     (1 << 14, (1 << 14,)),   # 32/64 KiB
                                     (1 << 16, (256, 256)),   # sampled
                                     (50001, (50001,))])      # sampled
def test_object_digest_equals_reference(dtype, n, shape):
    a, t = _shared_arrays(dtype, n)
    a, t = a.reshape(shape), t.reshape(shape)
    want = ref_digest(a)
    assert object_digest(t) == want            # tensor, device path
    assert object_digest(a) == want            # numpy, the reference's
    assert object_digest(t.t() if t.ndim == 2 else t) == ref_digest(
        np.ascontiguousarray(a.T) if a.ndim == 2 else a)
    other = t.clone()
    other.view(-1)[-1] += 1
    assert object_digest(other) != want         # the tail is hashed


def test_object_digest_small_and_sampled():
    rng = np.random.RandomState(0)
    small = torch.from_numpy(rng.rand(100).astype(np.float32))
    assert object_digest(small) == object_digest(small.clone())
    other = small.clone()
    other[50] += 1.0
    assert object_digest(small) != object_digest(other)
    # shape/dtype qualify the digest even for identical bytes
    assert object_digest(small) != object_digest(small.reshape(4, 25))
    assert (object_digest(torch.zeros(8, dtype=torch.float32))
            != object_digest(torch.zeros(8, dtype=torch.int32)))
    big = torch.from_numpy(rng.rand(1 << 16))        # 512 KB, float64
    assert object_digest(big) == object_digest(big.clone())
    assert object_digest(big) == ref_digest(big.numpy())
    tail = big.clone()
    tail[-1] += 1.0
    assert object_digest(big) != object_digest(tail)


# ----------------------------------------------------------------------
# Replica detector: weights duplicated across fleet replicas
# ----------------------------------------------------------------------
def test_weight_replicas_across_two_replicas():
    tree = {"wq": np.arange(64, dtype=np.float32),
            "wk": np.arange(64, dtype=np.float32) * 2}
    reg, ref = ObjectRegistry(), RefRegistry()
    pt_tree = {k: torch.from_numpy(v) for k, v in tree.items()}
    for i in range(2):
        register_tree(reg, f"replica{i}/params", pt_tree)
        ref_register_tree(ref, f"replica{i}/params", tree)
    prof, ref_prof = ReplicaDetector(reg).scan(), RefDetector(ref).scan()
    assert _groups(prof) == _groups(ref_prof)
    groups = [f for f in prof.findings if f.kind == "replica_param"]
    assert len(groups) == 2              # wq pair + wk pair
    for f in groups:
        assert f.tier == TIER_OBJECT
        assert f.count == 1 and f.bytes == 256.0
        assert f.meta["cross_replica"] is True
        assert f.meta["replicas"] == ["replica0", "replica1"]
        assert f.meta["fix"] == FIXES["replica_param"]
        assert f.meta["file"].endswith("test_torch_objects.py")
    assert cross_replica_bytes(prof, "replica_param") == 512.0 == \
        ref_cross_bytes(ref_prof, "replica_param")
    billed = {r["name"] for r in prof.top_objects()}
    assert billed == {"replica1/params/wq", "replica1/params/wk"}
    assert prof.checked == ref_prof.checked
    assert prof.flagged == ref_prof.flagged
    assert prof.totals == ref_prof.totals
    text = prof.render(by="object")
    assert "top objects by attributed waste" in text
    assert len(text.splitlines()) == len(
        ref_prof.render(by="object").splitlines())
    with pytest.raises(ValueError):
        prof.render(by="site")


def test_identical_zero_opt_state_is_replica_but_zero_kv_page_is_not():
    for zeros in (np.zeros(32, np.float32), torch.zeros(32)):
        reg = ObjectRegistry()
        reg.register("opt/m/w", "opt_state", 128, reader=lambda: zeros)
        reg.register("opt/v/w", "opt_state", 128, reader=lambda: zeros)
        reg.register("replica0/kv/page0", "kv_page", 128,
                     reader=lambda: zeros)
        reg.register("replica1/kv/page0", "kv_page", 128,
                     reader=lambda: zeros)
        prof = ReplicaDetector(reg).scan()
        # zero moments ARE the lazy-materialize finding; all-zero KV
        # pages are unwritten budget capacity, skipped
        assert {f.kind for f in prof.findings} == {"replica_opt_state"}
        assert "replica_kv_page" not in prof.checked


def test_scan_profile_merges_and_roundtrips():
    a = torch.arange(128, dtype=torch.float32)
    reg = ObjectRegistry()
    register_tree(reg, "replica0/params", {"w": a})
    register_tree(reg, "replica1/params", {"w": a})
    prof = ReplicaDetector(reg).scan()
    again = WasteProfile.from_json(prof.to_json())
    assert again.to_json() == prof.to_json()
    # the reference reads the port's profile, object table included
    assert RefProfile.from_json(prof.to_json()).to_dict() == prof.to_dict()
    merged = WasteProfile(tier=TIER_OBJECT)
    merged.merge(prof)
    merged.merge(prof)
    f = next(f for f in merged.findings if f.kind == "replica_param")
    assert f.count == 2                  # §5.6 coalescing across scans
    row = merged.top_objects(1)[0]
    assert row["waste"]["replica"] == 2 * a.nbytes
    # bills from a row dict coalesce on the same key
    merged.bill_object(row, "replica", 8.0)
    assert merged.top_objects(1)[0]["waste"]["replica"] == 2 * a.nbytes + 8


# ----------------------------------------------------------------------
# The drivers' --objects: training (scan at init) and serving
# ----------------------------------------------------------------------
def test_train_objects_scan_matches_reference():
    """The port's training driver with ``--objects`` against the
    reference's train state registered the same way: the zero moments
    are ``replica_opt_state``, the ones-initialized norm scales
    ``replica_param`` (random leaves never collide, so the groups do not
    depend on the weights)."""
    with redirect_stdout(io.StringIO()) as out:
        _, prof = pt_train.run("qwen3-1.7b", smoke=True, steps=1, batch=2,
                               seq=16, objects=True, device="cpu")
    assert "[train] object scan:" in out.getvalue()
    ref_model, _, _, _ = smoke_models()
    reg = RefRegistry()
    ref_state.create(ref_model, jax.random.PRNGKey(0), registry=reg)
    ref_scan = RefDetector(reg).scan()
    assert prof.tiers == [TIER_OBJECT]
    assert _groups(prof) == _groups(ref_scan)
    assert prof.checked == ref_scan.checked
    assert prof.flagged == ref_scan.flagged
    assert prof.totals == ref_scan.totals
    assert {f.kind for f in prof.findings} == {"replica_opt_state",
                                               "replica_param"}
    for f in prof.findings:
        if f.kind == "replica_opt_state":
            assert f.meta["file"].endswith("adamw.py")


def test_serve_objects_scan_matches_reference():
    from repro.launch import serve as ref_serve
    kw = dict(smoke=True, batch=2, prompt_len=8, gen=4, kv="paged",
              objects=True, profile=False)
    with redirect_stdout(io.StringIO()) as out:
        pt_serve.run("qwen3-1.7b", device="cpu", **kw)
    with redirect_stdout(io.StringIO()) as ref_out:
        ref_serve.run("qwen3-1.7b", **kw)

    def scan_line(text):
        return next(line for line in text.splitlines()
                    if line.startswith("[serve] object scan:"))
    assert scan_line(out.getvalue()) == scan_line(ref_out.getvalue())


# ----------------------------------------------------------------------
# Acceptance: same-burst duplicated prefixes at mismatched page
# boundaries -> cross-replica KV page replicas; content dedup -> zero
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def fleet_env():
    ref_model, ref_params, pt_model, pt_params = smoke_models()
    # every burst is a same-tick pair of duplicates; the 36-token shared
    # prefix ends mid-page (page_size 8)
    kw = dict(n_requests=6, vocab_size=ref_model.cfg.vocab_size, seed=0,
              arrival="bursty", burst_size=2, burst_gap=4,
              prompt_len=(48, 48), gen_len=(4, 4), dup_rate=1.0,
              n_prefixes=1, prefix_len=36)
    trace = make_trace(**kw)
    assert trace.to_json() == ref_make_trace(**kw).to_json()
    return {"ref": (ref_model, ref_params, RefStepCache(ref_model),
                    RefEngine, RefRouter, RefRegistry, RefDetector),
            "pt": (pt_model, pt_params, StepCache(pt_model), ServeEngine,
                   FleetRouter, ObjectRegistry, ReplicaDetector),
            "trace": trace}


def _run_fleet(env, pkg, *, dedup):
    model, params, sc, Engine, Router, Registry, Detector = env[pkg]
    trace = env["trace"]
    max_len = trace.max_prompt_len + trace.max_new_tokens + 1
    reg = Registry()
    kv = {"kv_dtype": jnp.float32 if pkg == "ref" else torch.float32}
    engines = [Engine(model, params, num_slots=2, max_len=max_len,
                      kv_layout="paged", page_size=8,
                      num_pages=4 * (-(-max_len // 8)),
                      step_cache=sc, registry=reg,
                      owner=f"replica{i}", content_dedup=dedup, **kv)
               for i in range(2)]
    fleet = Router(engines, policy="prefix", seed=0, content_dedup=dedup)
    fleet.submit_trace(trace)
    fleet.run()
    fleet.check()
    return fleet, reg, Detector(reg).scan()


def _single_outputs(env, trace):
    model, params, sc = env["pt"][:3]
    max_len = trace.max_prompt_len + trace.max_new_tokens + 1
    eng = ServeEngine(model, params, num_slots=4, max_len=max_len,
                      kv_layout="paged", page_size=8, step_cache=sc)
    for tr in sorted(trace.requests, key=lambda r: r.arrival):
        eng.submit(Request(rid=tr.rid, tokens=np.asarray(tr.tokens),
                           max_new_tokens=tr.max_new_tokens))
    eng.run()
    return {rid: list(r.generated) for rid, r in eng.finished.items()}


def _assert_same_fleet(fleet, ref_fleet):
    assert dict(fleet.stats) == dict(ref_fleet.stats)
    assert ({rid: m["replica"] for rid, m in fleet.metrics.items()}
            == {rid: m["replica"] for rid, m in ref_fleet.metrics.items()})
    for eng, ref_eng in zip(fleet.engines, ref_fleet.engines):
        assert ({k: v for k, v in eng.stats.items() if not k.endswith("_s")}
                == {k: v for k, v in ref_eng.stats.items()
                    if not k.endswith("_s")})
    assert ({rid: list(r.generated) for rid, r in fleet.finished.items()}
            == {rid: list(r.generated)
                for rid, r in ref_fleet.finished.items()})


@pytest.mark.parametrize("dedup", [False, True])
def test_fleet_kv_replicas_and_content_dedup_match_reference(fleet_env,
                                                              dedup):
    fleet, reg, scan = _run_fleet(fleet_env, "pt", dedup=dedup)
    ref_fleet, ref_reg, ref_scan = _run_fleet(fleet_env, "ref", dedup=dedup)
    _assert_same_fleet(fleet, ref_fleet)
    assert _records(reg) == _records(ref_reg)
    assert _groups(scan) == _groups(ref_scan)
    assert scan.checked == ref_scan.checked
    assert scan.flagged == ref_scan.flagged
    kv_x = cross_replica_bytes(scan, "replica_kv_page")
    assert kv_x == ref_cross_bytes(ref_scan, "replica_kv_page")
    page_bytes = fleet.engines[0].kv.alloc.page_bytes
    assert page_bytes == ref_fleet.engines[0].kv.alloc.page_bytes > 0
    if not dedup:
        kv = [f for f in scan.findings
              if f.kind == "replica_kv_page" and f.meta["cross_replica"]]
        assert kv and kv_x > 0
        for f in kv:
            # provenance points at the page allocator, the actionable site
            assert f.meta["file"].endswith("kv_cache.py")
            assert f.meta["fix"] == FIXES["replica_kv_page"]
            assert f.bytes == f.count * page_bytes
        assert fleet.stats["content_dedup_routes"] == 0
    else:
        assert kv_x == 0
        assert fleet.stats["content_dedup_routes"] >= 1
        assert sum(e.stats["dedup_deferred"] for e in fleet.engines) >= 1
        assert ({rid: list(r.generated) for rid, r in fleet.finished.items()}
                == _single_outputs(fleet_env, fleet_env["trace"]))


def test_read_page_bytes_match_reference(fleet_env):
    """A live page's reader: the reference's byte order (page p of every
    layer, k then v), a uint8 tensor; f32 pools agree within 1e-5."""
    fleet, _, _ = _run_fleet(fleet_env, "pt", dedup=False)
    ref_fleet, _, _ = _run_fleet(fleet_env, "ref", dedup=False)
    eng, ref_eng = fleet.engines[0], ref_fleet.engines[0]
    live = [p for p in range(eng.kv.num_pages)
            if eng.kv.alloc.refcount[p] > 0]
    assert live
    for p in live:
        got = eng._read_page(p)
        assert got.dtype == torch.uint8 and got.ndim == 1
        want = ref_eng._read_page(p)
        assert got.numel() == want.size == eng.kv.alloc.page_bytes
        np.testing.assert_allclose(got.numpy().view(np.float32),
                                   want.view(np.float32), rtol=1e-5,
                                   atol=1e-5)


def test_draft_window_replicas_match_reference():
    """Two speculative replicas serving the same requests hold the same
    draft window (the drafter's served corpus): one
    ``replica_draft_window`` group, as in the reference."""
    from repro.serve.engine import Request as RefRequest
    from repro.serve.spec import NGramDrafter as RefNGram
    from repro_torch.serve.spec import NGramDrafter
    ref_model, ref_params, pt_model, pt_params = smoke_models()
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, pt_model.cfg.vocab_size, 12).astype(np.int32)
               for _ in range(3)]
    scans = {}
    for pkg, (model, params, Engine, Req, Drafter, Registry, Detector,
              kv) in {
            "pt": (pt_model, pt_params, ServeEngine, Request, NGramDrafter,
                   ObjectRegistry, ReplicaDetector, torch.float32),
            "ref": (ref_model, ref_params, RefEngine, RefRequest, RefNGram,
                    RefRegistry, RefDetector, jnp.float32)}.items():
        reg = Registry()
        outs = []
        for i in range(2):
            eng = Engine(model, params, num_slots=2, max_len=24,
                         kv_layout="paged", page_size=4, kv_dtype=kv,
                         drafter=Drafter(), spec_k=2, registry=reg,
                         owner=f"replica{i}")
            for j, p in enumerate(prompts):
                eng.submit(Req(rid=f"q{j}", tokens=p.copy(),
                               max_new_tokens=4))
            eng.run()
            outs.append({rid: r.generated for rid, r in eng.finished.items()})
        assert outs[0] == outs[1]
        windows = [r for r in reg.live("draft_window")]
        assert [w.nbytes for w in windows] == [2 * 3 * 4] * 2
        scans[pkg] = (Detector(reg).scan(), outs[0])
    (scan, out), (ref_scan, ref_out) = scans["pt"], scans["ref"]
    assert out == ref_out
    assert _groups(scan) == _groups(ref_scan)
    (f,) = [f for f in scan.findings if f.kind == "replica_draft_window"]
    assert f.meta["cross_replica"] and f.meta["file"].endswith("engine.py")
