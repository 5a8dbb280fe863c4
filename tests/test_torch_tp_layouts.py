"""The rarer tensor-parallel serving layouts of the port against the
reference: ``ServeEngine(strategy=make_strategy("tp_serve", mesh))`` on
(1, 2), (2, 1), (2, 2) and (1, 4) meshes of gloo CPU ranks, in float32
with the reference's weights, on duplicated-prefix traffic
(``_torch_ranks.dup_requests``) with the tier-3 detectors and the tier-4
kernel counters.

Cases (``_torch_ranks.LAYOUT_CASES``), each on a paged pool of 32 pages
of 32 rows (chunked over 'model'): qwen3-1.7b's smoke config under
speculative rollback verify (the defer window on each rank's chunk),
granite-moe-3b-a800m's smoke config plain and under rollback verify
(its expert leaves, 4 x 64 x 64, sharded over 'model' on their experts
dim), and qwen3 with the object registry. With 'data' 2 the 4 slots run
2 a rank, the pool replicated over 'data'.

Every rank's tokens, stats, page tables, refcounts, tier-3 reports and
replica scan must equal the reference's unsharded engine's; the tier-4
kernel reports and the MoE dispatch sums (rows routed, stored, dead) the
port's unsharded engine's. The port's unsharded kernel reports equal the
reference's but in granite's rollback case, where a recomputed prefix
row is rewritten bit-identical in one framework and not in the other
(their window sums round differently, ROADMAP § C), so the silent
bytes differ already unsharded; the reference's steps are jitted, so its
``dispatch_stats`` cannot run inside them. The tokens must also equal
the reference's own tp_serve engine on an Auto-axes (2, 2) mesh of host
devices (a subprocess).
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as R
from repro.configs.base import ProfilerConfig as RefProfilerConfig
from repro.core.detectors import ServingDetectors as RefDetectors
from repro.core.objects import ObjectRegistry as RefRegistry
from repro.core.replicas import ReplicaDetector as RefReplicas
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro.serve.spec import NGramDrafter as RefNGram
from repro_torch.launch.mesh import launch

from _torch_parity import smoke_models

TESTS = pathlib.Path(__file__).resolve().parent
MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
CASES = tuple(R.LAYOUT_CASES)
TP_CASES = ("qwen-rollback", "granite-paged", "granite-rollback")
# the cases whose kernel silent-store bytes differ from the reference's
# already unsharded (see above)
KERNEL_DIFFERS = ("granite-rollback",)

_REF_TP = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.pop("REPRO_USE_PALLAS", None)
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp
from jax.sharding import AxisType
import _torch_ranks as R
from repro.configs import registry
from repro.models.zoo import build_model
from repro.serve.engine import Request, ServeEngine
from repro.serve.spec import NGramDrafter
from repro.sharding.rules import make_strategy
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
out = {}
for case in json.loads(sys.argv[2]):
    arch, spec, _ = R.LAYOUT_CASES[case]
    cfg = dataclasses.replace(
        registry.get_config(R.LAYOUT_ARCHS[arch]).smoke(), dtype="float32")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    kw = dict(R.LAYOUT_POOL)
    if spec:
        kw.update(drafter=NGramDrafter(), spec_k=R.LAYOUT_SPEC_K,
                  spec_rollback=spec == "rollback")
    with mesh:
        eng = ServeEngine(model, params, num_slots=4,
                          kv_dtype=jnp.float32,
                          strategy=make_strategy("tp_serve", mesh), **kw)
        for rid, toks, gen, arr in R.dup_requests(cfg.vocab_size):
            eng.submit(Request(rid=rid, tokens=toks, max_new_tokens=gen,
                               arrival=arr))
        eng.run(max_steps=300)
    out[case] = {k: [int(t) for t in v.generated]
                 for k, v in eng.finished.items()}
print("TOKENS" + json.dumps(out))
"""


def _ref_engine(model, params, case):
    _, spec, objects = R.LAYOUT_CASES[case]
    kw = dict(R.LAYOUT_POOL)
    if spec:
        kw.update(drafter=RefNGram(), spec_k=R.LAYOUT_SPEC_K,
                  spec_rollback=spec == "rollback")
    reg = RefRegistry() if objects else None
    det = RefDetectors(RefProfilerConfig(enabled=True, num_watchpoints=8,
                                         seed=0), sites_per_step=4)
    eng = RefEngine(model, params, num_slots=4, detectors=det,
                    kv_dtype=jnp.float32, registry=reg, **kw)
    for rid, toks, gen, arr in R.dup_requests(model.cfg.vocab_size):
        eng.submit(RefRequest(rid=rid, tokens=toks, max_new_tokens=gen,
                              arrival=arr))
    eng.run(max_steps=300)
    scan = None if reg is None else R.scan_of(RefReplicas(reg).scan())
    return R.engine_result(eng, det, scan)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's unsharded results by case, the reference tp_serve
    engine's tokens by case, {mesh: the port's per-rank results}, the
    port's unsharded results by case, with the MoE dispatch sums)."""
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"),
               JAX_PLATFORMS="cpu")
    sub = subprocess.Popen(
        [sys.executable, "-c", _REF_TP, str(TESTS), json.dumps(TP_CASES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    models = {key: smoke_models(arch=arch)
              for key, arch in R.LAYOUT_ARCHS.items()}
    hosts = {k: jax.device_get(m[1]) for k, m in models.items()}
    port = {shape: launch(R.layout_rank, shape, args=(hosts, CASES),
                          init_dir=str(tmp_path_factory.mktemp(
                              "x".join(map(str, shape)))))
            for shape in MESHES}
    refs = {case: _ref_engine(*models[R.LAYOUT_CASES[case][0]][:2], case)
            for case in CASES}
    unsharded = {}
    with R.count_dispatch() as dispatch:
        for case in CASES:
            arch = R.LAYOUT_CASES[case][0]
            for k in dispatch:
                dispatch[k] = 0
            unsharded[case] = R.engine_result(
                *R.layout_case(*models[arch][2:], case),
                dict(dispatch) if arch == "granite" else None)
    out, err = sub.communicate(timeout=900)
    line = [s for s in out.splitlines() if s.startswith("TOKENS")]
    assert line, err[-3000:]
    return refs, json.loads(line[0][len("TOKENS"):]), port, unsharded


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", CASES)
def test_tp_layout_engine_matches_reference(runs, shape, case):
    refs, _, port, unsharded = runs
    want = refs[case]
    for rank in port[shape]:
        got = rank["cases"][case]
        for key in ("tokens", "reuse", "stats", "report", "scan"):
            assert got[key] == want[key], (rank["coords"], key)
        assert got["kernel"] == unsharded[case]["kernel"]
        assert (got["pt"] == want["pt"]).all()
        assert (got["refcount"] == want["refcount"]).all()
        assert sum(got["report"]["checked"].values()) > 0
        assert got["kernel"]["checked"].get("kernel_dead_store", 0) > 0
        if R.LAYOUT_CASES[case][0] == "granite":
            assert got["dispatch"] == unsharded[case]["dispatch"]
            assert got["dispatch"]["calls"] > 0
        if R.LAYOUT_CASES[case][2]:
            assert got["scan"], "the registry case found no replicas"


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("case", CASES)
def test_tp_layout_took_its_branches(runs, shape, case):
    """The pool is chunked over 'model' (each rank 32/n pages, every
    chunk held live pages), the slots split over 'data', the experts
    sharded over 'model', and the sharded window functions ran (the
    defer one at every rollback verify)."""
    data, model = shape
    arch, spec, _ = R.LAYOUT_CASES[case]
    for rank in runs[2][shape]:
        got = rank["cases"][case]
        calls = got["calls"]
        assert got["pool_pages"] == 32
        assert got["local_pages"] == 32 // model
        assert {p // (32 // model) for p in got["live"]} == set(range(model))
        assert (calls["split"] > 0) == (data > 1)
        assert calls["verify"] > 0
        assert (calls["defer"] > 0) == (spec == "rollback")
        assert (calls["decode"] > 0) == (spec is None)
        if arch == "granite":
            assert got["experts"] == 4 // model


@pytest.mark.parametrize("case", CASES)
def test_port_unsharded_kernel_report_matches_reference(runs, case):
    """The yardstick of the kernel reports above: the port's unsharded
    engine equals the reference's (tokens and tier-3 too), its kernel
    report as well outside KERNEL_DIFFERS."""
    refs, _, _, unsharded = runs
    got, want = unsharded[case], refs[case]
    for key in ("tokens", "stats", "report", "scan"):
        assert got[key] == want[key], key
    assert (got["kernel"] == want["kernel"]) == (case not in KERNEL_DIFFERS)


def test_dense_token_loop_with_data_split_matches_reference(runs):
    """``make_serve_step`` of qwen3's smoke config (the dense family, one
    write index for the batch) with the slots over 'data' (the layouts
    with 'data' 2): the forward runs each rank's block of the slots and
    stores the other ranks' rows, as the engine's does; its logits within
    1e-5 of the largest of the reference's unsharded loop, the greedy
    tokens equal. A token loop's scalar index could not take the other
    ranks' rows before (the trace of the dry run's decode cell found it,
    ROADMAP § C)."""
    ref_model, ref_params = smoke_models(arch=R.LAYOUT_ARCHS["qwen"])[:2]
    toks, _ = R.loop_inputs(ref_model.cfg)
    cache = ref_model.init_cache(ref_params, R.LOOP_BATCH, R.LOOP_LEN,
                                 kv_dtype=jnp.float32)
    tok, logits, out = jnp.asarray(toks), [], []
    for _ in range(R.LOOP_STEPS):
        lg, cache = ref_model.decode_step(ref_params, cache, tok)
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
        out.append(np.asarray(tok))
    want, want_tokens = np.stack(logits), np.concatenate(out, axis=1)
    split = [s for s in MESHES if s[0] > 1]
    assert split
    for shape in split:
        for rank in runs[2][shape]:
            got, tokens, splits = rank["loop"]
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * float(np.abs(want).max()))
            np.testing.assert_array_equal(tokens, want_tokens)
            assert splits > 0
    for shape in MESHES:
        if shape[0] == 1:
            assert all(r["loop"] is None for r in runs[2][shape])


def test_tp_layout_tokens_match_the_reference_tp_serve_engine(runs):
    refs, ref_tp, port, _ = runs
    for case in TP_CASES:
        assert ref_tp[case] == refs[case]["tokens"]
        for shape in MESHES:
            for rank in port[shape]:
                assert rank["cases"][case]["tokens"] == ref_tp[case]
