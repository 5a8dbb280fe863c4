"""Tensor-parallel serving of the port (``ServeEngine(strategy=
make_strategy("tp_serve", mesh))``) on 2 and 4 gloo CPU ranks against
the reference: qwen3-1.7b's smoke config in float32 with the
reference's weights, on duplicated-prefix traffic (prefix reuse, copies
on write whose source and destination lie on different ranks, slot
recycling), with the tier-3 detectors and the tier-4 kernel counters.

Cases (``_torch_ranks.SERVE_CASES``): a paged pool of 32 pages of 32
rows (1024 positions: chunked by pages, 16 or 8 a rank), a dense cache
of 1024 positions (chunked by positions), the paged pool under
speculative overwrite verify, and the paged pool with the smoke config
widened (d_model 256, 8 heads over 4 kv heads of 32, d_ff 512), where
every attention projection is sharded (the smoke config's stay whole:
each is under 16 Ki elements), so the column-parallel q/k/v and the
row-parallel output projection run sharded. Every rank's tokens, stats, page tables,
refcounts, detector and kernel-counter reports must equal the
reference's unsharded engine's (the kernel counters of the overwrite
case the port's unsharded engine's: there the two frameworks' silent
counts differ already unsharded); the paged tokens must also equal the
reference's own tp_serve engine on an Auto-axes (1, 4) mesh of host
devices (a subprocess). Each rank's leaves must equal its slice of the
reference's tree, and the sharded functions must have run. Each
engine's traced tick has the collectives and kernel calls of one real
tick.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

import _torch_ranks as R
from repro.configs.base import ProfilerConfig as RefProfilerConfig
from repro.core.detectors import ServingDetectors as RefDetectors
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro.serve.spec import NGramDrafter as RefNGram
from repro_torch.launch.mesh import launch

from _torch_parity import smoke_models

TESTS = pathlib.Path(__file__).resolve().parent
RANKS = (2, 4)
CASES = tuple(R.SERVE_CASES)

_REF_TP = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.pop("REPRO_USE_PALLAS", None)
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
import _torch_ranks as R
from repro.configs import registry
from repro.models.zoo import build_model
from repro.serve.engine import Request, ServeEngine
from repro.sharding.rules import make_strategy
cfg = dataclasses.replace(registry.get_config("qwen3-1.7b").smoke(),
                          dtype="float32")
model = build_model(cfg)
params = model.init(jax.random.PRNGKey(0))
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
kw = dict(R.SERVE_CASES["paged"])
with mesh:
    eng = ServeEngine(model, params, num_slots=4, kv_dtype=jnp.float32,
                      strategy=make_strategy("tp_serve", mesh), **kw)
    for rid, toks, gen, arr in R.dup_requests(cfg.vocab_size):
        eng.submit(Request(rid=rid, tokens=toks, max_new_tokens=gen,
                           arrival=arr))
    eng.run(max_steps=300)
print("TOKENS" + json.dumps({k: [int(t) for t in v.generated]
                             for k, v in eng.finished.items()}))
"""


def _ref_engine(model, params, case):
    kw = dict(R.SERVE_CASES[case])
    kw.pop("config", None)
    if kw.pop("spec", False):
        kw.update(drafter=RefNGram(), spec_k=3, spec_rollback=False)
    det = RefDetectors(RefProfilerConfig(enabled=True, num_watchpoints=8,
                                         seed=0), sites_per_step=4)
    eng = RefEngine(model, params, num_slots=4, detectors=det,
                    kv_dtype=jnp.float32, **kw)
    for rid, toks, gen, arr in R.dup_requests(model.cfg.vocab_size):
        eng.submit(RefRequest(rid=rid, tokens=toks, max_new_tokens=gen,
                              arrival=arr))
    eng.run(max_steps=300)
    return eng, det


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference unsharded engines by case, the reference tp_serve
    engine's tokens, {n: the port's per-rank results}, the port's
    unsharded overwrite engine's kernel report)."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"),
               JAX_PLATFORMS="cpu")
    sub = subprocess.Popen([sys.executable, "-c", _REF_TP, str(TESTS)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    ref_model, ref_params, pt_model, pt_params = smoke_models()
    wide_model, wide_params, _, _ = smoke_models(**R.WIDE)
    models = {"plain": (ref_model, ref_params),
              "wide": (wide_model, wide_params)}
    hosts = {k: jax.device_get(p) for k, (_, p) in models.items()}
    port = {n: launch(R.serve_rank, (1, n), args=(hosts, CASES),
                      init_dir=str(tmp)) for n in RANKS}
    refs = {case: _ref_engine(*models[R.serve_config(case)], case)
            for case in CASES}
    # the port's unsharded overwrite engine: its kernel silent-store
    # bytes are the yardstick there (see test_tp_serve_engine_...)
    eng, det = R.serve_case(pt_model, pt_params, "overwrite")
    eng.run(max_steps=300)
    unsharded = R.report_of(det.kernel)
    out, err = sub.communicate(timeout=900)
    line = [s for s in out.splitlines() if s.startswith("TOKENS")]
    assert line, err[-3000:]
    return refs, json.loads(line[0][len("TOKENS"):]), port, unsharded


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case", CASES)
def test_tp_serve_engine_matches_reference(runs, n, case):
    refs, _, port, unsharded = runs
    ref, det = refs[case]
    want_stats = {k: v for k, v in ref.stats.items()
                  if k not in ("prefill_s", "decode_s", "draft_s",
                               "verify_s")}
    for rank in port[n]:
        got = rank["cases"][case]
        assert got["tokens"] == {k: v.generated
                                 for k, v in ref.finished.items()}
        assert got["reuse"] == {k: v.reuse_len
                                for k, v in ref.finished.items()}
        assert got["stats"] == want_stats
        assert got["report"] == R.report_of(det.report)
        assert sum(got["report"]["checked"].values()) > 0
        assert got["held"], "leaves differ from their slice of the tree"
        if ref.paged:
            assert (got["pt"] == ref.kv.pt).all()
            assert (got["refcount"] == ref.kv.alloc.refcount).all()
            # under overwrite verify some recomputed rows are rewritten
            # with bit-identical values in one framework and not in the
            # other (their kernels round differently), so there the
            # kernel counters are held to the port's unsharded engine:
            # the sharded one counts the same silent elements
            want = (unsharded if case == "overwrite"
                    else R.report_of(det.kernel))
            assert got["kernel"] == want
            assert got["kernel"]["checked"].get("kernel_dead_store", 0) > 0


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case", CASES)
def test_tp_serve_took_the_sharded_path(runs, n, case):
    """The pools are chunked (each rank holds 1/n), the sharded functions
    ran, every rank's chunk held live pages, and some copy on write
    crossed ranks; the wide config's attention projections are blocks."""
    port = runs[2]
    kw = R.SERVE_CASES[case]
    for rank in port[n]:
        got = rank["cases"][case]
        calls = got["calls"]
        if kw["kv_layout"] == "paged":
            pages = kw["num_pages"]
            assert got["sharder"] == (pages, None)
            assert got["local_shape"][1] == pages // n
            assert calls["verify" if case == "overwrite" else
                         "decode"] > 0
            assert calls["verify"] > 0 and calls["dense"] == 0
            chunk = pages // n
            assert {p // chunk for p in got["live"]} == set(range(n))
            assert any(s // chunk != d // chunk for s, d in got["cows"])
            assert got["cows"]
        else:
            assert got["sharder"] == (None, kw["max_len"])
            assert got["local_shape"][2] == kw["max_len"] // n
            assert calls["dense"] > 0
            assert calls["decode"] == calls["verify"] == 0
        wide = R.serve_config(case) == "wide"
        assert got["sharded_attn"] == (["wk", "wo", "wq", "wv"] if wide
                                       else [])


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case", CASES)
def test_tp_serve_traced_tick_equals_its_collectives_and_kernel_calls(
        runs, n, case):
    """The engine's traced tick (ROADMAP A11d) against one real tick of
    the same engine, every slot active: its collective nodes by kind
    equal the collectives the tick ran on this rank (``comm.STATS``), its
    kernel nodes the kernel calls (a B1 a layer on a chunked pool, B5
    four a layer and the final norm)."""
    layers = runs[0][case][0].model.cfg.num_layers
    for rank in runs[2][n]:
        tick = rank["cases"][case]["tick"]
        assert tick["nodes"] == tick["collectives"]
        assert tick["nodes"]
        assert tick["kernel_nodes"] == tick["kernel_calls"]
        assert tick["kernel_nodes"]["ops.rmsnorm"] == 4 * layers + 1
        if R.SERVE_CASES[case]["kv_layout"] == "paged":
            assert tick["kernel_nodes"]["ops.paged_decode"] == layers


def test_tp_serve_tokens_match_the_reference_tp_serve_engine(runs):
    refs, ref_tp, port, _ = runs
    want = {k: v.generated for k, v in refs["paged"][0].finished.items()}
    assert ref_tp == want
    for n in RANKS:
        for rank in port[n]:
            assert rank["cases"]["paged"]["tokens"] == ref_tp
