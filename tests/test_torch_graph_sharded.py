"""Tier 2 of the port under sharding: collectives as nodes of a
fake-tensor trace (``sharding/comm.py``), the traced tick of a tp_serve
engine and the traced train step under dp_tp and fsdp, on meshes with no
processes (``launch/mesh.py:Mesh(..., rank=r)``: every rank traced in
this process, no process group), against the reference.

- Each collective of ``comm`` on a fake tensor is one
  ``_c10d_functional`` node and its ``wait_tensor``, of the real call's
  result shape, its group named with its size, so the ring model's wire
  bytes are its own group's; no ``STATS`` count. The differentiable
  collectives' backwards are nodes too.
- A tp_serve engine's tick on every layout the engine serves —
  (1, 2), (2, 1), (2, 2), (1, 4), qwen3-1.7b's widened smoke config
  (every attention projection sharded) and granite-moe-3b-a800m's
  (experts over 'model'), a paged pool chunked over 'model' — traces on
  every rank: one B1 node a layer, B5 four a layer and the final norm
  (the launches of one tick), and the ranks' collectives agree.
- Against the reference, its ``lowered_tick`` and its train steps jitted
  under the strategy (``in_shardings`` from ``state_specs``) on an
  Auto-axes (1, 2) mesh of host devices in a subprocess, and the port's
  rank 0 on a (1, 2) mesh, per rank, float32, the tick of the smoke
  config ("plain") and of the widened one ("wide"), the train steps of
  the widened one (every projection sharded):
  * dot flops other than attention's (the port's attention is a kernel
    node, which counts 0 as the reference counts a custom call; the
    reference on the CPU runs XLA attention, whose products are dots
    with batch dimensions): fsdp equal exactly; the tick equal once the
    products GSPMD runs whole on every device are counted whole (the
    LM head's, and in the wide config the attention projections', which
    the port runs as column and row blocks); dp_tp equal once the
    port's recomputed logits product (the fused loss's backward
    recomputes it; XLA's CSE merges it with the forward's, and the
    port's tier 2 flags it as recompute) is taken out;
  * finding kinds other than the collective ones: the port's are the
    reference's or fewer (the reference's extra recompute findings are
    shape collisions of XLA's fusions, ROADMAP § C).
  The collective findings differ (GSPMD's collectives against the port's
  Megatron pairs): ROADMAP § C.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
from collections import Counter

import pytest
import torch

import _torch_ranks as R
from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.core.graph_cost import (GraphCostModel, collective_of,
                                         group_size)
from repro_torch.core.graph_trace import abstract_mode, trace_step
from repro_torch.core.graph_waste import analyze_waste
from repro_torch.launch.lint import _train_batch
from repro_torch.launch.mesh import Mesh
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.sharding import comm
from repro_torch.sharding.rules import make_strategy
from repro_torch.train import state as TS
from repro_torch.train.step import make_train_step, rank_batch

TESTS = pathlib.Path(__file__).resolve().parent
AXES = ("data", "model")
LAYOUTS = ((1, 2), (2, 1), (2, 2), (1, 4))
ARCHS = {"qwen-wide": ("qwen3-1.7b", R.WIDE),
         "granite": ("granite-moe-3b-a800m", {})}

_REF = r"""
import os, sys, json, dataclasses
# the backend's LLVM passes do not change the optimized HLO read here
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_backend_optimization_level=0 "
                           "--xla_llvm_disable_expensive_passes=true")
os.environ.pop("REPRO_USE_PALLAS", None)
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec
import _torch_ranks as R
from repro.configs import registry
from repro.configs.base import TrainConfig
from repro.core.hlo_cost import HloCostModel, _dot_flops
from repro.core.hlo_waste import analyze_waste
from repro.models.zoo import build_model
from repro.serve.engine import ServeEngine
from repro.sharding.rules import make_strategy
from repro.train import state as S
from repro.train.step import make_train_step


def summary(hlo):
    cm = HloCostModel(hlo)
    mult = cm._multipliers()
    dots = 0.0
    for cname, comp in cm.comps.items():
        for inst in comp.insts:
            # attention's products have batch dimensions; the rest not
            if inst.op == "dot" and "lhs_batch_dims" not in inst.line:
                dots += _dot_flops(inst, comp) * mult.get(cname, 0.0)
    rep = analyze_waste(hlo)
    return {"dots": dots,
            "findings": sorted([f.kind, f.count]
                               for f in rep.profile.findings)}


mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
out = {}
for kind in ("plain", "wide"):
    cfg = dataclasses.replace(registry.get_config("qwen3-1.7b").smoke(),
                              **R.train_overrides(kind))
    model = build_model(cfg)
    kw = dict(R.SERVE_CASES["paged"])
    kw.pop("kernel_counters")
    with mesh:
        eng = ServeEngine(model, model.init(jax.random.PRNGKey(0)),
                          num_slots=4, kv_dtype=jnp.float32,
                          strategy=make_strategy("tp_serve", mesh), **kw)
        out[f"tick-{kind}"] = summary(eng.lowered_tick().compile().as_text())
    for name in ("dp_tp", "fsdp") if kind == "wide" else ():
        strat = make_strategy(name, mesh)
        place = jax.tree_util.tree_map(
            lambda s: NamedSharding(mesh, s), S.state_specs(model, strat),
            is_leaf=lambda x: isinstance(x, PartitionSpec))
        batch = {k: jax.ShapeDtypeStruct((4, R.TRAIN_SEQ), jnp.int32)
                 for k in ("tokens", "labels")}
        with mesh:
            fn = jax.jit(make_train_step(model, TrainConfig(), strat),
                         in_shardings=(place, None),
                         out_shardings=(place, None))
            hlo = fn.lower(S.abstract(model), batch).compile().as_text()
        out[f"{name}-{kind}"] = summary(hlo)
print("REF" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REF, str(TESTS)], env=env,
                         capture_output=True, text=True, timeout=900)
    line = [s for s in res.stdout.splitlines() if s.startswith("REF")]
    assert line, res.stderr[-3000:]
    return json.loads(line[0][3:])


def _config(arch, overrides):
    return build_model(dataclasses.replace(
        registry.get_config(arch).smoke(), **{"dtype": "float32",
                                              **overrides}))


def _kinds(traced):
    return Counter(c for c in map(collective_of, traced.graph.nodes) if c)


# ----------------------------------------------------------------------
# collectives as nodes
# ----------------------------------------------------------------------
def _fake(*shape):
    with abstract_mode():
        return torch.empty(shape)


@pytest.mark.parametrize("name,kind,axes,out_shape", [
    ("all_reduce", "all-reduce", "model", (6, 8)),
    ("all_gather", "all-gather", "model", (6, 32)),
    ("all_gather0", "all-gather", ("data", "model"), (48, 8)),
    ("reduce_scatter", "reduce-scatter", "model", (6, 2)),
    ("ordered_sum", "all-gather", "data", (6, 8)),
    ("broadcast", "broadcast", ("data", "model"), (6, 8)),
])
def test_traced_collective_is_one_node_of_its_group(name, kind, axes,
                                                    out_shape):
    """On a (2, 4) mesh of no processes: the result's shape is the real
    call's, one collective node of its kind whose group names its size,
    the ring model's wire bytes over that size, nothing in STATS."""
    mesh = Mesh((2, 4), AXES, rank=5)
    calls = {
        "all_reduce": lambda t: comm.all_reduce(t, axes, mesh),
        "all_gather": lambda t: comm.all_gather(t, axes, mesh, dim=-1),
        "all_gather0": lambda t: comm.all_gather(t, axes, mesh, dim=0),
        "reduce_scatter": lambda t: comm.reduce_scatter(t, axes, mesh,
                                                        dim=1),
        "ordered_sum": lambda t: comm.ordered_sum(t, axes, mesh),
        "broadcast": lambda t: comm.broadcast(t, 1, axes, mesh),
    }
    comm.reset_stats()
    traced = trace_step(calls[name], _fake(6, 8))
    assert comm.STATS["calls"] == 0 and not comm.STATS["kinds"]
    out = [n for n in traced.graph.nodes if n.op == "output"][0]
    assert tuple(out.args[0][0].meta["val"].shape) == out_shape
    n = mesh.axis_size(axes)
    assert _kinds(traced) == Counter({(kind, n): 1})
    node = next(x for x in traced.graph.nodes if collective_of(x))
    assert group_size(comm.group_name(mesh, axes)) == n
    waits = [x for x in traced.graph.nodes
             if getattr(x.target, "__name__", "").startswith("wait_tensor")]
    assert len(waits) == 1
    res = node.meta["val"]
    nbytes = res.numel() * res.element_size()
    frac = (n - 1) / n
    want = {"all-reduce": 2 * nbytes * frac, "all-gather": nbytes * frac,
            "reduce-scatter": nbytes * (n - 1),
            "broadcast": nbytes * frac}[kind]
    assert GraphCostModel(traced).total().coll_wire_bytes == want


def test_differentiable_collectives_trace_their_backward():
    """reduce_from's forward (an ordered sum: an all-gather), copy_to's
    backward (an all-reduce) and gather_weight's forward and backward (an
    all-gather, a reduce-scatter) are nodes of a traced gradient."""
    mesh = Mesh((1, 2), AXES, rank=1)

    def f(x, w):
        x = x.detach().requires_grad_(True)
        w = w.detach().requires_grad_(True)
        with torch.enable_grad():
            h = comm.copy_to(x, "model", mesh) @ comm.gather_weight(
                w, "model", mesh, dim=0)
            y = comm.reduce_from(h, "model", mesh).sum()
            return torch.autograd.grad(y, (x, w))
    traced = trace_step(f, _fake(4, 8), _fake(4, 8))
    assert _kinds(traced) == Counter({("all-gather", 2): 2,
                                      ("all-reduce", 2): 1,
                                      ("reduce-scatter", 2): 1})


# ----------------------------------------------------------------------
# the traced tick of a tp_serve engine, every layout
# ----------------------------------------------------------------------
def _engine(model, mesh):
    params = model.abstract_params(device="cpu", mode=abstract_mode(),
                                   dtype=torch.float32)
    kw = dict(R.SERVE_CASES["paged"])
    return ServeEngine(model, params, num_slots=4, kv_dtype=torch.float32,
                       strategy=make_strategy("tp_serve", mesh), **kw)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda s: "x".join(map(
    str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_serve_tick_traces_on_every_layout(arch, layout):
    name, overrides = ARCHS[arch]
    model = _config(name, overrides)
    L = model.cfg.num_layers
    seen = []
    for rank in range(layout[0] * layout[1]):
        traced = _engine(model, Mesh(layout, AXES, rank=rank)).traced_tick()
        norms = traced.kernel_nodes()["ops.rmsnorm"]
        assert traced.kernel_nodes() == {"ops.paged_decode": L,
                                         "ops.rmsnorm": norms}
        assert norms == (4 if arch == "qwen-wide" else 2) * L + 1
        kinds = _kinds(traced)
        assert kinds and all(n > 1 for _, n in kinds)
        rep = analyze_waste(traced)
        assert rep.profile.checked["redundant_collective"] > 0
        seen.append(kinds)
    assert all(k == seen[0] for k in seen)


# ----------------------------------------------------------------------
# against the reference on a (1, 2) mesh
# ----------------------------------------------------------------------
def _port_tick(kind):
    model = _config("qwen3-1.7b", R.train_overrides(kind))
    return model, _engine(model, Mesh((1, 2), AXES, rank=0)).traced_tick()


def _port_step(kind, name):
    model = _config("qwen3-1.7b", R.train_overrides(kind))
    mode = abstract_mode()
    strat = make_strategy(name, Mesh((1, 2), AXES, rank=0))
    state = TS.shard_state(TS.abstract(model, torch.float32, device="cpu",
                                       mode=mode), model, strat)
    batch = rank_batch(_train_batch(model.cfg, 4, R.TRAIN_SEQ, mode=mode,
                                    device="cpu"), strat)
    return model, trace_step(make_train_step(model, TrainConfig(), strat),
                             state, batch)


def _non_collective_kinds(findings):
    return {k for k, _ in findings} - {"redundant_collective"}


@pytest.mark.parametrize("kind", ["plain", "wide"])
def test_tp_serve_tick_against_reference(ref, kind):
    model, traced = _port_tick(kind)
    cfg = model.cfg
    want = ref[f"tick-{kind}"]
    rep = analyze_waste(traced)
    dots = GraphCostModel(traced).total().dot_flops
    B, d, tp = 4, cfg.d_model, 2
    whole = 2 * B * d * cfg.padded_vocab                 # the head
    if kind == "wide":
        qkvo = 2 * (cfg.num_heads + cfg.num_kv_heads) * cfg.head_dim
        whole += cfg.num_layers * 2 * B * d * qkvo
    assert dots + whole * (tp - 1) / tp == want["dots"]
    assert _non_collective_kinds(
        (f.kind, f.count) for f in rep.profile.findings) <= \
        _non_collective_kinds(want["findings"])


@pytest.mark.parametrize("name", ["dp_tp", "fsdp"])
def test_sharded_train_step_against_reference(ref, name):
    model, traced = _port_step("wide", name)
    want = ref[f"{name}-wide"]
    rep = analyze_waste(traced)
    dots = GraphCostModel(traced).total().dot_flops
    recompute = sum(f.flops for f in rep.profile.findings
                    if f.kind == "recompute")
    port = {f.kind for f in rep.profile.findings}
    assert port - {"redundant_collective"} <= \
        _non_collective_kinds(want["findings"])
    if name == "fsdp":
        assert dots == want["dots"]
        assert recompute == 0
        return
    # the fused loss's backward recomputes the logits product: the
    # port's one recompute finding, of exactly that product
    cfg = model.cfg
    logits = 2 * 4 * R.TRAIN_SEQ * cfg.d_model * cfg.padded_vocab / 2
    assert recompute == logits
    assert dots - recompute == want["dots"]


def test_remat_recompute_keeps_the_sharder_off_the_forward_s_thread():
    """dp_tp on a (1, 2) mesh of no processes, the widened config under
    remat "full": the backward run on a thread that does not hold the
    sharder (as autograd's device thread of CUDA tensors does not: the
    dry run's train cell on the card found it, ROADMAP § C) recomputes
    each superblock on the forward's sharded branches, and gives the
    gradients the forward's thread gives."""
    import threading
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.sharding.ctx import sharding_ctx
    model = _config("qwen3-1.7b", R.WIDE)
    model.remat = "full"
    strat = make_strategy("dp_tp", Mesh((1, 2), AXES, rank=0))
    mode = abstract_mode()
    state = TS.shard_state(TS.abstract(model, torch.float32, device="cpu",
                                       mode=mode), model, strat)
    batch = rank_batch(_train_batch(model.cfg, 4, R.TRAIN_SEQ, mode=mode,
                                    device="cpu"), strat)

    def loss_and_leaves():
        live = tree_map(lambda t: t.detach().requires_grad_(True),
                        state.params)
        with torch.enable_grad(), sharding_ctx(strat.sharder()):
            loss, _ = model.loss(live, batch)
        return loss, tree_leaves(live)

    def grads(loss, leaves):
        return [tuple(g.shape) for g in torch.autograd.grad(
            loss, leaves, allow_unused=True) if g is not None]
    loss, leaves = loss_and_leaves()
    with sharding_ctx(strat.sharder()):
        want = grads(loss, leaves)
    got, errors = [], []
    loss, leaves = loss_and_leaves()

    def off_thread():
        try:
            got.extend(grads(loss, leaves))
        except Exception as e:     # reported below
            errors.append(repr(e))
    t = threading.Thread(target=off_thread)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive()
    assert not errors, errors
    assert got == want and len(want) > 0
