"""The sharded train step of the port (``make_train_step(strategy=)``,
``launch.train.run(strategy=, mesh=)``) on 2 and 4 gloo CPU ranks, on
(1, 2) and (2, 2) meshes, under dp_tp and fsdp, against the port's
unsharded step, the reference's unsharded step and the reference's own
sharded step.

Two configs of qwen3-1.7b's smoke model, float32 (``_torch_ranks``):
"wide" (d_model 256, 8 heads over 4 kv heads of 32, d_ff 512: every
attention projection, MLP leaf and the embedding shard under dp_tp, so
the column- and row-parallel branches and the vocab-parallel loss run
sharded with their backward collectives) and "plain" (the smoke config
as it is: its attention leaves stay replicated, its MLP and embedding
shard). Every case starts from the reference's state (``TrainState``
from ``repro.train.state.create``, key 0, float32 compute params) and
takes 3 steps of the default ``TrainConfig`` (remat "dots", warm-up),
one case with 2 microbatches and one with int8 gradient compression, on
the stream's seeded batches, each rank on its rows.

Tolerances:
- loss and nll 1e-5 relative, grad norm 1e-5 (1e-4 under int8: the
  quantizer rounds at .5 boundaries, ROADMAP § C), lr equal: the same
  arithmetic with the batch's sums split over ranks and the collectives'
  float32 sums in another order;
- master params and moments, gathered whole, against the unsharded
  step's: within 1e-5 of each leaf's largest magnitude (float32 sums in
  another order); under int8, master within 2 * lr per step (an element
  whose quantized gradient rounds the other way moves by up to 2 * lr
  under Adam) and moments within 1/127 of the leaf's largest (one
  quantum of the gradient);
- the tier-3 findings equal exactly: each rank counts its blocks and the
  counts are summed, so the fractions are the whole leaves' (the
  reference's unsharded run for the default cases, the port's unsharded
  run for the others);
- against the reference's sharded step (jitted with ``in_shardings``
  from ``state_specs`` on an Auto-axes (2, 2) mesh of host devices, in
  one subprocess): loss and grad norm 1e-5 relative.
The driver (``run(strategy="dp_tp", mesh=)``) resumes bit for bit, and
its checkpoint restores in the unsharded port; the eval step's logits
of each rank's rows equal the unsharded forward's within 1e-5 of the
largest logit. The vlm and audio families under both strategies and the
hybrid and ssm families under fsdp take 2 f32 steps of their smoke
configs on 2 ranks against the port's unsharded steps (loss and grad
norm 1e-5 relative, master 1e-5 of each leaf's largest); the MoE family
under both and the hybrid and ssm families under dp_tp are
test_torch_train_families_sharded.py's, and take one step each here on
the one-rank host mesh through the driver. The wide config's default
cases' last step is also traced
on fake tensors first: its collective nodes by kind equal the collectives that
step ran (``comm.STATS``), its forward kernel nodes its kernel calls.
"""
import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro.configs import registry as ref_registry
from repro.configs.base import ProfilerConfig as RefProfilerConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core.detectors import TrainingDetectors as RefDetectors
from repro.data.synthetic import stream as ref_stream
from repro.models.zoo import build_model as ref_build
from repro.train import state as ref_state
from repro.train import step as ref_step
from repro_torch.checkpoint.checkpointer import Checkpointer, flatten
from repro_torch.launch import train as pt_train
from repro_torch.launch.mesh import launch
from repro_torch.models.zoo import build_model
from repro_torch.configs import registry
from repro_torch.train import state as TS

TESTS = pathlib.Path(__file__).resolve().parent
MESHES = ((1, 2), (2, 2))
CASES = tuple(R.TRAIN_CASES)

_REF_SHARDED = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.pop("REPRO_USE_PALLAS", None)
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec
import _torch_ranks as R
from repro.configs import registry
from repro.configs.base import TrainConfig
from repro.data.synthetic import stream
from repro.models.zoo import build_model
from repro.sharding.rules import make_strategy
from repro.train import state as S
from repro.train.step import make_train_step
cfg = dataclasses.replace(registry.get_config("qwen3-1.7b").smoke(),
                          **R.train_overrides("wide"))
model = build_model(cfg)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
out = {}
for name in ("dp_tp", "fsdp"):
    strat = make_strategy(name, mesh)
    specs = S.state_specs(model, strat)
    place = jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, PartitionSpec))
    with mesh:
        st = jax.device_put(S.create(model, jax.random.PRNGKey(0),
                                     compute_dtype=jnp.float32), place)
        fn = jax.jit(make_train_step(model, TrainConfig(), strat),
                     in_shardings=(place, None), out_shardings=(place, None))
        data = stream(cfg, 4, R.TRAIN_SEQ, seed=0)
        rows = []
        for _ in range(R.TRAIN_STEPS):
            st, m = fn(st, {k: jnp.asarray(v) for k, v in next(data).items()})
            rows.append([float(m["loss"]), float(m["grad_norm"])])
    out[name] = rows
print("ROWS" + json.dumps(out))
"""


def _ref_model(kind):
    return ref_build(dataclasses.replace(
        ref_registry.get_config("qwen3-1.7b").smoke(),
        **R.train_overrides(kind)))


def _ref_run(model, rs):
    """The reference's unsharded default-config case: rows and report."""
    fn = jax.jit(ref_step.make_train_step(model, RefTrainConfig()))
    det = RefDetectors(RefProfilerConfig(enabled=True))
    data = ref_stream(model.cfg, 4, R.TRAIN_SEQ, seed=0)
    rows = []
    for step in range(R.TRAIN_STEPS):
        b = next(data)
        det.on_batch(step, b)
        before = rs.params
        rs, m = fn(rs, {k: jnp.asarray(v) for k, v in b.items()})
        det.on_step(step, before, rs.params)
        rows.append(tuple(float(m[k]) for k in ("loss", "nll", "grad_norm",
                                                "lr")))
    return rows, R.report_of(det.report)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference rows and reports of the default cases by config, the
    port's unsharded results by case, {mesh: per-rank results, and
    "families": the family cases' per-rank results}, the reference's
    sharded rows, the driver's checkpoint root)."""
    tmp = tmp_path_factory.mktemp("train_sharded")
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"),
               JAX_PLATFORMS="cpu")
    sub = subprocess.Popen([sys.executable, "-c", _REF_SHARDED, str(TESTS)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    hosts, ref = {}, {}
    for kind in ("wide", "plain"):
        model = _ref_model(kind)
        rs = ref_state.create(model, jax.random.PRNGKey(0),
                              compute_dtype=jnp.float32)
        h = jax.device_get(rs)
        hosts[kind] = {"params": h.params, "master": h.master,
                       "m": h.opt.m, "v": h.opt.v, "step": int(h.step)}
        ref[kind] = _ref_run(model, rs)
    ckpt_root = str(tmp / "ckpt")
    port = {shape: launch(R.train_rank, shape, args=(
        hosts, CASES, ckpt_root if shape == (1, 2) else None),
        init_dir=str(tmp)) for shape in MESHES}
    port["families"] = launch(R.family_rank, (1, 2),
                              args=(R.FAMILY_CASES,), init_dir=str(tmp))
    unsharded = {}
    for case in CASES:
        kind = R.TRAIN_CASES[case][0]
        unsharded[case] = R.train_case(R.port_train_model(kind),
                                       R.port_state(hosts[kind]), case)
    out, err = sub.communicate(timeout=900)
    line = [s for s in out.splitlines() if s.startswith("ROWS")]
    assert line, err[-3000:]
    return ref, unsharded, port, json.loads(line[0][4:]), ckpt_root


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol)


def _mesh_id(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("case", CASES)
def test_sharded_steps_match_unsharded(runs, case, shape):
    _, unsharded, port, _, _ = runs
    want = unsharded[case]
    int8 = case.endswith("int8")
    lr_moved = 2 * sum(r[3] for r in want["rows"])
    for rank in port[shape]:
        got = rank["cases"][case]
        g, w = np.array(got["rows"]), np.array(want["rows"])
        _close(g[:, :2], w[:, :2], 1e-5)
        _close(g[:, 2], w[:, 2], 1e-4 if int8 else 1e-5)
        assert (g[:, 3] == w[:, 3]).all()
        assert sorted(got["state"]) == sorted(want["state"])
        for key, ws in want["state"].items():
            gs = got["state"][key]
            big = float(np.abs(ws).max()) if ws.size else 0.0
            if not int8:
                atol = 1e-5 * big
            elif key.startswith((".master", ".params")):
                atol = lr_moved
            else:
                atol = big / 127
            np.testing.assert_allclose(gs, ws, rtol=0, atol=atol,
                                       err_msg=key)


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("case", R.TRACED_CASES)
def test_sharded_step_nodes_equal_its_collectives_and_kernel_calls(
        runs, case, shape):
    """The last step traced on fake tensors before it ran (ROADMAP A11d):
    its collective nodes by kind equal the collectives the real step ran
    on this rank (``comm.STATS``), and its forward kernel nodes the
    kernel entry points it called."""
    for rank in runs[2][shape]:
        step = rank["cases"][case]["step"]
        assert step["nodes"] == step["collectives"]
        assert step["nodes"]
        assert step["kernel_nodes"] == step["kernel_calls"]
        assert step["kernel_nodes"]["ops.attention"] > 0


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("case", ["wide-dp_tp", "wide-fsdp", "plain-dp_tp",
                                  "plain-fsdp"])
def test_sharded_eval_step_matches_unsharded(runs, case, shape):
    """make_eval_step(strategy=): each rank's logits of its rows, every
    vocab entry whole, equal the unsharded forward's rows within 1e-5 of
    the largest logit (after the same steps)."""
    _, unsharded, port, _, _ = runs
    want = unsharded[case]["logits"]
    for rank in port[shape]:
        got = rank["cases"][case]["logits"]
        i, n = rank["cases"][case]["block"]
        b = want.shape[0] // n
        np.testing.assert_allclose(
            got, want[i * b:(i + 1) * b], rtol=0,
            atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("case", CASES)
def test_sharded_detectors_match_reference(runs, case, shape):
    """The tier-3 findings of each rank equal the reference's unsharded
    run (default cases) or the port's unsharded run (microbatches, int8),
    and something was checked."""
    ref, unsharded, port, _, _ = runs
    kind, _, fields, _ = R.TRAIN_CASES[case]
    want = ref[kind][1] if not fields else unsharded[case]["report"]
    for rank in port[shape]:
        got = rank["cases"][case]["report"]
        assert got == want
        assert got["checked"]["silent_param_store"] > 0
    if not fields:
        assert unsharded[case]["report"] == want
        rows, wrows = np.array(unsharded[case]["rows"]), np.array(ref[kind][0])
        _close(rows[:, :3], wrows[:, :3], 1e-5)


@pytest.mark.parametrize("shape", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("kind", ["wide", "plain"])
@pytest.mark.parametrize("strategy", ["dp_tp", "fsdp"])
def test_sharded_state_layout(runs, strategy, kind, shape):
    """Each rank's params, master and moments are its state_specs
    blocks; under either strategy the wide config shards every projection
    leaf and the embedding, the plain config only the MLP and the
    embedding (its attention leaves are under 16 Ki elements)."""
    port = runs[2]
    case = f"{kind}-{strategy}"
    layouts = [r["cases"][case]["layout"] for r in port[shape]]
    lay = layouts[0]
    print(f"{case} on {shape}: {len(lay['sharded'])} of {lay['leaves']} "
          f"param leaves sharded: {lay['sharded']}")
    assert all(x["held"] for x in layouts)
    assert all(x["sharded"] == lay["sharded"] for x in layouts)
    names = set()
    for key in lay["sharded"]:
        parts = re.findall(r"\['(\w+)'\]", key)
        names.add(parts[-2] if parts[-1] == "w" else parts[-1])
    proj = {"wq", "wk", "wv", "wo"} if kind == "wide" else set()
    assert names == proj | {"up", "gate", "down", "embed"}, names


@pytest.mark.parametrize("strategy", ["dp_tp", "fsdp"])
def test_sharded_steps_match_the_reference_sharded_step(runs, strategy):
    _, _, port, ref_sharded, _ = runs
    want = np.array(ref_sharded[strategy])
    for rank in port[(2, 2)]:
        got = np.array(rank["cases"][f"wide-{strategy}"]["rows"])[:, [0, 2]]
        _close(got, want, 1e-5)


def test_sharded_driver_resumes_bit_exact_and_restores_unsharded(runs):
    """run(strategy="dp_tp", mesh=) on 2 ranks: 2 steps, a save and a
    resume of 2 give the 4 straight steps' losses bit for bit and the
    same checkpoint; the checkpoint (whole leaves, written by rank 0)
    restores in the unsharded port; the profile is the same on both
    ranks and equal to the unsharded driver's."""
    _, _, port, _, root = runs
    drivers = [r["driver"] for r in port[(1, 2)]]
    for d in drivers:
        assert d["first"] + d["second"] == d["straight"]
        assert d["report"] == drivers[0]["report"]
        assert d["report"]["checked"]["silent_param_store"] > 0
    model = build_model(registry.get_config("qwen3-1.7b").smoke())
    template = TS.create(model, 0, device="cpu")
    a = Checkpointer(os.path.join(root, "straight")).restore(template)
    b = Checkpointer(os.path.join(root, "resumed")).restore(template)
    assert int(a.step) == int(b.step) == 4
    fa, fb = flatten(a), flatten(b)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
    losses, prof = pt_train.run("qwen3-1.7b", smoke=True, steps=4, batch=4,
                                seq=32, seed=7, device="cpu", profile=True)
    np.testing.assert_allclose(drivers[0]["straight"], losses, rtol=1e-4)
    assert R.report_of(prof) == drivers[0]["report"]


@pytest.mark.parametrize("arch,strategy", R.FAMILY_CASES)
def test_sharded_families_match_unsharded(runs, arch, strategy):
    """The vlm and audio families under both strategies and the hybrid
    and ssm families under fsdp, 2 f32 steps of
    its smoke config on 2 ranks: loss and grad norm within 1e-5
    relative, the master within 1e-5 of each leaf's largest magnitude,
    of the port's unsharded steps (held to the reference by each
    family's own tests)."""
    rows, master = R.family_steps(arch)
    for rank in runs[2]["families"]:
        got_rows, got = rank[f"{arch}-{strategy}"]
        _close(got_rows, rows, 1e-5)
        assert sorted(got) == sorted(master)
        for key, want in master.items():
            np.testing.assert_allclose(
                got[key], want, rtol=0,
                atol=1e-5 * float(np.abs(want).max()), err_msg=key)


def test_sharded_driver_options_name_their_roadmap_items():
    kw = dict(smoke=True, steps=1, batch=2, seq=32, device="cpu",
              strategy="dp_tp")
    # the object registry runs under a strategy (ROADMAP A11c): on the
    # one-rank host mesh its scan is the unsharded driver's
    scans = [pt_train.run("qwen3-1.7b", objects=True, **k)[1]
             for k in (kw, {k: v for k, v in kw.items() if k != "strategy"})]
    assert [sorted((f.kind, f.count, f.bytes) for f in p.findings)
            for p in scans] == [sorted((f.kind, f.count, f.bytes)
                                       for f in scans[1].findings)] * 2
    assert scans[1].findings
    # the waste report of a sharded step (ROADMAP A11d): on the one-rank
    # host mesh the step's kernel nodes are the unsharded step's, and its
    # one finding is the fused loss's recomputed logits product (dp_tp
    # takes the vocab-parallel loss, whose backward recomputes it)
    reports = [pt_train.run("qwen3-1.7b", waste_report=True, **k)[1]
               for k in (kw, {k: v for k, v in kw.items()
                              if k != "strategy"})]
    assert [p.tiers for p in reports] == [[2], [2]]
    assert reports[0].meta["kernel_nodes"] == reports[1].meta["kernel_nodes"]
    assert [(f.kind, f.count) for f in reports[0].findings] == \
        [("recompute", 2)]
    assert "fused_xent.py" in reports[0].findings[0].c1[0]
    assert reports[1].findings == []
    # every family trains under both strategies (ROADMAP A11e): on the
    # one-rank host mesh a step's losses are the unsharded driver's
    fam = dict(kw, seq=16)
    unsharded = {k: v for k, v in fam.items() if k != "strategy"}
    want = {}
    for arch, strategy in (("granite-moe-3b-a800m", "dp_tp"),
                           ("granite-moe-3b-a800m", "fsdp"),
                           ("zamba2-1.2b", "dp_tp"),
                           ("xlstm-1.3b", "dp_tp")):
        losses, _ = pt_train.run(arch, **dict(fam, strategy=strategy))
        if arch not in want:
            want[arch] = pt_train.run(arch, **unsharded)[0]
        np.testing.assert_allclose(losses, want[arch], rtol=1e-6,
                                   err_msg=arch)
    losses, _ = pt_train.run("qwen3-1.7b", **kw)
    want, _ = pt_train.run("qwen3-1.7b", **{k: v for k, v in kw.items()
                                            if k != "strategy"})
    np.testing.assert_allclose(losses, want, rtol=1e-6)
