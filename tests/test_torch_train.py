"""The PyTorch port's training slice against the reference on the CPU:
the schedule, AdamW and clipping, the losses, the data stream, the smoke
models' forward/loss/gradients with the reference's weights, whole train
steps from one state carried across by ``train.state.from_reference``,
the training detectors, the SARIF rules and ``launch.train``. The smoke
models are qwen3-1.7b's (dense), granite-moe-3b-a800m's (moe: the router
weight's gradient through the top-K, and at a capacity factor of 0.25
the scatter dispatch's gradient where tokens drop) and zamba2-1.2b's
(hybrid, at 14 layers: two superblocks of six Mamba2 blocks and the
shared block, then a tail of two).

Tolerances (float32 unless said otherwise):
- lr: 1e-6 relative (the same f32 formula, libm cos vs XLA's);
- AdamW, clipping, int8 compression, losses: 1e-6 relative (elementwise
  f32 arithmetic in the same order; sums in another order);
- forward logits within 1e-4 (as the model tests); loss within 1e-5;
  gradients within 1e-4 of each leaf's largest gradient magnitude (two
  layers of backward f32 sums in other orders);
- train steps: loss and grad norm within 1e-5 relative per step, the
  grad norm within 1e-4 under int8 compression (the quantizer rounds
  g / scale to an integer: an element within float noise of a .5
  boundary rounds the other way in one framework and moves by one
  quantum, 1/127 of its leaf's largest magnitude); with bfloat16 compute
  params (as ``launch.train.run`` uses them), loss within 1e-4 and grad
  norm within 1e-2 relative (the two frameworks round activations and
  bf16 gradients at different places; the smoke loss is ~5.5 and a bf16
  ulp there is 3e-2, so 1e-4 is well inside one rounding); master
  params after the last step within 2 * lr per step taken with an
  update: Adam moves an element whose gradient is near 0 by about +-lr
  whatever the gradient's size, so a sign that rounds the other way in
  one framework differs by up to 2 * lr there; the hybrid's grad norm
  within 1e-3 relative: its gradient (norm ~50, clipped to 1) runs
  through the SSD's exp of cumulative sums, so one step's f32 sums in
  another order already give ~1e-5, and those sign flips then grow the
  difference step over step (to ~4e-4 at the 5th step) while its losses
  stay within 2e-6;
- detector findings, paths, steps and counters equal exactly;
- ``moe_aux`` as the loss (a sum of f32 means).
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import ProfilerConfig as RefProfilerConfig
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core.detectors import TrainingDetectors as RefDetectors
from repro.core.findings import Finding as RefFinding
from repro.core.findings import WasteProfile as RefProfile
from repro.core.sarif import to_sarif as ref_to_sarif
from repro.data.synthetic import stream as ref_stream
from repro.optim import adamw as ref_adamw
from repro.optim.schedule import lr_at as ref_lr_at
from repro.train import fused_xent as ref_fused_xent
from repro.train import loss as ref_loss
from repro.train import state as ref_state
from repro.train import step as ref_step
from repro_torch.configs.base import ProfilerConfig, TrainConfig
from repro_torch.core import detectors as pt_detectors
from repro_torch.core.findings import Finding, WasteProfile
from repro_torch.core.sarif import to_sarif
from repro_torch.data.pipeline import Prefetcher
from repro_torch.data.synthetic import stream
from repro_torch.launch import train as pt_train
from repro_torch.models import layers
from repro_torch.models import moe as pt_moe
from repro_torch.models import params as P
from repro_torch.optim import adamw
from repro_torch.optim.schedule import lr_at
from repro_torch.train import fused_xent, loss as pt_loss
from repro_torch.train import state as pt_state
from repro_torch.train import step as pt_step

from _torch_parity import smoke_models, to_np

GRANITE, ZAMBA = "granite-moe-3b-a800m", "zamba2-1.2b"


def _models(case: str = "qwen3", dtype: str = "float32"):
    """smoke_models of a named case: "qwen3" (dense), "granite" (moe),
    "granite-drop" (moe at a capacity factor of 0.25, so tokens drop),
    "granite-einsum" (moe through the one-hot einsum dispatch), "zamba2"
    (hybrid, 8 layers: a superblock of six Mamba2 blocks and the shared
    block, then a tail of two, as the full config has them)."""
    if case == "qwen3":
        return smoke_models(dtype)
    if case.startswith("granite"):
        from repro_torch.configs import registry
        moe = registry.get_config(GRANITE).smoke().moe
        over = {"granite": {}, "granite-drop": {"capacity_factor": 0.25},
                "granite-einsum": {"dispatch": "einsum"}}[case]
        return smoke_models(dtype, arch=GRANITE,
                            moe=dataclasses.replace(moe, **over))
    assert case == "zamba2", case
    return smoke_models(dtype, arch=ZAMBA, num_layers=8)


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"b": {"w": rng.standard_normal((3, 5)).astype(np.float32),
                  "s": np.abs(rng.standard_normal(5)).astype(np.float32)},
            "a": rng.standard_normal((7,)).astype(np.float32)}


def _torch_tree(tree):
    return P.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_lr_schedule_matches_reference():
    kw = dict(learning_rate=3e-4, warmup_steps=5, total_steps=40)
    ref_tc, tc = RefTrainConfig(**kw), TrainConfig(**kw)
    assert float(lr_at(tc, 0)) == 0.0
    for step in range(45):
        _close(lr_at(tc, step), ref_lr_at(ref_tc, step))
        _close(lr_at(tc, torch.tensor(step, dtype=torch.int32)),
               ref_lr_at(ref_tc, step))


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_adamw_update_and_clip_match_reference(max_norm):
    ref_tc, tc = RefTrainConfig(), TrainConfig()
    master, grads = _tree(0), P.tree_map(lambda a: 3 * a, _tree(1))
    m, v = _tree(2), P.tree_map(np.abs, _tree(3))
    want_g, want_norm = ref_adamw.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
    got_g = _torch_tree(grads)
    got_norm = adamw.clip_by_global_norm_(got_g, max_norm)
    _close(got_norm, want_norm)
    want = dict(pt_detectors._leaf_paths(want_g))
    for path, g in pt_detectors._leaf_paths(got_g):
        _close(g, want[path])
    step, lr = 3, 1e-3
    want_p, want_s = ref_adamw.update(
        ref_tc, want_g, ref_adamw.AdamWState(m=m, v=v), master,
        jnp.float32(lr), jnp.int32(step))
    state = adamw.AdamWState(m=_torch_tree(m), v=_torch_tree(v))
    got_p, got_s = adamw.update(tc, got_g, state, _torch_tree(master),
                                torch.tensor(lr), torch.tensor(step))
    for got, want in ((got_p, want_p), (got_s.m, want_s.m),
                      (got_s.v, want_s.v)):
        want = dict(pt_detectors._leaf_paths(want))
        for path, g in pt_detectors._leaf_paths(got):
            _close(g, want[path], atol=1e-7)


def test_sliced_update_and_in_place_clip_equal_whole_leaves(monkeypatch):
    """The update and the in-place clip take a leaf in slices of at most
    ``SLICE`` elements along its first dimension (the f32 temporaries of
    a stacked expert leaf stay small): every operation is elementwise,
    so the values are the whole-leaf ones bit for bit."""
    rng = np.random.default_rng(8)

    def tree():
        return {"w": torch.from_numpy(rng.standard_normal(
                    (7, 5, 9)).astype(np.float32)),
                "v": torch.from_numpy(rng.standard_normal(300).astype(
                    np.float32)),
                "s": torch.tensor(0.5)}
    grads, master, m = tree(), tree(), tree()
    v = P.tree_map(torch.abs, tree())
    copy = lambda t: P.tree_map(torch.clone, t)       # noqa: E731
    out = {}
    for slice_ in (adamw.SLICE, 40):
        monkeypatch.setattr(adamw, "SLICE", slice_)
        g = copy(grads)
        norm = adamw.clip_by_global_norm_(g, 1.0)
        state = adamw.AdamWState(m=copy(m), v=copy(v))
        p, state = adamw.update(TrainConfig(), g, state, copy(master),
                                torch.tensor(1e-3), torch.tensor(2))
        out[slice_] = [norm] + P.tree_leaves(g) + P.tree_leaves(p) + \
            P.tree_leaves(state.m) + P.tree_leaves(state.v)
    whole, sliced = out.values()
    assert all(torch.equal(a, b) for a, b in zip(whole, sliced))


def test_int8_gradient_compression_matches_reference():
    g = np.random.default_rng(4).standard_normal((6, 9)).astype(np.float32)
    want = ref_step._compress_int8_ef(jnp.asarray(g))
    _close(pt_step._compress_int8_ef(torch.from_numpy(g)), want)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_losses_match_reference(z_loss):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 5, 300)).astype(np.float32) * 3
    labels = rng.integers(0, 300, (2, 5)).astype(np.int32)
    want, want_m = ref_loss.cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels), z_loss)
    got, got_m = pt_loss.cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(labels), z_loss)
    _close(got, want)
    assert sorted(got_m) == sorted(want_m)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal((300, 16)).astype(np.float32)
    want = ref_fused_xent.lm_loss(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(labels), z_loss=z_loss)
    got = fused_xent.lm_loss(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(labels), z_loss=z_loss)
    _close(got, want)


def test_stream_batches_byte_equal():
    ref_model, _, pt_model, _ = smoke_models()
    want = ref_stream(ref_model.cfg, 3, 80, seed=2, start_step=1)
    got = Prefetcher(stream(pt_model.cfg, 3, 80, seed=2, start_step=1))
    for _ in range(3):
        w, g = next(want), next(got)
        assert sorted(w) == sorted(g)
        for key in w:
            assert g[key].dtype == w[key].dtype
            assert g[key].tobytes() == w[key].tobytes()
    got.close()


def _batch(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("case,B,S", [
    pytest.param("qwen3", 2, 16, id="2-16"),
    pytest.param("qwen3", 1, 1024, id="1-1024"),
    pytest.param("granite", 2, 16, id="granite-2-16"),
    pytest.param("granite-drop", 2, 32, id="granite-drop-2-32"),
    pytest.param("zamba2", 2, 16, id="zamba2-2-16")])
def test_forward_loss_and_grads_match_reference(case, B, S, monkeypatch):
    """At Skv >= 1024 the reference's attention is flash_xla (its
    hand-written VJP), below it the masked softmax composition. The MoE
    cases compare ``moe_aux`` and the router's gradient too; in
    "granite-drop" tokens do drop at capacity."""
    ref_model, ref_params, pt_model, pt_params = _models(case)
    keeps = []
    route = pt_moe._route

    def watched(*args, **kwargs):
        out = route(*args, **kwargs)
        keeps.append(bool(out[3].all()))
        return out
    monkeypatch.setattr(pt_moe, "_route", watched)
    b = _batch(ref_model.cfg.vocab_size, B, S, seed=S)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want_logits, want_aux = ref_model.forward(ref_params, jb["tokens"])
    got_logits, aux = pt_model.forward(pt_params, tb["tokens"])
    _close(got_logits, want_logits, rtol=1e-4, atol=1e-4)
    _close(aux, want_aux, rtol=1e-5)
    assert (float(aux) == 0.0) == (pt_model.cfg.moe is None)
    eval_logits, _ = pt_step.make_eval_step(pt_model)(pt_params, tb)
    assert torch.equal(eval_logits, got_logits)
    if case == "granite-drop":
        assert not all(keeps), keeps

    (want_loss, want_m), want_g = jax.value_and_grad(
        ref_model.loss, has_aux=True)(ref_params, jb)
    live = P.tree_map(lambda t: t.clone().requires_grad_(True), pt_params)
    got_loss, got_m = pt_model.loss(live, tb)
    got_g = torch.autograd.grad(got_loss, P.tree_leaves(live))
    _close(got_loss, want_loss, rtol=1e-5)
    _close(got_m["nll"], want_m["nll"], rtol=1e-5)
    _close(got_m["moe_aux"], want_m["moe_aux"], rtol=1e-5)
    want_leaves = dict(pt_detectors._leaf_paths(want_g))
    got_leaves = dict(pt_detectors._leaf_paths(_like(live, got_g)))
    assert sorted(got_leaves) == sorted(want_leaves)
    for path, w in want_leaves.items():
        w = np.asarray(w)
        _close(got_leaves[path], w, rtol=0, atol=1e-4 * np.abs(w).max())


def _like(tree, leaves):
    it = iter(leaves)
    return P.tree_map(lambda _: next(it), tree)


def _report(rep):
    """A detector report as comparable plain data."""
    return (sorted((f.kind, f.c1, f.step, f.count, f.bytes)
                   for f in rep.findings),
            dict(rep.checked), dict(rep.flagged))


def _train_case(case, *values):
    """A train-step case; qwen3's keep their ids of before."""
    ident = "-".join(str(v) for v in values)
    return pytest.param(case, *values, id=ident if case == "qwen3"
                        else f"{case}-{ident}")


@pytest.mark.parametrize(
    "case,dtype,microbatches,compression,loss_rtol,gnorm_rtol",
    [_train_case("qwen3", "float32", 1, "none", 1e-5, 1e-5),
     _train_case("qwen3", "float32", 2, "none", 1e-5, 1e-5),
     _train_case("qwen3", "float32", 1, "int8_ef", 1e-5, 1e-4),
     _train_case("qwen3", "bfloat16", 1, "none", 1e-4, 1e-2),
     _train_case("granite", "float32", 1, "none", 1e-5, 1e-5),
     _train_case("granite-drop", "float32", 1, "none", 1e-5, 1e-5),
     _train_case("zamba2", "float32", 1, "none", 1e-5, 1e-3)])
def test_train_steps_match_reference(case, dtype, microbatches, compression,
                                     loss_rtol, gnorm_rtol):
    """>= 4 steps of the reference's jitted step and the port's step from
    one state (f32 master and moments, compute params in ``dtype``), on
    the same stream batches, with the training detectors watching both."""
    steps, lr = 5, 3e-4
    ref_model, _, pt_model, _ = _models(case, dtype)
    kw = dict(learning_rate=lr, total_steps=steps, warmup_steps=1,
              microbatches=microbatches, remat="none",
              grad_compression=compression)
    ref_fn = jax.jit(ref_step.make_train_step(ref_model, RefTrainConfig(**kw)))
    pt_fn = pt_step.make_train_step(pt_model, TrainConfig(**kw))
    rs = ref_state.create(ref_model, jax.random.PRNGKey(0),
                          compute_dtype=jnp.dtype(dtype))
    ps = pt_state.from_reference(jax.device_get(rs), device="cpu")
    ref_det = RefDetectors(RefProfilerConfig(enabled=True))
    pt_det = pt_detectors.TrainingDetectors(ProfilerConfig(enabled=True))
    data = stream(pt_model.cfg, 4, 32, seed=0)
    moved = 0.0
    for step in range(steps):
        b = next(data)
        ref_det.on_batch(step, b)
        pt_det.on_batch(step, b)
        before_r, before_p = rs.params, ps.params
        rs, rm = ref_fn(rs, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pt_fn(ps, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "nll"):
            _close(pm[key], rm[key], rtol=loss_rtol)
        _close(pm["grad_norm"], rm["grad_norm"], rtol=gnorm_rtol)
        _close(pm["lr"], rm["lr"])
        _close(pm["moe_aux"], rm["moe_aux"], rtol=loss_rtol)
        assert (float(rm["moe_aux"]) == 0.0) == (pt_model.cfg.moe is None)
        ref_det.on_step(step, before_r, rs.params)
        pt_det.on_step(step, before_p, ps.params)
        moved += 2 * float(rm["lr"])
    assert int(ps.step) == int(rs.step) == steps
    assert moved > 0
    want_master = dict(pt_detectors._leaf_paths(rs.master))
    for path, got in pt_detectors._leaf_paths(ps.master):
        _close(got, want_master[path], rtol=0, atol=moved)
    assert _report(pt_det.report) == _report(ref_det.report)
    assert pt_det.report.checked["silent_param_store"] > 0


def test_detectors_match_reference_on_fixed_trees():
    """Silent and changed leaves, all-zero gradient leaves, a repeated
    batch: the same findings, paths, steps and counters."""
    ref_det = RefDetectors(RefProfilerConfig(enabled=True), leaves_per_step=3)
    pt_det = pt_detectors.TrainingDetectors(ProfilerConfig(enabled=True),
                                            leaves_per_step=3)
    before = _tree(0)
    for step in range(6):
        after = P.tree_map(lambda a: a.copy(), before)
        after["b"]["w"] = after["b"]["w"] * (1.0 + 0.5 * (step % 2))
        after["a"] = after["a"] * 1.001
        grads = P.tree_map(np.zeros_like, before)
        grads["b"]["s"] = grads["b"]["s"] + step
        batch = _batch(50, 2, 4, seed=step % 3)
        ref_det.on_batch(step, batch)
        pt_det.on_batch(step, batch)
        ref_det.on_step(step, jax.tree_util.tree_map(jnp.asarray, before),
                        jax.tree_util.tree_map(jnp.asarray, after),
                        grads=jax.tree_util.tree_map(jnp.asarray, grads))
        pt_det.on_step(step, _torch_tree(before), _torch_tree(after),
                       grads=_torch_tree(grads))
        before = after
    assert _report(pt_det.report) == _report(ref_det.report)
    assert {f.kind for f in pt_det.report.findings} == {
        "silent_param_store", "dead_grad_store", "silent_data_load"}


def test_leaf_paths_follow_jax_keystr_order():
    _, ref_params, _, pt_params = smoke_models()
    want = [(jax.tree_util.keystr(k), v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(ref_params)[0]]
    got = [(p, tuple(t.shape)) for p, t in
           pt_detectors._leaf_paths(pt_params)]
    assert got == want


def test_sarif_training_rules_match_reference():
    kinds = ("silent_param_store", "dead_grad_store", "silent_data_load")
    ref_prof, prof = RefProfile(tier=3), WasteProfile(tier=3)
    for i, kind in enumerate(kinds):
        path = f"['main']['w{i}']"
        ref_prof.add(RefFinding(kind=kind, tier=3, c1=(path,), step=i,
                                bytes=100.0 * (i + 1), meta={"path": path}))
        prof.add(Finding(kind=kind, tier=3, c1=(path,), step=i,
                         bytes=100.0 * (i + 1), meta={"path": path}))
    want = ref_to_sarif(ref_prof)["runs"][0]
    got = to_sarif(prof)["runs"][0]
    rules = {r["id"]: r for r in got["tool"]["driver"]["rules"]}
    ref_rules = {r["id"]: r for r in want["tool"]["driver"]["rules"]}
    assert sorted(rules) == sorted(ref_rules) == sorted(kinds)
    for kind in kinds:
        for key in ("shortDescription", "fullDescription", "help"):
            assert rules[kind].get(key) == ref_rules[kind].get(key), key
    assert [r["ruleId"] for r in got["results"]] == \
        [r["ruleId"] for r in want["results"]]


def test_train_driver_on_cpu_profiles_and_writes_sarif(tmp_path):
    out = tmp_path / "train.sarif"
    prof_out = tmp_path / "train.json"
    losses, merged = pt_train.run("qwen3-1.7b", smoke=True, steps=4,
                                  batch=2, seq=32, profile=True,
                                  device="cpu", sarif_out=str(out),
                                  profile_out=str(prof_out))
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert merged.tiers == [3]
    assert merged.checked["silent_data_load"] == 8
    assert merged.checked["silent_param_store"] > 0
    doc = json.loads(out.read_text())
    rule_ids = {r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]}
    assert rule_ids == {f.kind for f in merged.findings} and rule_ids
    assert json.loads(prof_out.read_text())["tiers"] == [3]


def test_train_driver_needs_cuda_and_rejects_unported_options(monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt_train.run("qwen3-1.7b", smoke=True, steps=1)
    for flag in ("--strategy=fsdp", "--remat=some"):
        monkeypatch.setattr(sys, "argv", ["train", "--arch", "qwen3-1.7b",
                                          flag])
        with pytest.raises(SystemExit):
            pt_train.main()
    # --objects, --waste-report and the checkpoint options are ported:
    # they parse, and the run then needs CUDA
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flag in ("--objects", "--waste-report", "--ckpt-dir=x", "--resume",
                 "--ckpt-every=3"):
        monkeypatch.setattr(sys, "argv", ["train", "--arch", "qwen3-1.7b",
                                          flag])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt_train.main()


def _remat_steps(model, state, remat, steps=3):
    """``steps`` port train steps under ``remat`` from a copy of
    ``state``: the per-step (loss, nll, grad norm) and the final state."""
    tc = TrainConfig(learning_rate=3e-4, total_steps=steps, warmup_steps=1,
                     remat=remat)
    fn = pt_step.make_train_step(model, tc)
    assert model.remat == remat
    copy = lambda tree: P.tree_map(torch.clone, tree)
    state = pt_state.TrainState(
        params=copy(state.params), master=copy(state.master),
        opt=adamw.AdamWState(m=copy(state.opt.m), v=copy(state.opt.v)),
        step=state.step.clone())
    data = stream(model.cfg, 4, 32, seed=0)
    rows = []
    for _ in range(steps):
        b = next(data)
        state, m = fn(state, {k: torch.from_numpy(v) for k, v in b.items()})
        rows.append((m["loss"], m["nll"], m["grad_norm"]))
    return rows, state


class _CountOps(TorchDispatchMode):
    """Counts the aten ops that run under it, by name."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func)] = self.n.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


def _remat_grads(model, params, remat, monkeypatch):
    """Loss and gradients of one batch with ``model.remat`` set, with the
    norms, the 2-D matmuls and the batched products run in the forward
    and backward counted."""
    model.remat = remat
    b = next(stream(model.cfg, 4, 32, seed=1))
    live = P.tree_map(lambda t: t.detach().requires_grad_(True), params)
    norms = [0]
    apply_rmsnorm = layers.apply_rmsnorm

    def counted(*args, **kwargs):
        norms[0] += 1
        return apply_rmsnorm(*args, **kwargs)
    monkeypatch.setattr(layers, "apply_rmsnorm", counted)
    with _CountOps() as ops:
        loss, _ = model.loss(live, {k: torch.from_numpy(v) for k, v in
                                    b.items()})
        grads = torch.autograd.grad(loss, P.tree_leaves(live))
    monkeypatch.setattr(layers, "apply_rmsnorm", apply_rmsnorm)
    return (loss, grads, norms[0], ops.n["aten.mm.default"],
            ops.n.get("aten.bmm.default", 0))


# per superblock: (norms, projection matmuls "full" recomputes). Dense:
# ln1, ln2, q- and k-norm; q, k, v, o, gate, up (the down projection's
# output is read by no backward, so recomputation stops before it).
# MoE: ln1, ln2; q, k, v, o, router. Hybrid: per Mamba2 block ln and the
# gate norm, in_proj and out_proj, then the shared dense block's ln1 and
# ln2 and its q, k, v, o, gate, up. Outside them: the final norm, and
# the hybrid tail's 2 blocks (not checkpointed, as in the reference).
REMAT_COUNTS = {"qwen3": (4, 6), "granite": (2, 5), "granite-einsum": (2, 5),
                "zamba2": (6 * 2 + 2, 6 * 2 + 6)}


@pytest.mark.parametrize("case,remat", [
    pytest.param(case, remat, id=remat if case == "qwen3"
                 else f"{case}-{remat}")
    for case in REMAT_COUNTS for remat in ("full", "dots")])
def test_remat_equals_none_bit_for_bit(case, remat, monkeypatch):
    """Activation checkpointing recomputes each superblock's forward in
    the backward; the recomputation repeats the same float32 operations,
    so the loss and every gradient of a batch, and the losses, grad
    norms and master params of 3 train steps, equal those without it bit
    for bit. Both modes recompute every norm inside the superblocks;
    "full" recomputes the projection matmuls too, up to the last one
    whose output the backward reads, "dots" keeps them (the reference's
    ``checkpoint_dots_with_no_batch_dims``) and recomputes every batched
    product as "full" does: attention's, the MoE experts' ``bmm``s and
    the einsum dispatch's and combine's, the SSD's einsums."""
    _, _, model, params = _models(case)
    want_loss, want_grads, want_norms, want_mm, want_bmm = _remat_grads(
        model, params, "none", monkeypatch)
    loss, grads, norms, mm, bmm = _remat_grads(model, params, remat,
                                               monkeypatch)
    assert torch.equal(loss, want_loss)
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        assert torch.equal(g, w)
    n_super, tail = model.sched.n_super, len(model.sched.tail)
    per_norms, per_mm = REMAT_COUNTS[case]
    assert want_norms == per_norms * n_super + 2 * tail + 1
    assert norms == want_norms + per_norms * n_super
    assert mm == want_mm + (per_mm * n_super if remat == "full" else 0)
    _, _, _, _, full_bmm = _remat_grads(model, params, "full", monkeypatch)
    assert bmm == full_bmm > want_bmm
    s0 = pt_state.create(model, 0, compute_dtype=torch.float32,
                         device="cpu")
    want = _remat_steps(model, s0, "none")
    got = _remat_steps(model, s0, remat)
    for a, b in zip(got[0], want[0]):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), (a, b)
    for g, w in zip(P.tree_leaves(got[1].master),
                    P.tree_leaves(want[1].master)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_train_steps_match_reference(remat):
    """The port's step under ``remat`` against the reference's jitted
    step with the same ``remat`` (``jax.checkpoint`` with its policy),
    from one state: loss and grad norm within 1e-5 relative per step, as
    ``test_train_steps_match_reference`` holds "none"."""
    steps = 3
    ref_model, _, pt_model, _ = smoke_models("float32")
    kw = dict(learning_rate=3e-4, total_steps=steps, warmup_steps=1,
              remat=remat)
    ref_fn = jax.jit(ref_step.make_train_step(ref_model, RefTrainConfig(**kw)))
    pt_fn = pt_step.make_train_step(pt_model, TrainConfig(**kw))
    rs = ref_state.create(ref_model, jax.random.PRNGKey(0),
                          compute_dtype=jnp.float32)
    ps = pt_state.from_reference(jax.device_get(rs), device="cpu")
    data = stream(pt_model.cfg, 4, 32, seed=0)
    for _ in range(steps):
        b = next(data)
        rs, rm = ref_fn(rs, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pt_fn(ps, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "nll", "grad_norm"):
            _close(pm[key], rm[key], rtol=1e-5)


def test_default_train_config_trains():
    """``TrainConfig()`` (remat "dots", as the reference's default) makes
    a step that runs, and the driver takes ``remat``."""
    assert TrainConfig().remat == "dots"
    _, _, model, _ = smoke_models("float32")
    state = pt_state.create(model, 0, compute_dtype=torch.float32,
                            device="cpu")
    b = next(stream(model.cfg, 2, 16, seed=0))
    state, m = pt_step.make_train_step(model, TrainConfig())(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    assert np.isfinite(float(m["loss"])) and int(state.step) == 1
    losses, _ = pt_train.run("qwen3-1.7b", smoke=True, steps=2, batch=2,
                             seq=16, remat="dots", device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
