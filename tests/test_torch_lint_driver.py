"""The port's zoo lint driver (``repro_torch.launch.lint``) and the
abstract trees it traces: every smoke config's train step, decode step or
engine tick and prefill lint on fake tensors, each kernel entry point is
one node of the graph (its backward another), the waiver baseline round
trips, the SARIF export is valid with the tier-0 findings' physical
locations, and no tensor of the program is allocated.

The train subject runs the default remat ("dots"): its graph holds the
recompute, so the kernels' forward nodes outnumber their backward ones.
The sequence is cut to 8 tokens here (the driver's default is 32): the
sLSTM's token loop makes xlstm's step ~2 k nodes a token.
"""
import json
import os

import pytest
import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensor
from torch.profiler import ProfilerActivity, profile

from repro.configs import registry as ref_registry
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.core.findings import TIER_STATIC
from repro_torch.core.graph_trace import abstract_mode, trace_program
from repro_torch.core.sarif import to_sarif
from repro_torch.launch import lint
from repro_torch.models.params import tree_leaves
from repro_torch.models.zoo import build_model
from repro_torch.train import state as TS

SEQ, MAX_LEN = 8, 12
# kernel entry points of each family's steps (dense = every attention
# family: the flash kernel in training, RMSNorm everywhere)
NO_ATTENTION = ("xlstm-1.3b",)


def _lint(arch, **kw):
    return lint.lint_config(arch, seq=SEQ, max_len=MAX_LEN, device="cpu",
                            **kw)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_every_smoke_config_lints_its_three_subjects(arch):
    train, decode, prefill = _lint(arch)
    engine = registry.get_config(arch).family in ("dense", "moe")
    assert train.meta["subject"] == f"{arch}:train_step"
    assert decode.meta["subject"] == (f"{arch}:engine_tick" if engine
                                      else f"{arch}:decode_step")
    assert prefill.meta["subject"] == (f"{arch}:engine_prefill" if engine
                                       else f"{arch}:prefill")
    for prof in (train, decode, prefill):
        assert prof.tiers == [TIER_STATIC] and prof.meta["nodes"] > 0
        assert sum(prof.checked.values()) > 0
    # the kernels: one node a call, the backward its own node
    tk = train.meta["kernel_nodes"]
    assert tk["ops.rmsnorm"] > tk["ops.rmsnorm.bwd"] > 0      # recompute
    if arch not in NO_ATTENTION:
        assert tk["ops.attention"] > tk["ops.attention.bwd"] > 0
    assert decode.meta["kernel_nodes"]["ops.rmsnorm"] > 0
    assert prefill.meta["kernel_nodes"]["ops.rmsnorm"] > 0
    assert "ops.attention.bwd" not in decode.meta["kernel_nodes"]


def test_registry_helpers_match_the_reference():
    assert registry.ARCH_IDS == ref_registry.ARCH_IDS
    assert [(a, s.name, ok, why) for a, _, s, ok, why in
            registry.all_cells()] == \
        [(a, s.name, ok, why) for a, _, s, ok, why in
         ref_registry.all_cells()]
    for s in SHAPES:
        assert registry.get_shape(s.name) is s
    assert sorted(registry.paper_suite()) == \
        sorted(ref_registry.paper_suite())


def test_abstract_trees_match_init():
    """``abstract_params`` and ``TS.abstract`` have ``init``'s and
    ``create``'s leaves, shapes and dtypes, as fake tensors."""
    model = build_model(registry.get_config("granite-moe-3b-a800m").smoke())
    mode = abstract_mode()
    real = TS.create(model, 0, device="cpu")
    fake = TS.abstract(model, device="cpu", mode=mode)
    for r_tree, f_tree in zip(real, fake):
        rl, fl = pytree.tree_leaves(r_tree), pytree.tree_leaves(f_tree)
        assert len(rl) == len(fl)
        for r, f in zip(rl, fl):
            assert isinstance(f, FakeTensor)
            assert (f.shape, f.dtype, f.device) == (r.shape, r.dtype,
                                                    r.device)
    params = model.abstract_params(device="cpu", mode=mode)
    assert [t.shape for t in tree_leaves(params)] == \
        [t.shape for t in tree_leaves(real.master)]


def test_kernel_nodes_are_single_nodes_named_as_tier_one():
    """Under a trace each entry point is one node ``ops.<name>``; the
    flash kernel's backward is ``ops.attention.bwd``."""
    from repro_torch.kernels import ops

    def step(q, k, v, x, s):
        q = q.detach().requires_grad_(True)
        with torch.enable_grad():
            y = ops.attention(q, k, v).sum() + ops.rmsnorm(x, s).sum()
            return torch.autograd.grad(y, q)
    mode = abstract_mode()
    with mode:
        q, k, v = (torch.empty(2, 8, 4, 16) for _ in range(3))
        x, s = torch.empty(2, 8, 16), torch.empty(16)
    traced = trace_program(step, q, k, v, x, s)
    assert traced.kernel_nodes() == {"ops.attention": 1,
                                     "ops.attention.bwd": 1,
                                     "ops.rmsnorm": 1}


def test_baseline_round_trip(tmp_path, capsys):
    path = str(tmp_path / "baseline.json")
    kw = dict(subjects=("train", "decode"), device="cpu")
    merged, code = lint.run(["granite-moe-3b-a800m"], baseline=path,
                            update_baseline=True, **kw)
    assert code == 0 and merged.findings
    with open(path) as fh:
        doc = json.load(fh)
    assert len(doc["waivers"]) == len(merged.findings)
    again, code = lint.run(["granite-moe-3b-a800m"], baseline=path, **kw)
    assert code == 0
    assert f"{len(again.findings)} waived, 0 NEW" in capsys.readouterr().out
    # a finding the baseline does not waive fails the gate
    doc["waivers"] = doc["waivers"][1:]
    with open(path, "w") as fh:
        json.dump(doc, fh)
    _, code = lint.run(["granite-moe-3b-a800m"], baseline=path, **kw)
    assert code == 1


def test_sarif_is_valid_with_physical_locations(tmp_path):
    sarif = str(tmp_path / "lint.sarif")
    merged, code = lint.run(["granite-moe-3b-a800m"], sarif_out=sarif,
                            subjects=("train",), device="cpu")
    assert code == 0
    with open(sarif) as fh:
        doc = json.load(fh)
    assert doc == to_sarif(merged, src_root=os.getcwd())
    run = doc["runs"][0]
    assert doc["version"] == "2.1.0"
    rules = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert len(run["results"]) == len(merged.findings)
    located = 0
    for res in run["results"]:
        assert res["ruleId"] in rules
        phys = res["locations"][0].get("physicalLocation")
        if phys is not None:
            assert phys["artifactLocation"]["uri"].endswith(".py")
            assert phys["region"]["startLine"] > 0
            located += 1
    assert located == sum(1 for f in merged.findings if "file" in f.meta)
    assert located > 0


def test_lint_allocates_no_tensor_of_the_program():
    """Every value in the traces is a fake tensor; the CPU allocator sees
    only a few scalar constants, a fraction of the parameters' bytes."""
    lint.lint_config("qwen3-1.7b", subjects=("decode",), device="cpu")
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        lint.lint_config("qwen3-1.7b", seq=SEQ, max_len=MAX_LEN,
                         device="cpu")
    allocated = sum(e.cpu_memory_usage for e in prof.key_averages()
                    if e.cpu_memory_usage > 0)
    model = build_model(registry.get_config("qwen3-1.7b").smoke())
    params = model.abstract_params(device="cpu", mode=abstract_mode())
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    assert allocated < 64 * 1024 and 8 * allocated < param_bytes
