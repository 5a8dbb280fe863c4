"""The port's production dry run (``repro_torch.launch.{specs,roofline,
dryrun}``, ``models/zoo.py:model_flops_per_token``) against the
reference's, on the CPU.

Held exactly equal to the reference:
- ``model_flops_per_token`` and ``count_params_analytic`` (all and
  active) for every arch;
- ``ideal_kernel_bytes`` for every applicable arch x shape cell and
  ``ideal_paged_attention_bytes`` on a grid of pools;
- ``roofline_terms`` on one cost dict, the port's constants set to the
  reference's v5e ones for the comparison (the port's are the H100's);
- ``batch_specs`` and ``decode_inputs``: every leaf's shape and dtype,
  for every applicable cell. The caches' trees are laid out alike but
  for the ssm family, whose recurrent states the reference keeps as
  tuples and the port as dicts: an mLSTM block's index 0, 1, 2 maps to
  keys "C", "n", "m", an sLSTM block's 0, 1, 2, 3 to "c", "n", "m",
  "h".

The dry run itself, at the smoke configs on a (2, 2) mesh with no
processes (every rank traced, fake CPU tensors): each cell is "ok"; the
ranks' dot flops summed equal the unsharded cell's (a (1, 1) mesh)
exactly under fsdp, whose compute is data-parallel over every rank, and
within [1, 1.25] of it under dp_tp and tp_serve, where the smoke
config's attention projections (under 16 Ki elements, so replicated by
sharding/rules.py) run again on each 'model' rank (measured 1.19 train,
1.18 prefill, 1.003 decode). ``main`` records every cell of the smoke
configs "ok" on the production mesh's rank 0, the MoE family's train and
prefill cells included.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import SHAPES_BY_NAME as REF_SHAPES
from repro.launch import roofline as ref_rl
from repro.launch import specs as ref_specs
from repro.models import zoo as ref_zoo
from repro_torch.checkpoint.checkpointer import flatten
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.core.graph_trace import abstract_mode, trace_step
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as RL
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import Mesh
from repro_torch.models import zoo
from repro_torch.sharding import comm
from repro_torch.sharding.rules import make_strategy, map2, spec_axes
from repro_torch.train import state as TS

ARCHS = tuple(registry.ARCH_IDS)
CELLS = [(a, s) for a in ARCHS for s in SHAPES_BY_NAME
         if registry.cell_applicable(registry.get_config(a),
                                     SHAPES_BY_NAME[s])[0]]
DECODE_CELLS = [(a, s) for a, s in CELLS
                if SHAPES_BY_NAME[s].kind == "decode"]
# the ssm family's recurrent states: the reference's tuple index -> key
SSM_STATE = {"_mlstm": ("C", "n", "m"), "_slstm": ("c", "n", "m", "h")}


def _ref_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = jax.tree_util.keystr(path)
        for block, names in SSM_STATE.items():
            for i, name in enumerate(names):
                if block in key and key.endswith(f"[{i}]"):
                    key = key[:-len(f"[{i}]")] + f"[{name!r}]"
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _port_leaves(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in flatten(tree).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_param_counts_equal_reference(arch):
    ref, port = ref_registry.get_config(arch), registry.get_config(arch)
    assert zoo.model_flops_per_token(port) == \
        ref_zoo.model_flops_per_token(ref)
    for active in (False, True):
        assert zoo.count_params_analytic(port, active_only=active) == \
            ref_zoo.count_params_analytic(ref, active_only=active)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_ideal_kernel_bytes_equal_reference(arch, shape):
    assert RL.ideal_kernel_bytes(registry.get_config(arch),
                                 SHAPES_BY_NAME[shape]) == \
        ref_rl.ideal_kernel_bytes(ref_registry.get_config(arch),
                                  REF_SHAPES[shape])


def test_ideal_paged_attention_bytes_equal_reference():
    rng = np.random.default_rng(0)
    for _ in range(40):
        kw = dict(batch=int(rng.integers(1, 65)),
                  q_len=int(rng.choice([1, 5, 9, 128])),
                  mapped_pages=int(rng.integers(0, 4097)),
                  max_pages=int(rng.integers(1, 257)),
                  page_size=int(rng.choice([8, 16, 32])),
                  num_heads=32, num_kv_heads=int(rng.choice([1, 8, 32])),
                  head_dim=int(rng.choice([64, 128])),
                  kv_bytes=float(rng.choice([2.0, 4.0])),
                  act_bytes=float(rng.choice([2.0, 4.0])),
                  materialize=bool(rng.integers(0, 2)))
        assert RL.ideal_paged_attention_bytes(**kw) == \
            ref_rl.ideal_paged_attention_bytes(**kw)


def test_roofline_terms_equal_reference_on_its_constants(monkeypatch):
    """The same formulas: with the port's constants set to the
    reference's v5e ones (its ICI rate as the network's), equal terms;
    with the H100's, the same cost gives shorter times."""
    cost = {"flops": 3.1e15, "bytes accessed": 7.7e11}
    args = (2.5e10, 256, 4.4e17, 3.3e12)
    h100 = RL.roofline_terms(cost, *args)
    monkeypatch.setattr(RL, "PEAK_FLOPS", ref_rl.PEAK_FLOPS)
    monkeypatch.setattr(RL, "HBM_BW", ref_rl.HBM_BW)
    monkeypatch.setattr(RL, "NIC_BW", ref_rl.ICI_BW)
    assert RL.roofline_terms(cost, *args) == ref_rl.roofline_terms(cost,
                                                                   *args)
    assert RL.roofline_terms(cost, *args[:2]) == \
        ref_rl.roofline_terms(cost, *args[:2])
    v5e = ref_rl.roofline_terms(cost, *args)
    assert h100["t_compute_s"] < v5e["t_compute_s"]
    assert h100["t_memory_s"] < v5e["t_memory_s"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_specs_equal_reference(arch, shape):
    ref = ref_specs.batch_specs(ref_registry.get_config(arch),
                                REF_SHAPES[shape])
    port = SP.batch_specs(registry.get_config(arch), SHAPES_BY_NAME[shape],
                          device="cpu")
    assert _port_leaves(port) == _ref_leaves(ref)
    assert SP.encoder_len(registry.get_config(arch), SHAPES_BY_NAME[shape]) \
        == ref_specs.encoder_len(ref_registry.get_config(arch),
                                 REF_SHAPES[shape])


@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_decode_inputs_equal_reference(arch, shape):
    rcfg, pcfg = ref_registry.get_config(arch), registry.get_config(arch)
    rp, rc, rt = ref_specs.decode_inputs(ref_zoo.build_model(rcfg), rcfg,
                                         REF_SHAPES[shape])
    pp, pc, ptok = SP.decode_inputs(zoo.build_model(pcfg), pcfg,
                                    SHAPES_BY_NAME[shape], device="cpu")
    assert _port_leaves(pp) == _ref_leaves(rp)
    assert _port_leaves(pc) == _ref_leaves(rc)
    assert _port_leaves({"t": ptok}) == _ref_leaves({"t": rt})
    assert all(isinstance(t, torch._subclasses.fake_tensor.FakeTensor)
               for t in flatten(pc).values())


def test_trace_memory_liveness():
    """Arguments, outputs and the peak of temporaries of a small chain:
    a = x * 2; b = a + 1; c = b.sum(): a and b live together once."""
    def f(x):
        a = x * 2
        b = a + 1
        return b.sum()
    mem = dryrun.trace_memory(trace_step(f, torch.ones(256, 256)))
    blk = 256 * 256 * 4
    assert mem["argument_size_in_bytes"] == blk
    assert mem["output_size_in_bytes"] == 4
    assert mem["temp_size_in_bytes"] == 2 * blk


def test_collective_time_follows_the_link_model():
    """A 'model' all-reduce of one rank: inside a node of 8 on a (1, 8)
    mesh it runs at NVLink's rate; on the 16 x 16 mesh its group spans
    two nodes and runs at the network's."""
    def f(x, mesh):
        return comm.all_reduce(x, "model", mesh)
    mode = abstract_mode()
    with mode:
        x = torch.empty(1 << 20)
    for shape, bw in (((1, 8), RL.NVLINK_BW), ((16, 16), RL.NIC_BW)):
        mesh = Mesh(shape, ("data", "model"))
        terms = RL.analyze_traced(trace_step(lambda t: f(t, mesh), x), mesh)
        n = shape[1]
        wire = 2.0 * 4 * (1 << 20) * (n - 1) / n
        assert terms["wire_bytes_per_device"] == wire
        assert terms["t_collective_s"] == wire / bw
        assert terms["collectives"] == {"all-reduce": wire}


def _cell(shape, strategy, mesh):
    return dryrun.run_cell("qwen3-1.7b", shape, False, strategy,
                           device="cpu", smoke=True, mesh=mesh)


def _rank_argument_bytes(shape, strategy, mesh):
    """A rank's argument bytes of a train or prefill cell from the specs
    alone: each whole leaf's bytes over the number of blocks its spec
    cuts it into, plus the rank's rows of the batch."""
    cfg = registry.get_config("qwen3-1.7b").smoke()
    model = zoo.build_model(cfg)
    mode = abstract_mode()
    if SHAPES_BY_NAME[shape].kind == "train":
        strat = make_strategy(strategy, mesh)
        tree, specs = ({**st._asdict(), "opt": st.opt._asdict()} for st in
                       (TS.abstract(model, device="cpu", mode=mode),
                        TS.state_specs(model, strat)))
    else:
        strat = make_strategy("dp_tp", mesh)
        tree = model.abstract_params(device="cpu", mode=mode,
                                     dtype=torch.bfloat16)
        specs = strat.param_specs(model)
    blocks = []
    map2(lambda t, s: blocks.append(
        t.numel() * t.element_size()
        // math.prod(mesh.shape[a] for a in spec_axes(s))), tree, specs)
    batch = dryrun._rows(SP.batch_specs(cfg, SHAPES_BY_NAME[shape],
                                        mode=mode, device="cpu"), strat)
    return sum(blocks) + sum(t.numel() * t.element_size()
                             for t in batch.values())


@pytest.mark.parametrize("shape,strategy", [
    ("train_4k", "dp_tp"), ("train_4k", "fsdp"), ("prefill_32k", "dp_tp"),
    ("decode_32k", "tp_serve")])
def test_run_cell_of_the_smoke_config_on_a_2x2_mesh(shape, strategy):
    one = _cell(shape, strategy, Mesh((1, 1), ("data", "model")))
    ranks = [_cell(shape, strategy, Mesh((2, 2), ("data", "model"), rank=r))
             for r in range(4)]
    for rec in [one] + ranks:
        assert rec["status"] == "ok", rec
        assert rec["kernel_nodes"]
        assert rec["memory"]["argument_size_in_bytes"] > 0
        assert rec["dominant"] in ("compute", "memory", "collective")
        assert 0 < rec["roofline_fraction"] <= 1
        json.dumps(rec)
    assert all(r["num_collectives"] > 0 for r in ranks)
    assert one["num_collectives"] == 0
    ratio = sum(r["dot_flops_per_device"] for r in ranks) \
        / one["dot_flops_per_device"]
    if strategy == "fsdp":
        assert ratio == 1.0
    else:
        assert 1.0 <= ratio <= 1.25, ratio
    # a rank holds its share: the sharded arguments are smaller
    assert ranks[0]["memory"]["argument_size_in_bytes"] < \
        one["memory"]["argument_size_in_bytes"]
    if strategy != "tp_serve":
        # and each rank's arguments are exactly its blocks: a block that
        # were a view of its whole leaf would count most of the leaf
        for r, rec in enumerate([one] + ranks):
            mesh = (Mesh((1, 1), ("data", "model")) if r == 0 else
                    Mesh((2, 2), ("data", "model"), rank=r - 1))
            assert rec["memory"]["argument_size_in_bytes"] == \
                _rank_argument_bytes(shape, strategy, mesh), (r, rec)


def test_main_records_ok_and_a11e_cells(tmp_path, monkeypatch):
    """``main`` writes one JSON record a cell, each "ok" on the production
    mesh's rank 0 at the smoke configs: qwen3's and granite's decode,
    train and prefill cells, granite's train and prefill (dp_tp) with the
    MoE layer's routing collectives among its nodes (the choices'
    all-gather over 'data', the aux's means all-reduced), and zamba2's
    decode cell (its train_4k traces one node per SSD chunk, ~100 s
    here)."""
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    kw = ["--mesh", "single", "--device", "cpu", "--smoke", "--tag", "t"]
    dryrun.main(["--arch", "qwen3-1.7b,granite-moe-3b-a800m", "--shape",
                 "decode_32k,train_4k,prefill_32k"] + kw)
    dryrun.main(["--arch", "zamba2-1.2b", "--shape", "decode_32k"] + kw)
    recs = {(r["arch"], r["shape"]): r for r in
            (json.loads(p.read_text()) for p in tmp_path.glob("*.json"))}
    assert len(recs) == 7
    for rec in recs.values():
        assert rec["status"] == "ok" and rec["mesh"] == "16x16", rec
        assert rec["chips"] == 256 and rec["trace_s"] >= 0
        assert rec["collectives"]
    for shape in ("train_4k", "prefill_32k"):
        moe, dense = (recs[(arch, shape)] for arch in
                      ("granite-moe-3b-a800m", "qwen3-1.7b"))
        assert moe["strategy"] == "dp_tp"
        # the routing's all-gather of the choices over 'data' and the
        # aux's all-reduce, a layer each, on top of a dense model's
        assert moe["num_collectives"] > dense["num_collectives"]
