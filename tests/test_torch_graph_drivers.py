"""Tier 2 in the port's drivers, against the reference's: ``launch.serve
--profile`` merges the waste analysis of the traced decode tick (the
token loop's decode step for the other families), ``launch.train
--waste-report`` prints the traced train step's ``summary()`` and merges
its profile; and outside a trace the kernel entry points run exactly the
operations they ran before tracing existed.

Where the kinds differ, the reference's finding is a shapes-only
collision: XLA's CPU fusions carry no ``op_name``, so two layers'
same-shaped projections fingerprint alike ("[fusion;fusion]") and count
as recompute. The port compares operand values (value numbers), which
tells the layers apart and still flags remat's recompute (ROADMAP § C).
"""
import contextlib
import io

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.launch import serve as ref_serve
from repro.launch import train as ref_train
from repro_torch.kernels import ops
from repro_torch.launch import serve as pt_serve
from repro_torch.launch import train as pt_train

from _torch_parity import smoke_configs


def _tier2(merged):
    return [f for f in merged.findings if f.tier == 2]


def _quiet(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*args, **kw)
    return res, buf.getvalue()


def test_serve_profile_merges_tier2_of_the_tick():
    (out, merged, stats), text = _quiet(
        pt_serve.run, "qwen3-1.7b", smoke=True, batch=2, prompt_len=8,
        gen=4, kv="paged", profile=True, device="cpu")
    (_, ref_merged), _ = _quiet(
        ref_serve.run, "qwen3-1.7b", smoke=True, batch=2, prompt_len=8,
        gen=4, kv="paged", profile=True)
    assert "NOT_PORTED" not in text and "not ported" not in text
    assert "[serve] tier 2 (decode tick)" in text
    assert "== JXPerf-JAX Tier-2 (traced step waste) ==" in text
    assert 2 in merged.tiers and merged.checked["recompute"] > 0
    # the tick's kernel nodes are the launches of one tick: B1 a layer,
    # B5 four a layer and the final norm
    layers = smoke_configs()[1].num_layers
    assert stats["tier2_kernel_nodes"] == {
        "ops.paged_decode": layers, "ops.rmsnorm": 4 * layers + 1}
    # the reference flags same-shaped products of different layers
    assert {f.kind for f in _tier2(ref_merged)} == {"recompute"}
    assert all(f.c1[0].endswith("[fusion;fusion]")
               for f in _tier2(ref_merged))
    assert _tier2(merged) == []


def test_token_loop_profile_merges_tier2_of_the_decode_step():
    kw = dict(smoke=True, batch=2, prompt_len=16, gen=2, profile=True)
    (_, merged, stats), text = _quiet(pt_serve.run, "whisper-large-v3",
                                      device="cpu", **kw)
    (_, ref_merged), _ = _quiet(ref_serve.run, "whisper-large-v3", **kw)
    assert "[serve] tier 2 (decode step)" in text
    assert stats["tier2_nodes"] > 0
    # the encoder-frame padding is tier 2 in both
    assert "prefill_padding" in {f.kind for f in _tier2(merged)}
    assert "prefill_padding" in {f.kind for f in _tier2(ref_merged)}
    assert ({f.kind for f in _tier2(merged)} - {"prefill_padding"}) <= \
        {f.kind for f in _tier2(ref_merged)}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_waste_report_against_reference(remat, tmp_path):
    kw = dict(smoke=True, steps=1, batch=2, seq=32, waste_report=True,
              remat=remat)
    out_json = str(tmp_path / "p.json")
    (_, merged), text = _quiet(pt_train.run, "qwen3-1.7b", device="cpu",
                               profile_out=out_json, **kw)
    (_, ref_merged), _ = _quiet(ref_train.run, "qwen3-1.7b", **kw)
    assert "== JXPerf-JAX Tier-2 (traced step waste) ==" in text
    assert "[train] tier 2 (train step)" in text
    assert merged.tiers == [2]
    with open(out_json) as fh:
        assert '"tiers": [\n    2\n  ]' in fh.read()
    port = {f.kind for f in _tier2(merged)}
    ref = {f.kind for f in _tier2(ref_merged)}
    assert port <= ref == {"recompute"}
    layers = smoke_configs()[1].num_layers
    if remat == "full":
        # every projection but the last of each layer computed twice:
        # the recompute stops once the backward's saved tensors are back,
        # and the down projection's output is not one of them
        rec = [f for f in _tier2(merged) if f.kind == "recompute"]
        assert sum(f.count for f in rec) == 2 * 6 * layers
        assert merged.totals["recompute_flops"] > 0
    else:
        assert port == set()
        assert all(f.c1[0].endswith("[fusion;fusion]")
                   for f in _tier2(ref_merged))


class _Log(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _entry_calls():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    B, S, Hq, Hkv, D, P, ps, M = 2, 3, 4, 2, 8, 6, 4, 2
    pt = torch.arange(B * M, dtype=torch.int32).reshape(B, M)
    idx = torch.tensor([1, 2], dtype=torch.int32)
    pool = (r(P, ps, Hkv, D), r(P, ps, Hkv, D))
    q, k, v = r(B, S, Hq, D), r(B, S, Hkv, D), r(B, S, Hkv, D)
    return {
        "attention": (ops.attention, (q, k, v), {}),
        "attention_masked": (ops.attention, (q, k, v),
                             {"kv_len": torch.tensor([2, 3])}),
        "rmsnorm": (ops.rmsnorm, (r(B, S, D), r(D)), {}),
        "paged_decode": (ops.paged_decode,
                         (r(B, 1, Hq, D), r(B, 1, Hkv, D), r(B, 1, Hkv, D),
                          pool[0].clone(), pool[1].clone(), pt, idx),
                         {"counters": True}),
        "paged_window": (ops.paged_window,
                         (q, k, v, pool[0].clone(), pool[1].clone(), pt,
                          idx), {"counters": True}),
        "paged_window_defer": (ops.paged_window,
                               (q, k, v, pool[0].clone(), pool[1].clone(),
                                pt, idx), {"store": False}),
        "silent_count": (ops.silent_count, (r(64), r(64)), {}),
    }


@pytest.mark.parametrize("name", sorted(_entry_calls()))
def test_eager_entry_points_dispatch_no_added_op(name):
    """An eager call of each entry point dispatches exactly the
    operations of its undecorated body (the tracing hook adds none), and
    returns the same values."""
    fn, args, kwargs = _entry_calls()[name]

    def clone(a):
        return a.clone() if torch.is_tensor(a) else a
    logs, outs = [], []
    for call in (fn, fn.__wrapped__):
        a = [clone(x) for x in args]
        with _Log() as log:
            outs.append(call(*a, **kwargs))
        logs.append(log.ops)
    assert logs[0] == logs[1] and logs[0]
    assert not any("repro_torch" in op for op in logs[0])
    flat = [torch.utils._pytree.tree_leaves(o) for o in outs]
    for x, y in zip(*flat):
        if torch.is_tensor(x):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
