"""Checkpointing, elastic restore and the fault monitor of the port
(checkpoint/, runtime/fault.py, the training driver's --ckpt-dir and
--resume) against the reference.

The reference's own tests of these modules (tests/test_substrate.py) are
mirrored on torch tensors. A checkpoint written by either package must
restore in the other with every leaf equal; ``resume_elastic`` onto two
gloo ranks must give each rank the block that the reference's elastic
restore places on the same device of its mesh (a subprocess with host
devices); the training driver's resume must give the losses of a
straight run bit for bit, and from a reference checkpoint the
reference's losses within the bf16 train parity tolerance (1e-4).
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.configs import registry as ref_registry
from repro.launch.train import run as ref_train
from repro.models.zoo import build_model as ref_build
from repro.train import state as ref_state
from repro_torch.checkpoint.checkpointer import Checkpointer, flatten
from repro_torch.configs import registry
from repro_torch.launch import train as pt_train
from repro_torch.launch.mesh import launch
from repro_torch.models.zoo import build_model
from repro_torch.runtime.fault import FleetMonitor
from repro_torch.train import state as TS

TESTS = pathlib.Path(__file__).resolve().parent
ARCH = "qwen3-1.7b"


# ----------------------------------------------------------------------
# The reference's checkpoint and fault tests, on the port
# ----------------------------------------------------------------------
def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "n": {"b": torch.ones(5, dtype=torch.int32)},
            "s": torch.tensor(7.0),
            "h": torch.arange(6.0).to(torch.bfloat16)}


def test_checkpoint_roundtrip_and_gc(tmp_path):
    tree = _tree()
    ck = Checkpointer(tmp_path, keep=2)
    for s in (10, 20, 30):
        ck.save(s, tree)
    assert ck.all_steps() == [20, 30]          # keep=2 gc'd step 10
    out = ck.restore(tree)
    for key, want in flatten(tree).items():
        got = flatten(out)[key]
        assert got.dtype == want.dtype and torch.equal(got, want), key
    index = json.loads((tmp_path / "step_00000030" / "index.json")
                       .read_text())
    assert index["leaves"]["['h']"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_00000030" /
                   index["leaves"]["['h']"]["file"]).dtype == np.float32


def test_checkpoint_atomicity(tmp_path):
    """A stale .tmp dir from a crashed writer is never listed/restored."""
    ck = Checkpointer(tmp_path)
    ck.save(5, {"x": torch.ones(3)})
    (tmp_path / "step_00000009.tmp").mkdir()
    assert ck.latest_step() == 5


def test_checkpoint_async_snapshots_before_returning(tmp_path):
    ck = Checkpointer(tmp_path)
    x = torch.ones((256, 256))
    ck.save_async(1, {"x": x})
    x.add_(1.0)                        # the train step writes in place
    ck.wait()
    assert ck.latest_step() == 1
    assert torch.equal(ck.restore({"x": x})["x"], torch.ones((256, 256)))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"x": torch.ones((4,))})
    with pytest.raises(ValueError):
        ck.restore({"x": torch.empty(5)})
    with pytest.raises(KeyError):
        ck.restore({"y": torch.empty(4)})


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_fault_monitor_dead_host_elastic_restart():
    clk = FakeClock()
    mon = FleetMonitor([0, 1, 2, 3], dead_after=10.0, clock=clk)
    clk.t = 5.0
    for h in (0, 1, 2, 3):
        mon.heartbeat(h, 1.0)
    assert mon.plan()["action"] == "continue"
    clk.t = 20.0
    for h in (0, 1, 2):
        mon.heartbeat(h, 1.0)                 # host 3 silent
    plan = mon.plan()
    assert plan["action"] == "elastic_restart"
    assert plan["dead"] == [3]
    assert plan["survivors"] == [0, 1, 2]
    mon.remove_hosts([3])
    assert mon.plan()["action"] == "continue"


def test_fault_monitor_straggler_detection():
    clk = FakeClock()
    mon = FleetMonitor([0, 1, 2, 3], dead_after=1e9, straggler_factor=2.0,
                       straggler_patience=2, clock=clk)
    for tick in range(3):
        for h in (0, 1, 2):
            mon.heartbeat(h, 1.0)
        mon.heartbeat(3, 5.0)                 # consistently 5x median
        plan = mon.plan()
    assert plan["action"] == "mitigate_stragglers"
    assert plan["hosts"] == [3]


def test_fault_monitor_restart_budget():
    clk = FakeClock()
    mon = FleetMonitor([0, 1], dead_after=1.0, max_restarts=1, clock=clk)
    clk.t = 5.0
    mon.heartbeat(0)
    assert mon.plan()["action"] == "elastic_restart"
    clk.t = 10.0
    mon.heartbeat(0)
    assert mon.plan()["action"] == "abort"


# ----------------------------------------------------------------------
# Across the packages
# ----------------------------------------------------------------------
def _models():
    cfg = ref_registry.get_config(ARCH).smoke()
    return ref_build(cfg), build_model(registry.get_config(ARCH).smoke())


def _same_state(port_state, ref_state_host):
    ref = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
           jax.tree_util.tree_flatten_with_path(ref_state_host)[0]}
    got = flatten(port_state)
    assert sorted(got) == sorted(ref)
    for key, want in ref.items():
        g = got[key]
        assert str(g.dtype).replace("torch.", "") == str(want.dtype), key
        np.testing.assert_array_equal(g.float().numpy(),
                                      want.astype(np.float32), err_msg=key)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref_model, pt_model = _models()
    rs = ref_state.create(ref_model, jax.random.PRNGKey(3))
    RefCheckpointer(tmp_path).save(6, rs)
    template = TS.create(pt_model, 0, device="cpu")
    got = Checkpointer(tmp_path).restore(template)
    _same_state(got, jax.device_get(rs))
    assert int(got.step) == 0 and got.params["embed"].dtype == torch.bfloat16


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref_model, pt_model = _models()
    ps = TS.create(pt_model, 5, device="cpu")
    Checkpointer(tmp_path).save(3, ps)
    got = RefCheckpointer(tmp_path).restore(ref_state.abstract(ref_model))
    _same_state(ps, jax.device_get(got))


_ELASTIC = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.checkpoint.elastic import resume_elastic
from repro.configs import registry
from repro.models.zoo import build_model
model = build_model(registry.get_config("qwen3-1.7b").smoke())
mesh, strat, state = resume_elastic(sys.argv[1], model, "dp_tp",
                                    num_devices=2)
pos = {d.id: int(np.argwhere(mesh.devices == d)[0][1])
       for d in mesh.devices.flat}
out = {}
for kp, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
    for sh in leaf.addressable_shards:
        out.setdefault(jax.tree_util.keystr(kp), {})[pos[sh.device.id]] = [
            [s.start or 0, s.stop if s.stop is not None else n]
            for s, n in zip(sh.index, leaf.shape)]
print("SHARDS" + json.dumps({"mesh": list(mesh.devices.shape),
                             "shards": out}))
"""


def test_elastic_restore_onto_two_ranks_matches_reference(tmp_path):
    """A port checkpoint restored onto a (1, 2) mesh: each gloo rank's
    leaves are the block the reference's resume_elastic places on the
    device at the same mesh position."""
    _, pt_model = _models()
    state = TS.create(pt_model, 2, device="cpu")
    ckdir = tmp_path / "ck"
    Checkpointer(ckdir).save(4, state)
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"),
               JAX_PLATFORMS="cpu")
    sub = subprocess.Popen([sys.executable, "-c", _ELASTIC, str(ckdir)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    ranks = launch(R.elastic_rank, (1, 2), args=(str(ckdir),),
                   init_dir=str(tmp_path))
    out, err = sub.communicate(timeout=300)
    line = [s for s in out.splitlines() if s.startswith("SHARDS")]
    assert line, err[-3000:]
    ref = json.loads(line[0][len("SHARDS"):])
    whole = {k: v.float().numpy() for k, v in flatten(state).items()}
    sharded = 0
    for r, got in enumerate(ranks):
        assert got["shape"] == {"data": 1, "model": 2} and \
            ref["mesh"] == [1, 2]
        assert got["coords"] == {"data": 0, "model": r}
        assert sorted(got["leaves"]) == sorted(ref["shards"])
        for key, blocks in ref["shards"].items():
            want = whole[key][tuple(slice(a, b) for a, b in blocks[str(r)])]
            np.testing.assert_array_equal(got["leaves"][key], want,
                                          err_msg=key)
            sharded += want.shape != whole[key].shape
    assert sharded > 0


# ----------------------------------------------------------------------
# The training driver
# ----------------------------------------------------------------------
def test_train_driver_resume_is_bit_exact(tmp_path):
    """4 straight steps == 2 steps, a save and a resume of 2 more."""
    kw = dict(smoke=True, batch=2, seq=32, seed=7, device="cpu")
    straight, _ = pt_train.run(ARCH, steps=4, **kw)
    first, _ = pt_train.run(ARCH, steps=2, total_steps=4,
                            ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    resumed, _ = pt_train.run(ARCH, steps=4, ckpt_dir=str(tmp_path),
                              resume=True, **kw)
    assert first + resumed == straight
    assert Checkpointer(tmp_path).all_steps() == [2, 4]


def test_train_driver_resumes_a_reference_checkpoint(tmp_path):
    """The reference trains 2 of 4 steps and checkpoints; the port
    resumes it: its steps 3 and 4 give the reference's straight run's
    losses within the bf16 train parity tolerance."""
    kw = dict(smoke=True, batch=2, seq=32, seed=7)
    straight, _ = ref_train(ARCH, steps=4, log_every=100, **kw)
    ref_train(ARCH, steps=2, total_steps=4, ckpt_dir=str(tmp_path),
              ckpt_every=2, log_every=100, **kw)
    resumed, _ = pt_train.run(ARCH, steps=4, ckpt_dir=str(tmp_path),
                              resume=True, device="cpu", **kw)
    assert len(resumed) == 2
    np.testing.assert_allclose(resumed, straight[2:], rtol=1e-4)
