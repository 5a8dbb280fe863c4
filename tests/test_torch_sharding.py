"""The port's sharding rules (sharding/rules.py, sharding/ctx.py), meshes
(launch/mesh.py) and collectives (sharding/comm.py) against the
reference.

Spec trees must equal the reference's exactly, leaf for leaf, for every
config of the registry under dp_tp, fsdp, tp_serve and weight-gathered
tp_serve on six meshes (the reference's strategies only read
``mesh.shape``, so a FakeMesh stands in for it, as in
tests/test_sharding.py). ``local_slice`` must cut the same blocks that
a NamedSharding places on each device of an Auto-axes mesh of host
devices (a subprocess with 8 of them), and the collectives must give
every gloo rank the same result.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec
from _hypo import given, settings, st

import _torch_ranks as R
from repro.configs import registry as ref_registry
from repro.models.zoo import build_model as ref_build
from repro.serve import flash_decode as ref_fd
from repro.sharding import rules as ref_rules
from repro.sharding.ctx import Sharder as RefSharder
from repro_torch.checkpoint.checkpointer import flatten
from repro_torch.configs import registry
from repro_torch.launch import mesh as M
from repro_torch.models.zoo import build_model
from repro_torch.serve import flash_decode as FD
from repro_torch.sharding import rules
from repro_torch.sharding.ctx import Sharder

TESTS = pathlib.Path(__file__).resolve().parent
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((1, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((1, 4), ("data", "model")), ((2, 4), ("data", "model"))]
STRATEGIES = [("dp_tp", {}), ("fsdp", {}), ("tp_serve", {}),
              ("tp_serve", {"weight_gathered": True})]


class FakeMesh:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))


def _ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {jax.tree_util.keystr(k): v for k, v in flat}


def _port_leaves(tree):
    return flatten(tree, is_leaf=lambda x: isinstance(x, rules.PS))


def _same_specs(got, want):
    got, want = _port_leaves(got), _ref_leaves(want)
    assert sorted(got) == sorted(want)
    for key, spec in want.items():
        assert isinstance(got[key], rules.PS), key
        assert got[key] == spec, (key, got[key], spec)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_and_opt_specs_match_reference(arch):
    ref_model = ref_build(ref_registry.get_config(arch))
    model = build_model(registry.get_config(arch))
    for shape, axes in MESHES:
        for name, kw in STRATEGIES:
            ref = ref_rules.make_strategy(name, FakeMesh(shape, axes), **kw)
            port = rules.make_strategy(name, M.Mesh(shape, axes), **kw)
            _same_specs(port.param_specs(model), ref.param_specs(ref_model))
            _same_specs(port.opt_specs(model), ref.opt_specs(ref_model))
            assert port.batch_axes == ref.batch_axes
            assert port.act_specs() == ref.act_specs()


def _abstract_caches(batch, seq, pages):
    sds = jax.ShapeDtypeStruct
    dense = {"main": {"b0_dense": {
        "k": sds((4, batch, seq, 8, 128), np.float32),
        "v": sds((4, batch, seq, 8, 128), np.float32),
        "idx": sds((4, batch), np.int32)}},
        "flat": sds((batch, seq, 8, 128), np.float32)}
    paged = {"main": {"b0_dense": {
        "k": sds((4, pages, 16, 8, 128), np.float32),
        "v": sds((4, pages, 16, 8, 128), np.float32),
        "pt": sds((4, batch, 11), np.int32),
        "idx": sds((4, batch), np.int32)}}}
    return dense, paged


@pytest.mark.parametrize("shape,axes", MESHES)
def test_cache_specs_and_plans_match_reference(shape, axes):
    ref_mesh, mesh = FakeMesh(shape, axes), M.Mesh(shape, axes)
    ref = ref_rules.TpServe(ref_mesh)
    port = rules.TpServe(mesh)
    for batch in (1, 3, 8, 32):
        for seq in (256, 1024, 1536, 4096, 500_000):
            dense, _ = _abstract_caches(batch, seq, 8)
            _same_specs(port.cache_specs(dense, batch),
                        ref.cache_specs(dense, batch))
            assert FD.decode_shard_plan(Sharder(mesh, {}), batch, seq) == \
                ref_fd.decode_shard_plan(RefSharder(ref_mesh, {}), batch,
                                         seq), (batch, seq)
        for pages in (8, 63, 64, 88, 96, 512):
            _, paged = _abstract_caches(batch, 1024, pages)
            _same_specs(port.paged_cache_specs(paged, batch),
                        ref.paged_cache_specs(paged, batch))
            for ps in (16, 32):
                assert FD.paged_shard_plan(Sharder(mesh, {}), batch, pages,
                                           ps) == ref_fd.paged_shard_plan(
                    RefSharder(ref_mesh, {}), batch, pages, ps)
    assert FD.paged_shard_plan(None, 8, 64, 16) is None
    assert FD.decode_shard_plan(None, 8, 1024) is None


@pytest.mark.parametrize("shape,axes", MESHES)
def test_sharder_spec_for_keeps_the_divisibility_rule(shape, axes):
    """``Sharder.spec_for`` applies a kind's spec exactly where the
    reference's ``constrain`` would (divisible, not undersized), and
    ``shard`` changes no value."""
    ref_mesh, mesh = FakeMesh(shape, axes), M.Mesh(shape, axes)
    port = rules.TpServe(mesh).sharder()
    ref = RefSharder(ref_mesh, ref_rules.TpServe(ref_mesh).act_specs())
    for kind, spec in ref.act_specs.items():
        for shp in [(8, 16, 2048), (3, 16, 2048), (32, 1, 6144),
                    (8, 40, 4, 96), (16, 4, 16), (16,)]:
            want = (None if len(spec) > len(shp)
                    or not ref._divisible(shp, spec) else spec)
            assert port.spec_for(shp, kind) == want, (kind, shp)
    x = object()
    assert port.constrain(x, "btd") is x
    assert port.spec_for((8, 8), "unknown") is None


@given(st.lists(st.integers(1, 4096), min_size=1, max_size=4),
       st.sampled_from(["ffn", "embed", "vocab", "experts", None]))
@settings(max_examples=120, deadline=None)
def test_leaf_specs_never_pad(shape, ax):
    """Every sharded dim divides by its mesh axes (no implicit padding)."""
    mesh = M.Mesh((16, 16), ("data", "model"))
    axes = tuple([ax] + [None] * (len(shape) - 1))
    for fn in (rules.leaf_spec_tp, rules.leaf_spec_fsdp):
        spec = fn(axes, tuple(shape), mesh)
        for dim, names in zip(shape, tuple(spec)):
            if names is not None:
                assert dim % mesh.axis_size(names) == 0


_LAYOUT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as PS
from repro.launch.mesh import make_elastic_mesh
out = {"elastic": {n: list(make_elastic_mesh(n).devices.shape)
                   for n in range(1, 9)}, "layouts": []}
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
pos = {d.id: [int(i) for i in np.argwhere(mesh.devices == d)[0]]
       for d in mesh.devices.flat}
for spec in ([], ["model", None], [None, ["data", "model"]],
             [["data", "model"], None], ["data", "model"], [None, "data"],
             [None, ["model", "data"]]):
    ps = PS(*[tuple(e) if isinstance(e, list) else e for e in spec])
    x = jax.device_put(np.arange(64.0).reshape(8, 8), NamedSharding(mesh, ps))
    for sh in x.addressable_shards:
        out["layouts"].append([spec, pos[sh.device.id],
                               [[s.start or 0, s.stop or 8]
                                for s in sh.index]])
print("LAYOUT" + json.dumps(out))
"""


def test_mesh_builders_and_local_slice_match_reference():
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _LAYOUT], env=env,
                         capture_output=True, text=True, timeout=300)
    line = [s for s in res.stdout.splitlines() if s.startswith("LAYOUT")]
    assert line, res.stderr[-3000:]
    got = json.loads(line[0][len("LAYOUT"):])
    for n, shape in got["elastic"].items():
        assert list(M.elastic_shape(int(n))) == shape
        assert tuple(M.make_elastic_mesh(int(n)).shape.values()) == \
            tuple(shape)
    assert M.make_production_mesh().shape == {"data": 16, "model": 16}
    assert M.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    assert M.make_host_mesh().shape == {"data": 1, "model": 1}
    x = np.arange(64.0).reshape(8, 8)
    assert len(got["layouts"]) == 7 * 8
    for spec, (d, m), index in got["layouts"]:
        ps = rules.PS(*[tuple(e) if isinstance(e, list) else e
                        for e in spec])
        mesh = M.Mesh((2, 4), ("data", "model"), rank=d * 4 + m)
        want = x[tuple(slice(a, b) for a, b in index)]
        np.testing.assert_array_equal(rules.local_slice(x, ps, mesh), want)


def test_mesh_coordinates_and_peers():
    mesh = M.Mesh((2, 3, 4), ("pod", "data", "model"), rank=17)
    assert mesh.coords == {"pod": 1, "data": 1, "model": 1}
    assert mesh.index(("data", "model")) == 5
    assert mesh.index("model") == 1 and mesh.axis_size(("pod", "data")) == 6
    assert mesh.peers("model") == (16, 17, 18, 19)
    assert mesh.peers(("pod", "data")) == (1, 5, 9, 13, 17, 21)
    with pytest.raises(ValueError):
        mesh.group(("model", "data"))             # out of mesh order
    with pytest.raises(RuntimeError):
        mesh.group("model")                       # abstract: no groups
    assert M.make_host_mesh().group("model") is None


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_on_gloo_ranks(n, tmp_path):
    got = M.launch(R.comm_rank, (1, n), init_dir=str(tmp_path))
    xs = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
          for r in range(n)]
    for r, out in enumerate(got):
        np.testing.assert_array_equal(out["sum"], sum(xs))
        np.testing.assert_array_equal(out["isum"], sum(xs).astype(np.int32))
        np.testing.assert_array_equal(out["max"], -xs[0])
        np.testing.assert_array_equal(out["gather"], np.concatenate(xs, 1))
        np.testing.assert_array_equal(out["bcast"], xs[1])
        np.testing.assert_array_equal(
            out["gather_bf16"], np.concatenate([g["bf16"] for g in got]))
        assert out["calls"] == 6
