"""The port's vocab-parallel loss (``train/fused_xent.py``) and the
differentiable collectives of ``sharding/comm.py`` on 2 and 4 gloo CPU
ranks ((1, 2) and (2, 2) meshes of (data, model)).

The loss: for a vocabulary that divides 'model' (64) and one that does
not (63, where ``lm_loss`` falls back to the plain loss averaged over
the batch axes, the reference's rule), with and without ``z_loss``:
each rank's loss, dx (its rows) and dw (its vocab block) equal the
reference's ``make_fused_xent`` under ``shard_map`` on an Auto-axes mesh
of the same shape (a subprocess of host devices; the known-red
``test_sharding.py::test_distributed_pieces_subprocess`` runs it on
Explicit axes) and the port's plain loss on the whole batch. The port's
dw is each rank's rows' part (the train step sums every gradient over
the batch axes once): summed over 'data' it is the reference's, which
sums it inside the loss. The fused forward never makes a (B, S, V) tensor: the
largest tensor any of its operations returns is asserted. Tolerance:
1e-6 relative on the loss, 1e-5 of the largest magnitude on dx and dw
(float32 sums in another order).

The collectives: the gradients of small products through each of them
(a column-parallel then row-parallel pair, a gathered output, a block of
a replicated input, a fsdp-gathered weight under a loss averaged over
the ranks) equal the unsharded product's gradients' blocks, within 1e-5
of the largest magnitude.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro_torch.launch.mesh import launch
from repro_torch.train.fused_xent import _plain

TESTS = pathlib.Path(__file__).resolve().parent
MESHES = ((1, 2), (2, 2))

_REF_FUSED = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
import _torch_ranks as R
from repro.train.fused_xent import make_fused_xent
a = R.xent_inputs(R.XENT_VOCABS[0])
out = {}
for shape in ((1, 2), (2, 2)):
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    for z in R.Z_LOSSES:
        fn = make_fused_xent(mesh, ("data",), z)
        with mesh:
            loss, (dx, dw) = jax.value_and_grad(
                lambda x, w: fn(x, w, jnp.asarray(a["labels"])),
                argnums=(0, 1))(jnp.asarray(a["x"]), jnp.asarray(a["w"]))
        out[f"{shape}-{z}"] = [float(loss), np.asarray(dx).tolist(),
                               np.asarray(dw).tolist()]
print("FUSED" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's fused loss by mesh and z_loss, {mesh: per-rank
    results})."""
    tmp = tmp_path_factory.mktemp("fused_xent")
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"),
               JAX_PLATFORMS="cpu")
    sub = subprocess.Popen([sys.executable, "-c", _REF_FUSED, str(TESTS)],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    port = {shape: launch(R.xent_rank, shape, init_dir=str(tmp))
            for shape in MESHES}
    out, err = sub.communicate(timeout=600)
    line = [s for s in out.splitlines() if s.startswith("FUSED")]
    assert line, err[-3000:]
    return json.loads(line[0][5:]), port


def _plain_grads(V, z):
    """The port's plain loss on the whole batch: (loss, dx, dw)."""
    a = R.xent_inputs(V)
    x = torch.from_numpy(a["x"]).requires_grad_(True)
    w = torch.from_numpy(a["w"]).requires_grad_(True)
    loss = _plain(x, w, torch.from_numpy(a["labels"]), z)
    loss.backward()
    return float(loss.detach()), x.grad.numpy(), w.grad.numpy()


def _near(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _blocks(rank, shape, dx, dw, fused):
    """The rank's rows of dx (over data) and vocab rows of dw (over model
    where fused)."""
    dp, tp = shape
    b = dx.shape[0] // dp
    r = rank["coords"]["data"]
    rows = dx[r * b:(r + 1) * b]
    if not fused:
        return rows, dw
    v = dw.shape[0] // tp
    m = rank["coords"]["model"]
    return rows, dw[m * v:(m + 1) * v]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("z", R.Z_LOSSES)
def test_fused_xent_matches_reference_and_plain(runs, z, shape):
    ref, port = runs
    V = R.XENT_VOCABS[0]
    rloss, rdx, rdw = ref[f"{shape}-{z}"]
    ploss, pdx, pdw = _plain_grads(V, z)
    np.testing.assert_allclose(rloss, ploss, rtol=1e-6)
    B, S, _ = R.XENT_SHAPE
    ranks = port[shape]
    for rank in ranks:
        loss, dx, _, most = rank["xent"][(V, z)]["fused"]
        np.testing.assert_allclose(loss, rloss, rtol=1e-6)
        # dw: this rank's rows' part, summed over 'data' the reference's
        dw = np.sum([r["xent"][(V, z)]["fused"][2] for r in ranks
                     if r["coords"]["model"] == rank["coords"]["model"]],
                    axis=0)
        for want in ((np.asarray(rdx), np.asarray(rdw)), (pdx, pdw)):
            wx, ww = _blocks(rank, shape, *want, fused=True)
            _near(dx, wx)
            _near(dw, ww)
        # the largest tensor of the forward: a rank's logits block at most
        assert most <= (B // shape[0]) * S * (V // shape[1]) < B * S * V


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("V", R.XENT_VOCABS)
@pytest.mark.parametrize("z", R.Z_LOSSES)
def test_lm_loss_dispatch_and_rank_partial_dw(runs, z, V, shape):
    """lm_loss under a dp_tp sharder: fused where V divides 'model', else
    the plain loss averaged over 'data'; each rank's dw is its rows'
    part, summed over 'data' the whole batch's."""
    _, port = runs
    ploss, pdx, pdw = _plain_grads(V, z)
    fused = V % shape[1] == 0
    ranks = port[shape]
    for rank in ranks:
        loss, dx, _, _ = rank["xent"][(V, z)]["lm_loss"]
        np.testing.assert_allclose(loss, ploss, rtol=1e-6)
        _near(dx, _blocks(rank, shape, pdx, pdw, fused)[0])
    for m in range(shape[1]):
        parts = [r["xent"][(V, z)]["lm_loss"][2] for r in ranks
                 if r["coords"]["model"] == m]
        want = _blocks({"coords": {"data": 0, "model": m}}, shape, pdx,
                       pdw, fused)[1]
        _near(np.sum(parts, axis=0), want)


def _unsharded_grads():
    """The products of ``_torch_ranks.grad_rank`` on whole tensors."""
    a = {k: torch.from_numpy(v) for k, v in R.grad_inputs().items()}
    out = {}
    x, w1, w2 = (a[k].clone().requires_grad_(True) for k in ("x", "w1",
                                                             "w2"))
    (((torch.relu(x @ w1) @ w2) * a["c"]).sum()).backward()
    out["mlp"] = [x.grad, w1.grad, w2.grad]
    x, w1 = (a[k].clone().requires_grad_(True) for k in ("x", "w1"))
    ((x @ w1) * (a["c"] @ a["w1"])).sum().backward()
    out["gather"] = [x.grad, w1.grad]
    out["block"] = [x.grad, w1.grad]
    x, w1 = (a[k].clone().requires_grad_(True) for k in ("x", "w1"))
    loss = torch.mean((x @ w1) * (a["c"] @ a["w1"]))
    loss.backward()
    out["fsdp"] = [x.grad, w1.grad, float(loss.detach())]
    return {k: [t.numpy() if torch.is_tensor(t) else t for t in v]
            for k, v in out.items()}


# (name, per gradient: the dims cut over (data, model) of the whole one;
# a gradient without a 'data' dim (a weight's under dp) is each data
# rank's rows' part: summed over 'data' it is the whole batch's)
_LAYOUTS = {
    "mlp": [("data", None), (None, "model"), ("model", None)],
    "gather": [("data", None), (None, "model")],
    "block": [("data", None), ("model", None)],
    "fsdp": [("every", None), ("every", None)],
}


def _cut(w, layout, coords, shape):
    for dim, ax in enumerate(layout):
        if ax is None:
            continue
        n = shape[0] * shape[1] if ax == "every" else \
            shape[0 if ax == "data" else 1]
        i = (coords["data"] * shape[1] + coords["model"] if ax == "every"
             else coords[ax])
        blk = w.shape[dim] // n
        w = np.take(w, range(i * blk, (i + 1) * blk), axis=dim)
    return w


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", list(_LAYOUTS))
def test_differentiable_collectives_give_unsharded_gradients(runs, name,
                                                             shape):
    ranks = runs[1][shape]
    want = _unsharded_grads()[name]
    for rank in ranks:
        got = rank["grads"][name]
        c = rank["coords"]
        for k, (w, layout) in enumerate(zip(want, _LAYOUTS[name])):
            if "data" in layout or "every" in layout:
                g = got[k]
            else:
                g = np.sum([r["grads"][name][k] for r in ranks
                            if r["coords"]["model"] == c["model"]], axis=0)
            _near(g, _cut(w, layout, c, shape))
        if name == "fsdp":
            np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
