"""Sharded training of the MoE, hybrid and ssm families in the port
(``make_train_step(strategy=)``): granite-moe-3b-a800m under dp_tp
(experts over 'model') and fsdp (the MoE layer routes a rank's rows as
the whole batch's), zamba2-1.2b and xlstm-1.3b under dp_tp (the
recurrent blocks on leaves gathered whole), on gloo CPU ranks, against
the port's unsharded step.

Every case is a smoke config in float32 from the port's seed-0 state
(``_torch_ranks.family_run``), 2 steps of the stream's 4 x 32 batches,
each rank on its rows: granite under dp_tp (with either dispatch path:
the masked scatter and the one-hot einsums; and under remat "dots") and
fsdp, zamba2 under dp_tp
at 14 layers (two superblocks and a Mamba2 tail of 2, so the tail's
layout runs; the smoke config's 12 have none) and xlstm under dp_tp on a
(1, 2) mesh, and granite under dp_tp on a (2, 2) mesh (routed over
'data', the experts over 'model'). The smoke leaves that shard under
dp_tp: granite's expert leaves (4 x 64 x 64, 16 Ki elements: two
experts a rank), zamba2's Mamba2 ``in_proj`` and ``out_proj``, xlstm's
mLSTM ``up_proj`` and ``down_proj``, and the embedding and head; so each
branch runs sharded with its backward collectives. Under fsdp the
128-token group spans both ranks.

Tolerances, against the unsharded step:
- loss, nll, ``moe_aux`` and grad norm within 1e-5 relative (the aux is
  a mean of the ranks' means, the sums split over the ranks);
- the first batch's gradient of the first MoE layer's router, after the
  step's sum over the batch axes, on every rank within 1e-5 of its
  largest (the check that the kept gates enter the rank's experts
  through ``comm.copy_to``);
- the master within 1e-5 of each leaf's largest magnitude. A leaf the
  model initializes to zeros (Mamba2's ``conv_b``, ``A_log``,
  ``dt_bias``; xLSTM's input and output gate biases) holds only Adam's
  steps, each element's about lr whatever its gradient's size, so an
  element with a small gradient carries the sharded sums' rounding (5e-6
  of the leaf's largest gradient under dp_tp) at full size: such a leaf
  is held within 1e-4 of its largest (zamba2's dp_tp ``conv_b`` measured
  5.6e-5);
- granite's kept and dropped expert choices of the two steps, summed
  over the ranks of the batch axes (each 'model' rank under dp_tp routes
  its data rank's rows), equal exactly.
The last granite dp_tp step on (1, 2) is traced on fake tensors first:
its collective nodes by kind equal the collectives the step ran
(``comm.STATS``), its forward kernel nodes its kernel calls. The global
routing (``models/moe.py:_route_rows``) is held to the reference's
``_route`` on one batch cut into 2 and 4 rank blocks, at token counts
below, at and above ``GROUP``: integers exactly, gates and aux within
1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro.models import moe as ref_moe
from repro.models.zoo import build_model as ref_build
from repro_torch.launch.mesh import launch
from repro_torch.models import moe as pt_moe
from repro_torch.models.params import from_reference
from repro_torch.sharding import comm

from _torch_parity import smoke_configs

# leaves initialized to zeros (held to their Adam steps' rounding)
_ZERO_INIT = ("conv_b']", "A_log']", "dt_bias']", "b_i']", "b_z']",
              "b_o']")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the unsharded runs by case, {mesh: per-rank results by case})."""
    tmp = tmp_path_factory.mktemp("families_sharded")
    cases = tuple(R.FAMILIES_SHARDED)
    ranks = {(1, 2): launch(R.families_rank, (1, 2),
                            args=(cases, R.FAMILIES_TRACED),
                            init_dir=str(tmp)),
             (2, 2): launch(R.families_rank, (2, 2),
                            args=(R.FAMILIES_SHARDED_22,),
                            init_dir=str(tmp))}
    unsharded, by_config = {}, {}
    for case in cases:
        arch, _, kw = R.FAMILIES_SHARDED[case]
        key = (arch,) + tuple(sorted(kw.items()))
        if key not in by_config:
            by_config[key] = R.family_run(arch, **kw)
        unsharded[case] = by_config[key]
    return unsharded, ranks


MESH_CASES = [((1, 2), c) for c in R.FAMILIES_SHARDED] + \
    [((2, 2), c) for c in R.FAMILIES_SHARDED_22]


def _id(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("shape,case", MESH_CASES,
                         ids=[f"{_id(s)}-{c}" for s, c in MESH_CASES])
def test_sharded_family_steps_match_unsharded(runs, shape, case):
    unsharded, ranks = runs
    want = unsharded[case]
    moe = want["router"] is not None
    for rank in ranks[shape]:
        got = rank[case]
        np.testing.assert_allclose(np.array(got["rows"]),
                                   np.array(want["rows"]), rtol=1e-5)
        assert sorted(got["master"]) == sorted(want["master"])
        for key, w in want["master"].items():
            tol = 1e-4 if key.endswith(_ZERO_INIT) else 1e-5
            np.testing.assert_allclose(
                got["master"][key], w, rtol=0,
                atol=tol * float(np.abs(w).max()), err_msg=key)
        if moe:
            np.testing.assert_allclose(
                got["router"], want["router"], rtol=0,
                atol=1e-5 * float(np.abs(want["router"]).max()))
    if moe:
        strategy = R.FAMILIES_SHARDED[case][1]
        batch_axes = ("data",) if strategy == "dp_tp" else ("data", "model")
        summed = {"kept": 0, "dropped": 0}
        for rank in ranks[shape]:
            if all(v == 0 for a, v in rank[case]["coords"].items()
                   if a not in batch_axes):
                for k in summed:
                    summed[k] += rank[case]["choices"][k]
        assert summed == want["choices"]
        assert want["choices"]["dropped"] > 0     # tokens drop
    else:
        assert want["choices"] == {"kept": 0, "dropped": 0}


def test_sharded_moe_step_nodes_equal_its_collectives_and_kernel_calls(
        runs):
    """granite's last dp_tp step on (1, 2), traced on fake tensors before
    it ran: its collective nodes by kind (the routing's all-gather over
    'data' is of one rank there, so none) equal the collectives the step
    ran on this rank, its forward kernel nodes its kernel calls."""
    for rank in runs[1][(1, 2)]:
        step = rank[R.FAMILIES_TRACED]["step"]
        assert step["nodes"] == step["collectives"]
        assert step["nodes"]["all-reduce"] > 0
        assert step["kernel_nodes"] == step["kernel_calls"]
        assert step["kernel_nodes"]["ops.attention"] > 0


class _Ranks:
    """The mesh of one rank of ``n`` over 'data', for ``_route_rows``."""

    def __init__(self, n: int, index: int):
        self.n, self.i = n, index

    def axis_size(self, axes):
        return self.n

    def index(self, axes):
        return self.i


@pytest.mark.parametrize("seq", [32, 64, 192, 256])
@pytest.mark.parametrize("n", [2, 4])
def test_rank_routing_matches_reference_route(n, seq, monkeypatch):
    """One batch of 4 rows (128, 256, 768 and 1024 tokens: one group
    below GROUP, one of GROUP, 3 and 4 groups of it, so a rank's tokens
    start inside a group) cut into ``n`` rank blocks of rows: each
    rank's ``_route_rows`` (the gathered choices and the aux's means
    given as the collectives would return them), at a capacity factor of
    0.25 (tokens drop in every group), gives the reference's
    ``_route`` of the whole batch, grouped as the unsharded layer groups
    it, for its tokens: choices, capacity slots, keep mask and capacity
    exactly, gates and aux within 1e-6; the other ranks' positions of
    its slab are never kept."""
    rc, pc = smoke_configs(arch="granite-moe-3b-a800m")
    rc = dataclasses.replace(rc, moe=dataclasses.replace(
        rc.moe, capacity_factor=0.25))
    pc = dataclasses.replace(pc, moe=dataclasses.replace(
        pc.moe, capacity_factor=0.25))
    params = jax.device_get(ref_build(rc).init(jax.random.PRNGKey(0)))
    pm_r = jax.tree.map(lambda a: np.asarray(a[0]),
                        params["main"]["b0_moe"]["moe"])
    pm_p = from_reference(pm_r, device="cpu")
    x = np.random.RandomState(1).standard_normal(
        (4, seq, rc.d_model)).astype(np.float32)
    T, K, G = 4 * seq, rc.moe.experts_per_token, min(pt_moe.GROUP, 4 * seq)
    want = ref_moe._route(pm_r, rc, jnp.asarray(x.reshape(T // G, G, -1)))
    w_idx, w_gk, w_pos, w_keep, w_c, w_aux = (np.asarray(a) for a in want)
    blocks = torch.from_numpy(x).chunk(n, dim=0)
    gates = [pt_moe._gates(pm_p, pc, b) for b in blocks]
    whole = torch.cat([g[2].reshape(-1, K) for g in gates]).to(torch.int32)
    means = torch.stack([torch.stack([
        g[0].mean(dim=(0, 1)),
        pt_moe._one_hot(g[2][..., 0], pc.moe.num_experts,
                        torch.float32).mean(dim=(0, 1))]) for g in gates])
    monkeypatch.setattr(comm, "all_gather", lambda t, axes, mesh, dim=-1:
                        whole)
    monkeypatch.setattr(comm, "mean_over", lambda t, axes, mesh:
                        means.mean(dim=0))
    T_l = T // n
    for r, blk in enumerate(blocks):
        slab, lo, idx, gk, pos, keep, C, aux = pt_moe._route_rows(
            pm_p, pc, blk, _Ranks(n, r), ("data",))
        assert C == int(w_c)
        own = slice(lo, lo + T_l)
        mine = slice(r * T_l, (r + 1) * T_l)
        for got, ref in ((idx, w_idx), (pos, w_pos), (keep, w_keep)):
            np.testing.assert_array_equal(
                got.reshape(-1, K)[own].numpy(), ref.reshape(-1, K)[mine])
        np.testing.assert_allclose(gk.reshape(-1, K)[own].numpy(),
                                   w_gk.reshape(-1, K)[mine], atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(float(aux), float(w_aux), atol=1e-6,
                                   rtol=1e-6)
        rest = torch.ones(keep.reshape(-1, K).shape[0], dtype=torch.bool)
        rest[own] = False
        assert not bool(keep.reshape(-1, K)[rest].any())
        assert torch.equal(slab.reshape(-1, slab.shape[-1])[own],
                           blk.reshape(T_l, -1))
    assert not w_keep.all()                       # tokens drop


class _Sharder:
    """A sharder that holds only a mesh, for ``_gates``."""

    def __init__(self, mesh):
        self.mesh = mesh


@pytest.mark.parametrize("spec", [(None, None), ("model", None),
                                  (None, "model")])
def test_router_gathered_as_its_layout_says(spec, monkeypatch):
    """``_gates`` gathers the router whole on the dim and axes its spec in
    the layer's layout names, and only then: no layout, or a spec with
    no axis (serving binds the router whole), takes it as given. The
    gathered router's probabilities, gates and choices equal the whole
    router's bit for bit."""
    from repro_torch.sharding.ctx import sharding_ctx
    _, pc = smoke_configs(arch="granite-moe-3b-a800m")
    rng = np.random.RandomState(2)
    router = torch.from_numpy(rng.standard_normal(
        (pc.d_model, pc.moe.num_experts)).astype(np.float32) * 0.02)
    x = torch.from_numpy(rng.standard_normal(
        (2, 16, pc.d_model)).astype(np.float32))
    want = pt_moe._gates({"router": router}, pc, x)
    calls, mesh = [], object()
    dim = next((i for i, a in enumerate(spec) if a is not None), None)
    block = router if dim is None else router.chunk(2, dim=dim)[0]

    def gather_from(t, axes, m, dim=-1):
        calls.append((axes, m, dim))
        return router
    monkeypatch.setattr(comm, "gather_from", gather_from)
    with sharding_ctx(_Sharder(mesh)):
        got = pt_moe._gates({"router": block}, pc, x,
                            {"router": spec, "w_up": (None,) * 3})
    assert calls == ([] if dim is None else [("model", mesh, dim)])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert pt_moe._gates({"router": router}, pc, x, None)[2].equal(want[2])
