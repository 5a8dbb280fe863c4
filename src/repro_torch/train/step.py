"""Train-step factory: mixed-precision AdamW step with optional gradient
accumulation, int8 gradient compression and global-norm clipping, on
one device or sharded over a mesh of ranks (``dp_tp``, ``fsdp``).

Port of src/repro/train/step.py. Gradients are taken by autograd with
respect to the compute params and clipped in place; the f32 master
weights and moments are updated in place and the next compute params
are FRESH tensors cast from the master, so a caller may hold the
pre-step params (the training detectors compare them with the post-step
ones).

Under a strategy (sharding/rules.py) every rank runs this step on its
own blocks: its rows of the batch (``rank_batch``), its params in the
strategy's param layout (bound on the sharder, so that each layer knows
which of its leaves are blocks), its master and moments in the ZeRO
layout (``train/state.py:state_specs``). Every model family trains
under both strategies. The model's forward places the collectives
(models/layers.py, models/lm.py, models/moe.py, train/fused_xent.py):
under dp_tp the MoE experts run over 'model' and the recurrent blocks
on leaves gathered whole; the MoE layer routes a rank's rows as the
whole batch's (its groups, capacity and aux loss), and each rank's
gradient is its rows' part of the whole batch's loss's.
The step then sums each gradient over the batch axes its layout does
not shard (the fsdp gather's backward already reduce-scattered over the
others) — once — and reshards it to the ZeRO layout, where the
reference constrains the gradients to the optimizer specs; int8
compression takes each whole leaf's scale, the clip the whole tree's
norm, AdamW runs on the shards, and the new master is cast and
resharded into fresh params.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.optim.schedule import lr_at
from repro_torch.sharding import comm
from repro_torch.sharding.ctx import sharding_ctx
from repro_torch.train import state as S

def _like(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) put back into ``tree``'s shape."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _compress_int8_ef(g: torch.Tensor, mesh=None,
                      axes=()) -> torch.Tensor:
    """int8 quantize-dequantize with a per-tensor scale: the wire format
    of the cross-pod gradient all-reduce (error feedback is carried by
    the optimizer moments). With a ``mesh``, g is a block of a leaf
    sharded over ``axes``, and the scale is the whole leaf's (the
    blocks' largest magnitude, reduced with max)."""
    gf = g.to(torch.float32)
    amax = torch.amax(torch.abs(gf))
    if mesh is not None:
        amax = comm.all_reduce(amax, axes, mesh, op="max")
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return (q.to(torch.float32) * scale).to(g.dtype)


def rank_batch(batch: Dict[str, Any], strategy,
               microbatches: int = 1) -> Dict[str, Any]:
    """This rank's rows of a global batch (numpy arrays or tensors, the
    batch first): its block over the strategy's batch axes of each of
    the ``microbatches`` consecutive microbatches, in order, so that the
    step's microbatch split gives each microbatch's block (the
    reference's microbatches are of the global batch)."""
    mesh, axes = strategy.mesh, strategy.batch_axes
    n, i, k = mesh.axis_size(axes), mesh.index(axes), max(microbatches, 1)
    out = {}
    for key, a in batch.items():
        B = a.shape[0]
        if B % (n * k):
            raise ValueError(f"batch {B} does not divide over {n} ranks of "
                             f"{axes} x {k} microbatches")
        blk = B // (n * k)
        a = a.reshape((k, B // k) + tuple(a.shape[1:]))
        a = a[:, i * blk:(i + 1) * blk].reshape((B // n,)
                                                + tuple(a.shape[2:]))
        out[key] = a.contiguous() if torch.is_tensor(a) else a.copy()
    return out


def make_train_step(model, tc: TrainConfig, strategy=None):
    """Returns train_step(state, batch) -> (new_state, metrics); batch is
    {"tokens", "labels"} (B,S) int tensors on the params' device (and
    "frames" (B,F,d) for the audio family, "img" (B,N_img,d) for the vlm
    family; microbatches split every entry along the batch). Under a
    ``strategy`` each rank calls it with its state share and its
    ``rank_batch``; the metrics are the whole batch's on every rank."""
    model.remat = tc.remat
    sharder = specs = mesh = None
    if strategy is not None:
        sharder = _bound_sharder(model, strategy)
        specs = S.state_specs(model, strategy)
        mesh = strategy.mesh

    def value_and_grad(params, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad(), sharding_ctx(sharder):
            loss, metrics = model.loss(live, batch, z_loss=tc.z_loss)
            leaves = tree_leaves(live)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # dense (no expanded views), as the in-place clip writes them
        grads = [torch.zeros_like(p) if g is None else g.contiguous()
                 for g, p in zip(grads, leaves)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, _like(params, grads)

    def compute_grads(params, batch):
        k = tc.microbatches
        if k <= 1:
            return value_and_grad(params, batch)
        n = batch["tokens"].shape[0] // k
        acc = None
        for i in range(k):
            mb = {key: t[i * n:(i + 1) * n] for key, t in batch.items()}
            loss, metrics, grads = value_and_grad(params, mb)
            if acc is None:
                acc = tree_map(lambda g: g.to(torch.float32), grads)
            else:
                for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                    a.add_(g)
        return loss, metrics, tree_map(lambda g: g / k, acc)

    def to_opt_layout(grads):
        """Each gradient summed over the batch axes its param layout does
        not shard, then resharded to the ZeRO layout."""
        from repro_torch.sharding.rules import map2, reshard, spec_axes

        def one(g, p_spec, o_spec):
            axes = tuple(a for a in strategy.batch_axes
                         if a not in spec_axes(p_spec))
            return reshard(comm.all_reduce(g, axes, mesh), p_spec, o_spec,
                           mesh)
        return map2(one, grads, specs.params, specs.master)

    def train_step(state: S.TrainState, batch: Dict[str, Any]):
        loss, metrics, grads = compute_grads(state.params, batch)
        if strategy is not None:
            grads = to_opt_layout(grads)
        if tc.grad_compression == "int8_ef":
            if strategy is None:
                grads = tree_map(_compress_int8_ef, grads)
            else:
                from repro_torch.sharding.rules import map2, spec_axes
                grads = map2(lambda g, s: _compress_int8_ef(
                    g, mesh, spec_axes(s)), grads, specs.master)
        # in place: the clipped tree is not a second copy of the grads
        gnorm = adamw.clip_by_global_norm_(
            grads, tc.grad_clip, mesh,
            None if specs is None else specs.master)
        lr = lr_at(tc, state.step)
        master, opt = adamw.update(tc, grads, state.opt, state.master, lr,
                                   state.step)
        del grads
        params = _fresh_params(master, state.params, specs, mesh)
        new_state = S.TrainState(params=params, master=master, opt=opt,
                                 step=state.step + 1)
        metrics = dict(metrics)
        metrics.update(loss=loss, grad_norm=gnorm, lr=lr)
        return new_state, metrics

    return train_step


def _fresh_params(master, params, specs, mesh):
    """The next compute params: the master cast to each param's dtype (a
    copy), resharded from the ZeRO layout to the param layout under a
    strategy."""
    if specs is None:
        return _like(params, [
            m.to(p.dtype, copy=True) for m, p in
            zip(tree_leaves(master), tree_leaves(params))])
    from repro_torch.sharding.rules import map2, reshard
    with torch.no_grad():
        return map2(lambda m, p, o_spec, p_spec: reshard(
            m.to(p.dtype, copy=True), o_spec, p_spec, mesh),
            master, params, specs.master, specs.params)


def _bound_sharder(model, strategy):
    """The strategy's sharder with its param layout bound
    (``Sharder.bind_params``), from which the layers learn which of a
    layer's leaves are this rank's blocks (``lm._layer_layout``), and
    with each rank's forward on its rows of the batch (``rank_batch``),
    which the MoE layer routes as the whole batch's."""
    sharder = strategy.sharder()
    sharder.bind_params(strategy.param_specs(model), rank_rows=True)
    return sharder


def make_eval_step(model, strategy=None):
    """Forward-only step (prefill / eval): batch -> (logits, aux). Under a
    ``strategy`` each rank passes its params and its rows of the batch,
    and gets its rows' logits, every vocab entry whole."""
    sharder = (_bound_sharder(model, strategy) if strategy is not None
               else None)

    def eval_step(params, batch):
        with torch.no_grad(), sharding_ctx(sharder):
            return model.forward(params, batch["tokens"],
                                 img=batch.get("img"),
                                 frames=batch.get("frames"))
    return eval_step
