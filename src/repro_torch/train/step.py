"""Train-step factory: mixed-precision AdamW step with optional gradient
accumulation, int8 gradient compression and global-norm clipping.

Port of src/repro/train/step.py without a mesh (the sharded strategy is
ROADMAP A11). Gradients are taken by autograd with respect to the
compute params; the f32 master weights and moments are updated in place
and the next compute params are FRESH tensors cast from the master, so a
caller may hold the pre-step params (the training detectors compare
them with the post-step ones).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.optim.schedule import lr_at
from repro_torch.train import state as S


def _like(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) put back into ``tree``'s shape."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _compress_int8_ef(g: torch.Tensor) -> torch.Tensor:
    """int8 quantize-dequantize with a per-tensor scale: the wire format
    of the cross-pod gradient all-reduce (error feedback is carried by
    the optimizer moments)."""
    gf = g.to(torch.float32)
    scale = torch.clamp(torch.amax(torch.abs(gf)), min=1e-8) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return (q.to(torch.float32) * scale).to(g.dtype)


def make_train_step(model, tc: TrainConfig):
    """Returns train_step(state, batch) -> (new_state, metrics); batch is
    {"tokens", "labels"} (B,S) int tensors on the params' device."""
    if tc.remat != "none":
        raise NotImplementedError(
            f"remat={tc.remat!r}: activation checkpointing is not ported "
            f"yet (ROADMAP A6); pass remat='none'")

    def value_and_grad(params, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = model.loss(live, batch, z_loss=tc.z_loss)
            leaves = tree_leaves(live)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
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

    def train_step(state: S.TrainState, batch: Dict[str, Any]):
        loss, metrics, grads = compute_grads(state.params, batch)
        if tc.grad_compression == "int8_ef":
            grads = tree_map(_compress_int8_ef, grads)
        grads, gnorm = adamw.clip_by_global_norm(grads, tc.grad_clip)
        lr = lr_at(tc, state.step)
        master, opt = adamw.update(tc, grads, state.opt, state.master, lr,
                                   state.step)
        del grads
        params = _like(state.params, [
            m.to(p.dtype, copy=True) for m, p in
            zip(tree_leaves(master), tree_leaves(state.params))])
        new_state = S.TrainState(params=params, master=master, opt=opt,
                                 step=state.step + 1)
        metrics = dict(metrics)
        metrics.update(loss=loss, grad_norm=gnorm, lr=lr)
        return new_state, metrics

    return train_step


def make_eval_step(model):
    """Forward-only step (prefill / eval): batch -> (logits, aux)."""
    def eval_step(params, batch):
        with torch.no_grad():
            return model.forward(params, batch["tokens"])
    return eval_step
