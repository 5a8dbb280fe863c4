"""LM-head + softmax cross-entropy from the final hidden states: the
vocab-parallel fused loss, and the plain one.

Port of src/repro/train/fused_xent.py. ``make_fused_xent`` is the
Megatron vocab-parallel loss: each rank of 'model' computes only its
block of the vocabulary's logits (never the whole (B, S, V) tensor),
the ranks exchange two (B, S) row statistics (a max and a sum), and the
backward recomputes the local logits and forms ``softmax * scale -
onehot`` on the block, ``dx`` summed over 'model'. Where the reference
writes it as a ``custom_vjp`` under ``shard_map``, here it is one
``torch.autograd.Function`` run on every rank with its own tensors, the
collectives those of sharding/comm.py. Its ``dw`` is this rank's rows'
part of the reference's: the reference sums it over the data-parallel
axes inside the loss, here the train step sums every parameter's
gradient over them once (train/step.py), the head's with the rest.

The head product stays a plain ``torch.matmul`` in the activations'
dtype, as the reference leaves it to XLA, and its local logits are then
widened to float32 (the reference asks XLA for float32 products:
the same in float32, one rounding apart in bfloat16); every statistic,
the softmax and the loss are float32.

``lm_loss`` dispatches as the reference does: the fused path under a
strategy whose 'model' axis carries no batch, whose padded vocabulary
divides it and whose batch divides the data-parallel ranks; the plain
path otherwise (fsdp, where the batch covers every axis and a rank's
logits are small), each rank's mean then averaged over the batch axes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.layers import lm_head
from repro_torch.sharding import comm
from repro_torch.train.loss import log_softmax_terms


def _plain(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
           z_loss: float) -> torch.Tensor:
    """Mean nll over all positions and the whole padded vocabulary (the
    padded rows are not masked, as in the reference)."""
    lse, ll = log_softmax_terms(lm_head(x, w.to(x.dtype)), labels)
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def _local_fwd(x_l, w_l, lab_l, mesh):
    """This rank's float32 logits block (b, s, v/tp), and the whole
    vocabulary's lse and label logit (b, s)."""
    logits = torch.matmul(x_l, w_l.to(x_l.dtype).T).to(torch.float32)
    m = comm.all_reduce(torch.amax(logits, dim=-1), "model", mesh, op="max")
    se = comm.all_reduce(torch.sum(torch.exp(logits - m[..., None]), dim=-1),
                         "model", mesh)
    lse = torch.log(se) + m
    v_l = w_l.shape[0]
    local = lab_l.long() - mesh.index("model") * v_l
    inside = (local >= 0) & (local < v_l)
    idx = local.clamp(0, v_l - 1)
    ll_l = torch.gather(logits, -1, idx[..., None])[..., 0]
    ll = comm.all_reduce(torch.where(inside, ll_l, torch.zeros_like(ll_l)),
                         "model", mesh)
    return logits, lse, ll, inside, idx


class _FusedXent(torch.autograd.Function):
    """The vocab-parallel loss of one rank: x_l (b, s, d) this rank's
    batch rows, w_l (V/tp, d) its vocab block, lab_l (b, s) its labels;
    the whole batch's mean loss on every rank."""

    @staticmethod
    def forward(ctx, x_l, w_l, lab_l, mesh, dp_axes, z_loss):
        with torch.no_grad():
            _, lse, ll, _, _ = _local_fwd(x_l, w_l, lab_l, mesh)
            ntok = lab_l.numel()
            loss = torch.sum(lse - ll) / ntok
            if z_loss:
                loss = loss + z_loss * torch.sum(torch.square(lse)) / ntok
            loss = comm.all_reduce(loss, dp_axes, mesh) \
                / mesh.axis_size(dp_axes)
        ctx.save_for_backward(x_l, w_l, lab_l)
        ctx.mesh, ctx.dp_axes, ctx.z_loss = mesh, dp_axes, z_loss
        return loss

    @staticmethod
    def backward(ctx, g):
        x_l, w_l, lab_l = ctx.saved_tensors
        mesh, dp_axes, z_loss = ctx.mesh, ctx.dp_axes, ctx.z_loss
        with torch.no_grad():
            logits, lse, _, inside, idx = _local_fwd(x_l, w_l, lab_l, mesh)
            dl = torch.exp(logits - lse[..., None])        # local softmax
            del logits
            if z_loss:
                dl.mul_((1.0 + 2.0 * z_loss * lse)[..., None])
            # minus the one-hot at the label slot (in its block only)
            dl.scatter_add_(-1, idx[..., None],
                            -inside.to(dl.dtype)[..., None])
            ntok = lab_l.numel() * mesh.axis_size(dp_axes)
            dl.mul_(g / ntok)
            dl = dl.to(x_l.dtype)
            dx = comm.all_reduce(dl @ w_l.to(dl.dtype), "model", mesh)
            dw = (dl.reshape(-1, dl.shape[-1]).T
                  @ x_l.reshape(-1, x_l.shape[-1]))
        return dx.to(x_l.dtype), dw.to(w_l.dtype), None, None, None, None


def make_fused_xent(mesh, dp_axes: Tuple[str, ...], z_loss: float = 0.0):
    """Returns loss_fn(x_l, w_l, labels_l) -> the whole batch's loss (0-d
    float32, the same on every rank), differentiable in x_l and w_l.

    x_l: (b, s, d) this rank's rows of the batch (its index over
    ``dp_axes``) in the compute dtype; w_l: (V/tp, d) its block of the
    vocab-major head (its index over 'model'); labels_l: (b, s) int.
    dx is the gradient of the whole batch's loss (summed over 'model'),
    dw this rank's rows' part of it (summed over ``dp_axes``, the
    reference's)."""
    dp_axes = tuple(dp_axes)

    def fused(x_l, w_l, labels_l):
        return _FusedXent.apply(x_l, w_l, labels_l, mesh, dp_axes, z_loss)
    return fused


def lm_loss(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *,
            z_loss: float = 0.0, sharder=None,
            vocab: Optional[int] = None) -> torch.Tensor:
    """x: (B,S,d) compute dtype; w: (V,d) vocab-major head, or under a
    strategy this rank's block of its ``vocab`` rows; labels: (B,S) int.
    Without a sharder: the mean nll (``_plain``). With one: x and labels
    are this rank's rows of the batch, and the result is the whole
    batch's loss on every rank, through the fused path where the
    reference takes it, else through ``_plain`` averaged over the batch
    axes. Every gradient it gives a rank is that rank's rows' part of the
    whole batch's: the train step sums each parameter's over the batch
    axes once (train/step.py)."""
    if sharder is None:
        return _plain(x, w, labels, z_loss)
    mesh = sharder.mesh
    dp = tuple(sharder.batch_axes)
    tp = mesh.shape.get("model", 1)
    V = vocab if vocab is not None else w.shape[0]
    if "model" in mesh.shape and "model" not in dp and V % tp == 0:
        # the global batch (each rank holds 1/dpn of it) divides the dp
        # ranks by construction: the reference's B % dpn rule holds
        if w.shape[0] == V:
            w = comm.block_of(w, "model", mesh, dim=0)
        return make_fused_xent(mesh, dp, z_loss)(x, w, labels)
    if w.shape[0] != V:
        w = comm.gather_from(w, "model", mesh, dim=0)
    return comm.mean_over(_plain(x, w, labels, z_loss), dp, mesh)

