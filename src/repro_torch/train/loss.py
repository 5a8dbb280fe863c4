"""LM losses.

Port of src/repro/train/loss.py. The label log-probability is read with a
gather, which equals the reference's one-hot contraction (exactly one
term of the sum is nonzero) without a (B, S, V) one-hot tensor.
"""
from __future__ import annotations

import torch


def log_softmax_terms(logits: torch.Tensor, labels: torch.Tensor):
    """``(lse, ll)`` per position in f32: the log-sum-exp over the whole
    (padded) vocabulary, with the max held out of the gradient as the
    reference's stop_gradient, and the label's logit."""
    lf = logits.to(torch.float32)
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return lse, ll


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0):
    """logits: (B,S,V); labels: (B,S) int. Returns (loss, metrics)."""
    lse, ll = log_softmax_terms(logits, labels)
    loss = torch.mean(lse - ll)
    metrics = {"nll": loss}
    if z_loss:
        zl = z_loss * torch.mean(torch.square(lse))
        loss = loss + zl
        metrics["z_loss"] = zl
    return loss, metrics
