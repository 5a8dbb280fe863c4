"""LM-head + softmax cross-entropy from the final hidden states.

Port of the no-mesh part of src/repro/train/fused_xent.py (``lm_loss``
-> ``_plain``): the head product stays a plain ``torch.matmul``, as the
reference leaves it to XLA. The vocab-parallel ``shard_map`` path comes
with the sharded train step (ROADMAP A11b).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import lm_head
from repro_torch.train.loss import log_softmax_terms


def lm_loss(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, *,
            z_loss: float = 0.0) -> torch.Tensor:
    """x: (B,S,d) compute dtype; w: (V,d) vocab-major head; labels:
    (B,S) int. Mean nll over all positions and the whole padded
    vocabulary (the padded rows are not masked, as in the reference)."""
    lse, ll = log_softmax_terms(lm_head(x, w.to(x.dtype)), labels)
    loss = torch.mean(lse - ll)
    if z_loss:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss
