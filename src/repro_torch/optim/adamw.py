"""AdamW with decoupled weight decay over nested-dict parameter trees.

Port of src/repro/optim/adamw.py: f32 master parameters and f32 moments,
all arithmetic in f32 in the reference's order. Unlike the functional
reference, ``update`` writes the master and the moments IN PLACE (at
full width each is 6.9 GB; a functional update would hold two copies).
The object-registry hook of ``init`` comes with the object tier.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.params import tree_leaves, tree_map


class AdamWState(NamedTuple):
    m: Any
    v: Any


def init(params: Any) -> AdamWState:
    """Zero f32 moments shaped like ``params``."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def update(tc: TrainConfig, grads: Any, state: AdamWState, master: Any,
           lr: torch.Tensor, step: torch.Tensor):
    """One AdamW step at ``step`` (0-based) with learning rate ``lr``.
    Updates ``master`` and ``state`` in place and returns them as
    ``(master, state)``."""
    b1, b2, eps, wd = tc.b1, tc.b2, tc.eps, tc.weight_decay
    count = torch.as_tensor(step).to(torch.float32) + 1.0
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=count.device), count)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=count.device), count)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v), tree_leaves(master)):
        g = g.to(torch.float32)
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * torch.square(g))
        mhat = m / c1
        vhat = v / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + wd * p
        p.sub_(lr * delta)
    return master, state


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-d tensor)."""
    sq = [torch.sum(torch.square(t.to(torch.float32)))
          for t in tree_leaves(tree)]
    return torch.sqrt(functools.reduce(torch.add, sq))


def clip_by_global_norm(tree: Any, max_norm: float):
    """``(tree scaled to global norm <= max_norm, its norm before)``;
    each leaf keeps its dtype."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    tree), norm
