"""AdamW with decoupled weight decay over nested-dict parameter trees.

Port of src/repro/optim/adamw.py: f32 master parameters and f32 moments,
all arithmetic in f32 in the reference's order. Unlike the functional
reference, ``update`` writes the master and the moments IN PLACE (at
full width each is 6.9 GB; a functional update would hold two copies),
and works through a large leaf in slices of at most ``SLICE`` elements,
so that its f32 temporaries stay small (a stacked expert leaf of
granite-moe-3b-a800m is 4 GB in f32, and an update of it whole would
hold several such temporaries at once); ``clip_by_global_norm_`` scales
the gradients in place, slice by slice, for the same reason (the
reference returns a clipped copy). Slicing changes no value: every
operation is elementwise. With an object registry, ``init`` registers
every moment leaf (core/objects.py), as the reference's does.

Under a strategy each rank holds its blocks of the gradients, the
master and the moments (the ZeRO layout): ``update`` runs on them as
they are, and ``global_norm`` takes the mesh and the spec tree so that
each block counts once in the whole tree's norm.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.params import tree_leaves, tree_map


# elements of a leaf that the update and the in-place clip take at once
SLICE = 1 << 24


def _slices(*leaves):
    """Matching pieces of same-shaped leaves, split along their first
    dimension into pieces of at most ``SLICE`` elements (a leaf that is
    small or 0-d whole)."""
    t = leaves[0]
    if t.numel() <= SLICE or t.ndim == 0:
        return [leaves]
    rows = max(1, SLICE // (t.numel() // t.shape[0]))
    return zip(*(x.split(rows) for x in leaves))


class AdamWState(NamedTuple):
    m: Any
    v: Any


def init(params: Any, registry=None, owner: str = "opt", *, specs=None,
         mesh=None) -> AdamWState:
    """Zero f32 moments shaped like ``params``. With an `ObjectRegistry`
    (core/objects.py) every moment leaf registers as a live
    ``opt_state`` object: all bit-identical zeros at init, the state the
    replica detector reports as lazy-materializable (``params``' blocks
    under ``specs`` on ``mesh``: each moment as its whole leaf)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    state = AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params))
    if registry is not None:
        from repro_torch.core.objects import register_tree
        for name, tree in (("m", state.m), ("v", state.v)):
            register_tree(registry, f"{owner}/{name}", tree,
                          kind="opt_state", specs=specs, mesh=mesh)
    return state


@torch.no_grad()
def update(tc: TrainConfig, grads: Any, state: AdamWState, master: Any,
           lr: torch.Tensor, step: torch.Tensor):
    """One AdamW step at ``step`` (0-based) with learning rate ``lr``.
    Updates ``master`` and ``state`` in place and returns them as
    ``(master, state)``."""
    b1, b2, eps, wd = tc.b1, tc.b2, tc.eps, tc.weight_decay
    count = torch.as_tensor(step).to(torch.float32) + 1.0
    c1 = 1.0 - torch.pow(torch.full_like(count, b1), count)
    c2 = 1.0 - torch.pow(torch.full_like(count, b2), count)
    for leaf in zip(tree_leaves(grads), tree_leaves(state.m),
                    tree_leaves(state.v), tree_leaves(master)):
        for g, m, v, p in _slices(*leaf):
            g = g.to(torch.float32)
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * torch.square(g))
            mhat = m / c1
            vhat = v / c2
            delta = mhat / (torch.sqrt(vhat) + eps) + wd * p
            p.sub_(lr * delta)
    return master, state


def global_norm(tree: Any, mesh=None, specs: Any = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-d tensor).

    With a ``mesh`` and the ``specs`` tree of the rank's blocks
    (sharding/rules.py), the whole tree's norm on every rank: a leaf's
    block is counted on the one rank of the group that holds it (index
    0 of each axis its spec leaves replicated), and the partial sums
    are all-reduced over every axis of the mesh."""
    if mesh is None:
        sq = [torch.sum(torch.square(t.to(torch.float32)))
              for t in tree_leaves(tree)]
        return torch.sqrt(functools.reduce(torch.add, sq))
    from repro_torch.sharding import comm
    from repro_torch.sharding.rules import map2, owns_block
    sq = map2(lambda t, spec: torch.sum(torch.square(t.to(torch.float32)))
              if owns_block(spec, mesh) else None, tree, specs)
    total = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(tree)[0].device)
    for s in tree_leaves(sq):
        if s is not None:
            total = total + s
    return torch.sqrt(comm.all_reduce(total, mesh.axis_names, mesh))


@torch.no_grad()
def clip_by_global_norm_(tree: Any, max_norm: float, mesh=None,
                         specs: Any = None) -> torch.Tensor:
    """Scale ``tree`` in place to a global norm <= max_norm (each leaf
    keeps its dtype; scaled in f32, slice by slice). Returns the norm
    before (of the whole tree, with a ``mesh`` and ``specs``: see
    ``global_norm``)."""
    norm = global_norm(tree, mesh, specs)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for leaf in tree_leaves(tree):
        for (g,) in _slices(leaf):
            g.copy_((g.to(torch.float32) * scale).to(g.dtype))
    return norm
