"""Train state: compute params (bf16 by default) + f32 master weights and
f32 AdamW moments.

Port of src/repro/train/state.py, plus ``from_reference``, which carries
a reference ``TrainState`` over (for the parity tests). ``state_specs``
gives the spec tree of a strategy (sharding/rules.py) over the state;
under a strategy ``create`` gives each rank its slice of it.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import params as P
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: Any            # compute dtype (bf16), fresh tensors each step
    master: Any            # f32, updated in place by adamw.update
    opt: adamw.AdamWState  # f32, updated in place
    step: torch.Tensor     # 0-d int32 on the params' device


def create(model, seed: int = 0, compute_dtype=torch.bfloat16, *,
           device, registry=None, strategy=None) -> TrainState:
    """Random f32 master weights from a seeded generator on ``device``,
    compute params cast from them, zero moments, step 0. With an object
    registry (core/objects.py) the master and compute trees register as
    ``param`` objects here (``train/master``, ``train/params``) and the
    moments inside `adamw.init`; under a strategy each as the whole leaf
    its blocks make up (``register_tree``'s ``specs``).

    Under a ``strategy`` the whole tree is drawn as without one (so
    every rank's slices are cut from the same leaves) and this rank (its
    mesh's) keeps its ``state_specs`` share: the params in the param
    layout, the master and the moments in the optimizer (ZeRO) layout."""
    master = model.init(seed, device=device, dtype=torch.float32)
    params = P.tree_map(lambda p: p.to(compute_dtype, copy=True), master)
    if strategy is not None:
        cut = shard_state(TrainState(params=params, master=master,
                                     opt=None, step=None), model, strategy)
        params, master = cut.params, cut.master
    on = {}
    if registry is not None:
        from repro_torch.core.objects import register_tree
        specs = (state_specs(model, strategy) if strategy is not None
                 else TrainState(params=None, master=None, opt=None,
                                 step=None))
        mesh = None if strategy is None else strategy.mesh
        register_tree(registry, "train/master", master, kind="param",
                      specs=specs.master, mesh=mesh)
        register_tree(registry, "train/params", params, kind="param",
                      specs=specs.params, mesh=mesh)
        on = dict(specs=specs.master, mesh=mesh)
    return TrainState(params=params, master=master,
                      opt=adamw.init(master, registry=registry, **on),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def abstract(model, compute_dtype=torch.bfloat16, *, device,
             mode) -> TrainState:
    """The state ``create`` makes, as fake tensors (no storage) made
    under the fake-tensor ``mode``: for an abstract trace of the train
    step at any width."""
    master = model.abstract_params(device=device, mode=mode,
                                   dtype=torch.float32)
    with mode:
        def cast(dt):
            return P.tree_map(lambda p: torch.empty(p.shape, dtype=dt,
                                                    device=device), master)
        return TrainState(
            params=cast(compute_dtype), master=master,
            opt=adamw.AdamWState(m=cast(torch.float32),
                                 v=cast(torch.float32)),
            step=torch.zeros((), dtype=torch.int32, device=device))


def from_reference(state, *, device) -> TrainState:
    """The reference's ``TrainState`` as the port's: ``state`` is the
    reference state on the host (``jax.device_get``), its trees nested
    dicts of numpy arrays; every leaf keeps its dtype."""
    def tree(t):
        return P.from_reference(t, device=device)
    return TrainState(
        params=tree(state.params), master=tree(state.master),
        opt=adamw.AdamWState(m=tree(state.opt.m), v=tree(state.opt.v)),
        step=torch.tensor(int(state.step), dtype=torch.int32, device=device))


def state_specs(model, strategy) -> TrainState:
    """Spec tree matching TrainState: the params as the strategy places
    them, master and moments fully sharded (ZeRO-1), the step whole."""
    from repro_torch.sharding.rules import PS
    p_specs = strategy.param_specs(model)
    o_specs = strategy.opt_specs(model)
    return TrainState(params=p_specs, master=o_specs,
                      opt=adamw.AdamWState(m=o_specs, v=o_specs),
                      step=PS())


def shard_state(state: TrainState, model, strategy) -> TrainState:
    """This rank's ``state_specs`` share of a whole state (its mesh's
    rank): each leaf's block, a dense tensor of its own (never a view of
    the whole leaf). A part that is None stays None."""
    from repro_torch.sharding.rules import shard_tree
    specs = state_specs(model, strategy)

    def cut(tree, spec):
        if tree is None:
            return None
        return P.tree_map(
            lambda t: t.clone(memory_format=torch.contiguous_format),
            shard_tree(tree, spec, strategy.mesh))
    opt = None if state.opt is None else adamw.AdamWState(
        m=cut(state.opt.m, specs.opt.m), v=cut(state.opt.v, specs.opt.v))
    return TrainState(params=cut(state.params, specs.params),
                      master=cut(state.master, specs.master), opt=opt,
                      step=state.step)


def gather_state(state: TrainState, model, strategy) -> TrainState:
    """The whole state from every rank's share (each leaf resharded from
    its ``state_specs`` block to ``PS()``, leaf by leaf): collective,
    every rank of the strategy's mesh must call it. The checkpoint's
    layout, and what a sharded step is held to."""
    from repro_torch.sharding.rules import PS, map2, reshard
    specs = state_specs(model, strategy)

    def whole(tree, spec):
        return map2(lambda t, s: reshard(t, s, PS(), strategy.mesh), tree,
                     spec)
    return TrainState(
        params=whole(state.params, specs.params),
        master=whole(state.master, specs.master),
        opt=adamw.AdamWState(m=whole(state.opt.m, specs.opt.m),
                             v=whole(state.opt.v, specs.opt.v)),
        step=state.step)
