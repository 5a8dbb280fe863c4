"""Train state: compute params (bf16 by default) + f32 master weights and
f32 AdamW moments.

Port of src/repro/train/state.py, plus ``from_reference``, which carries
a reference ``TrainState`` over (for the parity tests).
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
           device) -> TrainState:
    """Random f32 master weights from a seeded generator on ``device``,
    compute params cast from them, zero moments, step 0."""
    master = model.init(seed, device=device, dtype=torch.float32)
    params = P.tree_map(lambda p: p.to(compute_dtype, copy=True), master)
    return TrainState(params=params, master=master, opt=adamw.init(master),
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
