"""Elastic restart: resume a checkpoint onto a different mesh.

Port of src/repro/checkpoint/elastic.py. Checkpoint leaves are stored
whole, so restoring onto a grown or shrunk device set is a matter of
rebuilding the mesh from however many devices survived
(``launch.mesh.make_elastic_mesh``), recomputing the strategy's spec
trees against it and cutting each leaf to the rank's slice. Data order
is preserved because the synthetic pipeline is a pure function of
(seed, step).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.graph_trace import abstract_mode
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.sharding.rules import make_strategy
from repro_torch.train import state as TS


def resume_elastic(ckpt_dir: str, model, strategy_name: str = "dp_tp",
                   num_devices: Optional[int] = None,
                   step: Optional[int] = None, *, rank: int = 0,
                   device="cpu"):
    """Returns (mesh, strategy, restored TrainState): the mesh of
    ``num_devices`` ranks (default: the visible CUDA devices, else 1)
    seen from ``rank``, the strategy on it, and the rank's slice of every
    leaf (as ``TS.state_specs`` gives it) on ``device``."""
    n = num_devices or max(torch.cuda.device_count(), 1)
    mesh = make_elastic_mesh(n, rank=rank)
    strat = make_strategy(strategy_name, mesh)
    specs = TS.state_specs(model, strat)
    template = TS.abstract(model, device=device, mode=abstract_mode())
    state = Checkpointer(ckpt_dir).restore(template, step=step, specs=specs,
                                           mesh=mesh, device=device)
    return mesh, strat, state
