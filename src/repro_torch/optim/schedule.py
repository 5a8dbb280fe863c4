"""Warmup-cosine learning-rate schedule (pure function of step).

Port of src/repro/optim/schedule.py: the same f32 arithmetic, as a 0-d
tensor on the step's device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def lr_at(tc: TrainConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (an int or a 0-d tensor): linear warmup
    from 0 over ``warmup_steps``, then a cosine from 1 to 0.1 of the peak
    over the rest of ``total_steps``. ``lr_at(0) == 0``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - tc.warmup_steps)
                       / max(tc.total_steps - tc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)
