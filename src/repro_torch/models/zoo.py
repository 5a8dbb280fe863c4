"""Model zoo facade: build models from configs; analytic parameter counts."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models.lm import LM


def build_model(cfg: ModelConfig) -> LM:
    return LM(cfg)


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count derived from the declaration tree.

    active_only: for MoE, count only experts_per_token of num_experts
    routed experts (plus everything else): the N_active of MODEL_FLOPS."""
    total = P.count_tree(LM(cfg).decl())
    if active_only and cfg.moe is not None:
        m = cfg.moe
        # routed expert params per layer (up + gate + down)
        per_expert = 3 * cfg.d_model * m.expert_d_ff
        total -= (m.num_experts - m.experts_per_token) * per_expert \
            * cfg.num_layers
    return int(total)
