"""Model zoo facade: build models from configs; analytic parameter counts."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as P
from repro_torch.models.lm import LM


def build_model(cfg: ModelConfig) -> LM:
    return LM(cfg)


def count_params_analytic(cfg: ModelConfig) -> int:
    """Parameter count derived from the declaration tree (dense family)."""
    return int(P.count_tree(LM(cfg).decl()))
