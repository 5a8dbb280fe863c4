"""Architecture registry: ``--arch <id>`` resolution for all 10 assigned
architectures."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, SHAPES  # noqa: F401

_ARCH_MODULES: Dict[str, str] = {
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1p7b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "llama-3.2-vision-90b": "repro_torch.configs.llama_3_2_vision_90b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1p3b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.get_config()
