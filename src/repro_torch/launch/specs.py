"""Abstract inputs per (arch x shape) cell, as fake tensors.

Port of src/repro/launch/specs.py. The reference gives
``jax.ShapeDtypeStruct``s; here every leaf is a fake tensor
(``core/graph_trace.py:abstract_mode()``: shape, dtype and device, no
storage), so nothing in this module allocates device memory, whatever
the widths. The [audio]/[vlm] backbones receive precomputed frame/patch
embeddings (the modality frontend is a stub), as in the reference.

Each function takes the fake-tensor ``mode`` the trace will run under
(one mode per trace: ``abstract_mode()`` when None) and the ``device``
the fake tensors claim (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.graph_trace import abstract_mode


def _fake(mode, shape, dtype, device) -> torch.Tensor:
    with mode:
        return torch.empty(shape, dtype=dtype, device=device)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *, mode=None,
                device="cuda") -> Dict[str, Any]:
    """Training/prefill batch: tokens + labels (+ modality stubs)."""
    mode = mode or abstract_mode()
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _fake(mode, (B, S), torch.int32, device)}
    if shape.kind == "train":
        batch["labels"] = _fake(mode, (B, S), torch.int32, device)
    if cfg.family == "vlm":
        batch["img"] = _fake(mode, (B, cfg.num_image_tokens, cfg.d_model),
                             torch.bfloat16, device)
    if cfg.family == "audio":
        batch["frames"] = _fake(mode, (B, encoder_len(cfg, shape),
                                       cfg.d_model), torch.bfloat16, device)
    return batch


def encoder_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Stub frame count for the audio backbone at a given shape cell."""
    return shape.seq_len


def decode_inputs(model, cfg: ModelConfig, shape: ShapeConfig, *,
                  mode=None, device="cuda", kv_dtype=torch.bfloat16,
                  params: Optional[Any] = None):
    """(params, cache, tokens) for the serve step: bf16 parameters
    (``params`` when given, e.g. a rank's slices), the dense decode cache
    of ``LM.init_cache`` run under the fake-tensor mode (the audio and
    vlm families' cross K/V computed from fake frames or image tokens, as
    the reference's ``eval_shape`` of it), and (B, 1) int32 tokens.
    Called under a strategy's sharder (``sharding/ctx.py``), the cache is
    that rank's chunk."""
    mode = mode or abstract_mode()
    B, S = shape.global_batch, shape.seq_len
    if params is None:
        params = model.abstract_params(device=device, mode=mode,
                                       dtype=torch.bfloat16)
    kw = {}
    if cfg.family == "vlm":
        kw["img"] = _fake(mode, (B, cfg.num_image_tokens, cfg.d_model),
                          torch.bfloat16, device)
    if cfg.family == "audio":
        kw["frames"] = _fake(mode, (B, encoder_len(cfg, shape), cfg.d_model),
                             torch.bfloat16, device)
    with mode, torch.no_grad():
        cache = model.init_cache(params, B, S, kv_dtype=kv_dtype, **kw)
    tokens = _fake(mode, (B, 1), torch.int32, device)
    return params, cache, tokens
