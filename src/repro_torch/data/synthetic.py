"""Deterministic synthetic LM data: batches are a pure function of
(seed, step, host). The generator is numpy's Philox, so the port makes
the very tokens the reference makes from the same seed.

The token stream is a mixture of Zipfian unigrams and short copied motifs.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


def batch_at(cfg: ModelConfig, batch: int, seq: int, *, seed: int,
             step: int, host: int = 0, num_hosts: int = 1) -> Dict[str, np.ndarray]:
    """The per-host slice of the global batch at `step`."""
    assert batch % num_hosts == 0
    local = batch // num_hosts
    rng = np.random.Generator(np.random.Philox(
        key=seed, counter=[step, host, 0, 0]))
    V = cfg.vocab_size
    # zipf-ish unigram mixture
    ranks = np.arange(1, V + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(V, size=(local, seq + 1), p=probs).astype(np.int32)
    # plant copyable motifs: repeat a short window later in the sequence
    if seq >= 64:
        w = 16
        src = rng.integers(0, seq // 2 - w, size=local)
        dst = rng.integers(seq // 2, seq - w, size=local)
        for i in range(local):
            toks[i, dst[i]:dst[i] + w] = toks[i, src[i]:src[i] + w]
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["img"] = rng.standard_normal(
            (local, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (local, min(seq, cfg.encoder_frames), cfg.d_model)).astype(np.float32)
    return out


def stream(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
           start_step: int = 0, host: int = 0,
           num_hosts: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """``batch_at`` for steps start_step, start_step + 1, ... (endless)."""
    step = start_step
    while True:
        yield batch_at(cfg, batch, seq, seed=seed, step=step, host=host,
                       num_hosts=num_hosts)
        step += 1
