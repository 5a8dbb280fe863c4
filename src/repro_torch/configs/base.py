"""Config dataclasses for models, shapes and the profiler.

Every assigned architecture gets one module in this package exporting
``get_config() -> ModelConfig`` with the exact published numbers. Reduced
("smoke") variants are derived mechanically via ``ModelConfig.smoke()`` so
CPU tests exercise the same code paths as the full dry-run configs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    # d_ff of each expert (the ModelConfig.d_ff field for MoE archs).
    expert_d_ff: int
    # llama4-style always-on shared expert (same d_ff as routed experts).
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # Load-balancing auxiliary loss coefficient (Switch/GShard style).
    aux_loss_coef: float = 0.01
    # "scatter": capacity-mask scatter dispatch (mode=drop) — only routed
    # rows of the (B,E,C,d) expert buffer are ever written, so the
    # dead-expert-store fraction is 0 by construction. "einsum": the
    # GShard one-hot dispatch/combine einsums, kept as the A/B reference
    # (materializes every buffer row; unrouted rows are Def.-1 dead
    # stores).
    dispatch: str = "scatter"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style state-space block config."""
    state_dim: int = 64
    conv_width: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block schedule: mostly mLSTM with sLSTM every `slstm_period`."""
    slstm_period: int = 8      # every 8th block is sLSTM, rest mLSTM
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333333
    chunk_size: int = 256      # chunkwise-parallel mLSTM chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # Gated (SwiGLU) vs plain-GELU MLP. starcoder2 uses plain; most use gated.
    gated_mlp: bool = True
    # --- MoE ---
    moe: Optional[MoEConfig] = None
    # --- VLM: every `cross_attn_period`-th decoder layer is cross-attention
    # to stubbed patch embeddings (0 = none).
    cross_attn_period: int = 0
    num_image_tokens: int = 1024
    # --- audio (enc-dec): encoder depth; frontend stubbed to frame embeds.
    encoder_layers: int = 0
    encoder_frames: int = 1500
    # --- hybrid (zamba2): mamba2 blocks + shared attention every N blocks.
    ssm: Optional[SSMConfig] = None
    attn_period: int = 0        # 0 = no interleaved shared-attn block
    # --- ssm family (xlstm) ---
    xlstm: Optional[XLSTMConfig] = None
    # Whether full (quadratic) attention is used anywhere => long_500k skip.
    subquadratic: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (MXU lane alignment + clean
        16-way sharding). Embedding rows beyond vocab_size are never
        selected; decode masks padded logits to -inf."""
        return -(-self.vocab_size // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    # ------------------------------------------------------------------
    def smoke(self) -> "ModelConfig":
        """Mechanically reduced config for CPU smoke tests.

        Preserves the block schedule structure (moe/hybrid/vlm/encdec
        periods) while shrinking width/depth/vocab.
        """
        period = 1
        if self.attn_period:
            period = max(period, self.attn_period)
        if self.cross_attn_period:
            period = max(period, self.cross_attn_period)
        if self.xlstm is not None:
            period = max(period, self.xlstm.slstm_period)
        layers = max(2, 2 * period)
        kw = dict(
            name=self.name + "-smoke",
            num_layers=layers,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4,
                experts_per_token=min(2, self.moe.experts_per_token),
                expert_d_ff=64)
            kw["d_ff"] = 64
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, chunk_size=8)
        if self.xlstm is not None:
            kw["xlstm"] = dataclasses.replace(self.xlstm, chunk_size=8)
        if self.encoder_layers:
            kw["encoder_layers"] = 2
            kw["encoder_frames"] = 16
        if self.cross_attn_period:
            kw["num_image_tokens"] = 8
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The four assigned LM shapes (identical sets for all 10 archs).
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # microbatches for gradient accumulation (1 = no accumulation)
    microbatches: int = 1
    # activation checkpointing policy: none | dots | full
    remat: str = "dots"
    seed: int = 0
    # gradient compression for cross-pod ("pod" axis) reduction
    grad_compression: str = "none"   # none | int8_ef
    z_loss: float = 0.0


@dataclass(frozen=True)
class ProfilerConfig:
    """JXPerf-JAX configuration (the paper's knobs)."""
    enabled: bool = False
    # Tier-1 sampling period: one sample every `period` memory events.
    period: int = 5000
    # number of software watchpoint slots (paper: 4 debug registers)
    num_watchpoints: int = 4
    # FP approximate-equality tolerance (paper default: 1%)
    fp_tolerance: float = 0.01
    detect: Tuple[str, ...] = ("dead_store", "silent_store", "silent_load")
    # Tier-3 silent-data-load LRU window: max batch-content digests kept
    # (bounds detector memory over arbitrarily long runs)
    batch_hash_window: int = 4096
    seed: int = 0
