"""whisper-large-v3 [audio] — enc-dec backbone; conv frontend STUBBED
(input_specs provides precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="audio",
        num_layers=32,             # decoder layers
        encoder_layers=32,
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,           # MHA
        head_dim=64,
        d_ff=5120,
        vocab_size=51866,
        gated_mlp=False,           # whisper uses plain-GELU MLP
        rope_theta=1e4,            # backbone positional: rope stand-in
        encoder_frames=1500,
    )
