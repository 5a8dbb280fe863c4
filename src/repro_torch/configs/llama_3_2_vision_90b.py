"""llama-3.2-vision-90b [vlm] — LM backbone with cross-attn image layers
every 5th layer; patch embeddings stubbed [hf:meta-llama/Llama-3.2-Vision]."""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        rope_theta=5e5,
        cross_attn_period=5,     # 20 cross-attention layers out of 100
        num_image_tokens=1024,
    )
