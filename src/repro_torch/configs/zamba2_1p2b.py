"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block every 6
layers [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=32000,
        ssm=SSMConfig(state_dim=64, expand=2, head_dim=64, chunk_size=256),
        attn_period=6,            # every 6th block: shared attention+MLP
        subquadratic=True,        # decode state is O(1)/token except periodic attn
    )
