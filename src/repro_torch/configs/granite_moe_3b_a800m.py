"""granite-moe-3b-a800m [moe] — 40 experts top-8, tiny expert FFN
[hf:ibm-granite/granite-3.0 family]."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        rope_theta=1e4,
        moe=MoEConfig(
            num_experts=40,
            experts_per_token=8,
            expert_d_ff=512,
        ),
    )
