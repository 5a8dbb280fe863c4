"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (7:1), no separate FFN (d_ff=0)
[arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        head_dim=512,
        d_ff=0,                   # per assignment: block-internal expansion only
        vocab_size=50304,
        xlstm=XLSTMConfig(slstm_period=8, chunk_size=256),
        subquadratic=True,
    )
