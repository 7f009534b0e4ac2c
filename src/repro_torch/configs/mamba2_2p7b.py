"""mamba2-2.7b [ssm] — 64L d_model=2560, attention-free SSD (state-space
duality), ssm_state=128, vocab=50280. [arXiv:2405.21060]"""
from .base import ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", source="arXiv:2405.21060", arch_type="ssm",
        n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab_size=50280,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                      chunk_size=256),
    )
