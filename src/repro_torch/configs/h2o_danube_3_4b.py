"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000, llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", source="arXiv:2401.16818", arch_type="dense",
        n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
        d_ff=10240, vocab_size=32000, act="silu", glu=True,
        sliding_window=4096, rope_theta=10000.0,
    )
