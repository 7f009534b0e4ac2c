"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155. [hf:ibm-granite/granite-3.0-2b-base]"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b", source="hf:ibm-granite/granite-3.0-2b-base",
        arch_type="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=12800, vocab_size=49155, act="silu", glu=True,
    )
