"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552, RoPE. [hf:THUDM/glm-4-9b]"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", source="hf:THUDM/glm-4-9b", arch_type="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
        d_ff=13696, vocab_size=151552, act="silu", glu=True,
        rope_theta=10000.0,
    )
