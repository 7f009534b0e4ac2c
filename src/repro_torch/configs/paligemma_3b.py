"""paligemma-3b [vlm] — gemma-2b-style decoder: 18L d_model=2048 8H (GQA kv=1,
MQA) d_ff=16384 vocab=257216, head_dim=256; SigLIP vision encoder stubbed as a
256-token patch-embedding prefix. [arXiv:2407.07726]"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", source="arXiv:2407.07726", arch_type="vlm",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, vocab_size=257216, act="gelu", glu=True,
        prefix_tokens=256, tie_embeddings=True,
    )
