"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, 8 experts top-2, sliding-window attention. [arXiv:2401.04088]"""
from .base import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", source="arXiv:2401.04088", arch_type="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=32000, act="silu", glu=True,
        sliding_window=4096,
        moe=MoEConfig(num_experts=8, top_k=2),
    )
