"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, 8 experts top-2, logit softcapping. [hf:xai-org/grok-1]"""
from .base import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", source="hf:xai-org/grok-1", arch_type="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=32768, vocab_size=131072, act="gelu", glu=True,
        logit_softcap=30.0,
        moe=MoEConfig(num_experts=8, top_k=2),
    )
