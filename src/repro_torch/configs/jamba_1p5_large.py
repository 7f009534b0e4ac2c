"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, Mamba:attention 7:1 interleave (1 attn layer per
8-layer block), MoE 16 experts top-2 on alternating layers.
[arXiv:2403.19887]"""
from .base import ModelConfig, MoEConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large", source="arXiv:2403.19887", arch_type="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab_size=65536, act="silu", glu=True,
        attn_every=8, moe_every=2,
        moe=MoEConfig(num_experts=16, top_k=2),
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                      chunk_size=256),
    )
