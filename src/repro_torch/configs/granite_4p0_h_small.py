"""granite-4.0-h-small [hybrid] — 40L d_model=4096: 36 Mamba-2 (SSD) mixers
of 128 heads x 64, state 128, gated norm gate-first, and 4 NoPE GQA
attention layers (32 query heads, 8 KV heads of 128) in slot 5 of each
10-layer period; every feed-forward a MoE of 72 experts of width 768, top
10, with a shared expert of width 1536; muP multipliers (embedding 12,
attention 1/128, residual 0.22, logits / 16); vocab=100352, tied.
[https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json]"""
from .base import ModelConfig, MoEConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="granite-4.0-h-small",
        source="https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json",
        arch_type="hybrid", n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, d_ff=768, vocab_size=100352, act="silu", glu=True,
        norm_eps=1e-5, tie_embeddings=True, attn_every=10, moe_every=0,
        moe=MoEConfig(num_experts=72, top_k=10, capacity_factor=1.25, shared_ff=1536),
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk_size=256,
                      gate_first=True),
        moe_dispatch="einsum", pos_embedding="none", attn_scale=0.0078125,
        embedding_multiplier=12.0, residual_multiplier=0.22, logits_scaling=16.0,
    )
