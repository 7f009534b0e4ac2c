"""Paper-native config: a small transformer score network over flattened
image patches, used by the faithful-reproduction experiments (the paper's own
UNet checkpoints are unavailable offline). Diffusion objective,
bidirectional."""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="cifar10-scorenet", source="DEIS paper (ICLR 2023)",
        arch_type="dense",
        n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=1024, vocab_size=256, act="gelu", glu=True,
        objective="diffusion", dtype="float32",
    )
