"""whisper-tiny [audio enc-dec] — 4L decoder (+4L encoder) d_model=384 6H
(GQA kv=6) d_ff=1536 vocab=51865, conv frontend stubbed as precomputed frame
embeddings (1500 frames). [arXiv:2212.04356]"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", source="arXiv:2212.04356", arch_type="encdec",
        n_layers=4, encoder_layers=4, encoder_seq=1500,
        d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
        d_ff=1536, vocab_size=51865, act="gelu", glu=False,
    )
