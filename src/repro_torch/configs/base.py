"""Model configuration: one frozen dataclass per backbone.

A copy of ``repro.configs.base`` (the port imports nothing of the JAX
package). Only the fields and helpers the ported slices read are kept:
``ModelConfig`` with its derived dimensions, the hybrid pattern
(``is_attn_layer``/``is_moe_layer``), the MoE dispatch mode, the
cross-entropy mode, the MoE batch pin ``act_shard_axes``,
``with_``/``reduced`` and ``get_config``, which loads
``repro_torch.configs.<arch>``; the dry runs' ``ShapeConfig`` and
``INPUT_SHAPES``; and the strict dict -> dataclass converter
``config_from_dict``.

The port adds fields of its own (no position embedding, a softmax
scale, the muP multipliers, a shared expert, the gated norm's order),
each with a default under which a config computes what the reference's
does. ``ARCH_IDS`` are the reference's eleven archs; ``PORT_ARCH_IDS``
are the configs only the port has.
"""
from __future__ import annotations

import dataclasses
import importlib
import typing
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2
    shared_ff: int = 0        # a shared expert's width, beside the routed ones; 0 = none


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD (arXiv:2405.21060) minimal settings."""
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    gate_first: bool = False  # gated norm rms(y * silu(z)) (published Mamba-2);
    #                           False: rms(y) * silu(z), the reference's order


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    source: str = ""          # citation for the assigned config
    arch_type: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0         # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    act: str = "silu"         # silu (SwiGLU) | gelu (GeGLU)
    glu: bool = True
    rope_theta: float = 10000.0
    sliding_window: int = 0   # 0 -> full attention
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0  # grok/gemma2-style tanh softcap, 0 = off
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0
    moe_every: int = 0
    encoder_layers: int = 0
    encoder_seq: int = 0
    prefix_tokens: int = 0
    dtype: str = "bfloat16"
    objective: str = "diffusion"  # diffusion (paper-native) | ar
    time_emb_dim: int = 256
    moe_dispatch: str = "einsum"  # einsum (GShard one-hot) | gather (slot table)
    ce_mode: str = "gather"       # gather (log_softmax + gather) | onehot
    #                               (logsumexp - one-hot contraction)
    act_shard_axes: Optional[tuple] = None  # mesh axes the MoE activation's
    #                               batch dim is pinned to under a mesh; None
    #                               = the batch's own layout (baseline)
    pos_embedding: str = "rope"   # rope | none (NoPE: attention sees no positions)
    attn_scale: float = 0.0       # softmax scale; 0 -> 1 / sqrt(head_dim)
    embedding_multiplier: float = 1.0  # muP: the input stream is embeds x this
    residual_multiplier: float = 1.0   # muP: each branch adds this x its output
    logits_scaling: float = 1.0        # muP: the vocabulary logits are divided by this

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    def is_attn_layer(self, i: int) -> bool:
        if self.arch_type == "ssm":
            return False
        if self.arch_type == "hybrid":
            # jamba: 1 attention layer per attn_every (index 4 of each 8-block)
            return (i % self.attn_every) == (self.attn_every // 2)
        return True

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        if self.moe_every and self.moe_every > 1:
            return (i % self.moe_every) == 1
        return True

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family (<=2 layers, d_model<=256,
        float32), identical to ``repro.configs.base.ModelConfig.reduced``."""
        kw: dict[str, Any] = dict(
            n_layers=min(self.n_layers, 2 if self.arch_type != "hybrid" else self.attn_every),
            d_model=min(self.d_model, 256),
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32),
            prefix_tokens=min(self.prefix_tokens, 8),
            dtype="float32",
        )
        hd = 32
        n_heads = max(2, min(self.n_heads, 4))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        kw.update(n_heads=n_heads, n_kv_heads=n_kv, head_dim=hd)
        if self.sliding_window:
            kw["sliding_window"] = 16
        if self.moe is not None:
            e = min(self.moe.num_experts, 4)
            kw["moe"] = dataclasses.replace(self.moe, num_experts=e,
                                            top_k=min(self.moe.top_k, e),
                                            shared_ff=min(self.moe.shared_ff, 512))
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, state_dim=16, head_dim=16, chunk_size=16)
        return self.with_(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) workload of the dry runs."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | deis


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
    # one DEIS NFE in embedding space: the paper's own sampling workload
    "deis_4k": ShapeConfig("deis_4k", 4096, 256, "deis"),
}

ARCH_IDS = [
    "whisper_tiny", "h2o_danube_3_4b", "paligemma_3b", "mixtral_8x7b",
    "grok_1_314b", "mamba2_2p7b", "glm4_9b", "gemma_2b", "granite_3_8b",
    "jamba_1p5_large", "cifar10_scorenet",
]
# configs the port has and the reference does not (they set the port's own fields)
PORT_ARCH_IDS = ["granite_4p0_h_small"]


def get_config(arch: str, **overrides) -> ModelConfig:
    """Load ``repro_torch.configs.<arch>`` and apply overrides."""
    arch = arch.replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    cfg: ModelConfig = mod.get_config()
    if overrides:
        cfg = cfg.with_(**overrides)
    return cfg


def _strict_from_dict(cls, data: dict):
    """Strict dict -> dataclass: unknown keys raise, nested dataclasses recurse,
    lists destined for tuple fields are converted, obvious type mismatches raise."""
    if not isinstance(data, dict):
        raise TypeError(f"expected dict for {cls.__name__}, got {type(data).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"unknown keys {sorted(unknown)} for {cls.__name__}")
    hints = typing.get_type_hints(cls)
    kwargs: dict[str, Any] = {}
    for name, val in data.items():
        tp = hints[name]
        if typing.get_origin(tp) is typing.Union:  # Optional[X]
            non_none = [a for a in typing.get_args(tp) if a is not type(None)]
            if val is None:
                kwargs[name] = None
                continue
            tp = non_none[0]
        if dataclasses.is_dataclass(tp):
            kwargs[name] = _strict_from_dict(tp, val)
        elif tp is tuple or typing.get_origin(tp) is tuple:
            if not isinstance(val, (list, tuple)):
                raise TypeError(f"{cls.__name__}.{name}: expected list/tuple, "
                                f"got {type(val).__name__}")
            kwargs[name] = tuple(val)
        elif tp is float and isinstance(val, (int, float)) and not isinstance(val, bool):
            kwargs[name] = float(val)
        elif isinstance(tp, type) and not isinstance(val, tp):
            raise TypeError(f"{cls.__name__}.{name}: expected {tp.__name__}, "
                            f"got {type(val).__name__}")
        else:
            kwargs[name] = val
    return cls(**kwargs)


def config_from_dict(d: dict) -> ModelConfig:
    return _strict_from_dict(ModelConfig, d)
