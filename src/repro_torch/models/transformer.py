"""Backbone assembly for the dense and ssm archs: init + forward.

The counterpart of ``repro.models.transformer`` for ``arch_type`` "dense"
(attention + MLP layers) and "ssm" (Mamba2 mixer layers, no MLP) in
``mode="train"`` (full sequence, no KV cache). The reference stacks the
layers' parameters on a leading ``n_blocks`` axis and scans over them; here
``params["blocks"]`` is a list of per-layer dicts (the reference's ``slot0``
subtree of each block) and a Python loop walks it. ``use_kernels`` sends
attention to kernel K2 and the Mamba2 scan to kernel K3 (the reference's
``use_pallas``).

Objectives: ``diffusion`` (bidirectional, time-conditioned denoiser -- the
paper's eps_theta; see :mod:`repro_torch.diffusion.lm`) and ``ar``.
:func:`forward` computes the ``eps`` head for diffusion callers and the
vocabulary logits only when asked: eager PyTorch would otherwise spend a
``(B, S, vocab)`` float32 product on every network evaluation that the
sampler never reads.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import layers as L
from . import ssm as S

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(cfg: ModelConfig):
    return _DTYPES[cfg.dtype]


def _check_arch(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ("dense", "ssm"):
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} is not ported yet (dense and ssm only)")


def init_params(cfg: ModelConfig, generator=0, device=None) -> dict:
    """Random parameters with the reference's shapes and scales
    (``repro.models.transformer.init_params`` and the layer initialisers).

    ``generator`` is an int seed or a ``torch.Generator`` on ``device``;
    ``device=None`` means CUDA. The values differ from the reference's
    (threefry and torch draw different numbers); use
    :func:`repro_torch.models.convert.params_from_numpy` to carry the
    reference's own weights over."""
    _check_arch(cfg)
    device = resolve_device(device)
    gen = generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(generator))
    dtype = _dtype(cfg)
    n = lambda shape: torch.randn(shape, generator=gen, device=device)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    d = cfg.d_model
    blocks = []
    for _ in range(cfg.n_layers):
        if cfg.arch_type == "ssm":      # mamba2 layers have no separate MLP
            blocks.append({"norm1": zeros(d),
                           "ssm": S.init_ssm(gen, cfg, dtype, device)})
            continue
        blocks.append({"norm1": zeros(d),
                       "attn": L.init_attention(gen, cfg, dtype, device),
                       "norm2": zeros(d),
                       "mlp": L.init_mlp(gen, cfg, dtype, device)})
    p: dict[str, Any] = {
        "embed": (n((cfg.vocab_size, d)) * 0.02).to(dtype),
        "blocks": blocks,
        "final_norm": zeros(d),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = (n((d, cfg.vocab_size)) * 0.02).to(dtype)
    if cfg.objective == "diffusion":
        te = cfg.time_emb_dim
        p["time_mlp"] = {"w1": (n((te, d)) * 0.02).to(dtype), "b1": zeros(d),
                         "w2": (n((d, d)) * 0.02).to(dtype), "b2": zeros(d)}
        p["eps_head"] = (n((d, d)) * 0.02).to(dtype)
    return p


def _time_mlp(tm, te):
    """``silu(te @ w1 + b1) @ w2 + b2`` with the silu in float32.

    The products run on at least two rows: BLAS takes a one-row product
    down its matrix-vector path, whose summation order differs from the
    matrix-matrix path, and a request's time embedding (hence its whole
    sample) would then depend on whether it was served alone."""
    n = te.shape[0]
    if n == 1:
        te = te.expand(2, -1)
    te = F.silu((te @ tm["w1"] + tm["b1"]).to(torch.float32)).to(te.dtype)
    return (te @ tm["w2"] + tm["b2"])[:n]


def forward(params, cfg: ModelConfig, *, embeds, t_cond=None,
            causal: Optional[bool] = None, valid_len=None,
            logits: bool = True, use_kernels: bool = False) -> dict:
    """Full-sequence forward over continuous inputs. Returns a dict with
    ``hidden``, ``eps`` (diffusion objective) and ``logits`` (float32, only
    when ``logits=True``).

    embeds: (B, S, d_model); t_cond: scalar or (B,) diffusion time;
    valid_len: optional (B,) per-row true length for bucket-padded batches
    (padded tail keys are masked out); use_kernels: attention through K2
    (which refuses ``valid_len``) and the Mamba2 scan through K3."""
    _check_arch(cfg)
    dtype = _dtype(cfg)
    if causal is None:
        causal = cfg.objective != "diffusion"
    h = embeds.to(dtype)
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device)[None].expand(b, s)

    if t_cond is not None:
        te = _time_mlp(params["time_mlp"], L.sinusoidal_embedding(
            t_cond, cfg.time_emb_dim).to(dtype))
        h = h + te[:, None, :]     # (B or 1, 1, d_model) broadcasts over rows

    for bp in params["blocks"]:
        hn = L.rms_norm(h, bp["norm1"], cfg.norm_eps)
        if "ssm" in bp:
            h = h + S.ssm_forward(bp["ssm"], cfg, hn, use_kernels=use_kernels)[0]
            continue
        h = h + L.attention(bp["attn"], cfg, hn, positions, causal=causal,
                            valid_len=valid_len, use_kernels=use_kernels)
        hn = L.rms_norm(h, bp["norm2"], cfg.norm_eps)
        h = h + L.mlp(bp["mlp"], cfg, hn)

    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    out = {"hidden": h}
    if cfg.objective == "diffusion":
        out["eps"] = L.matmul(h, params["eps_head"])
    if logits:
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        lg = h.to(torch.float32) @ head.to(torch.float32)
        if cfg.logit_softcap:
            lg = cfg.logit_softcap * torch.tanh(lg / cfg.logit_softcap)
        out["logits"] = lg
    return out
