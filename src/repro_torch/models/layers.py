"""Backbone building blocks for the dense archs: norms, RoPE, attention
(GQA/MQA, sliding window, per-row key masking, logit softcap, the KV cache
and its sliding-window ring; kernel K2 on request), GLU MLPs and the
diffusion time embedding.

The counterpart of the dense half of ``repro.models.layers`` (no
cross-attention and no MoE yet). Plain functions over parameter dicts with
the reference's layouts: weights ``(d_in, d_out)`` applied as ``x @ w``,
q/k/v as ``(B, S, H, D)``. Every matmul accumulates in float32 and rounds
once to the input dtype (cuBLAS and the CPU kernels both do so for
bfloat16); the attention logits and softmax stay in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops


def matmul(x, w):
    """``x @ w``: float32 accumulation, one rounding to ``x.dtype``."""
    return x @ w


def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm in float32 scaled by ``(1 + scale)``, cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.to(torch.float32))).to(x.dtype)


def sinusoidal_embedding(t, dim: int, max_period: float = 10_000.0):
    """Timestep embedding for diffusion conditioning (t scalar or (B,)):
    ``[cos(1000 t f), sin(1000 t f)]`` over geometric frequencies f."""
    t = torch.atleast_1d(t)
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].to(torch.float32) * freqs[None, :] * 1000.0
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# --------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, positions, theta: float):
    """positions: (..., S) int -> cos/sin of shape (..., S, head_dim//2)."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D). Rotates the split halves (x1, x2), not interleaved
    pairs, in float32."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention
def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def attention_scores(q, k, v, mask, softcap: float = 0.0):
    """q: (B,Sq,H,D), k/v: (B,Sk,H,D) (already GQA-expanded); mask
    broadcastable to (B, H, Sq, Sk), True = attend. Float32 logits and
    softmax; the probabilities are cast to v's dtype before the PV product."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(d)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def make_attention_mask(q_pos, kv_pos, causal: bool, window: int = 0,
                        kv_valid=None):
    """Boolean mask (B?, 1, Sq, Sk) from position tensors."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                      dtype=torch.bool, device=qp.device)
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    if kv_valid is not None:
        mask = mask & kv_valid[..., None, :]
    return mask[..., None, :, :] if mask.ndim == 2 else mask[:, None]


def init_attention(gen, cfg: ModelConfig, dtype, device):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = 1.0 / math.sqrt(d)
    n = lambda shape: torch.randn(shape, generator=gen, device=device)
    return {
        "wq": (n((d, qd)) * s).to(dtype),
        "wk": (n((d, kvd)) * s).to(dtype),
        "wv": (n((d, kvd)) * s).to(dtype),
        "wo": (n((qd, d)) * s / math.sqrt(2 * cfg.n_layers)).to(dtype),
    }


def _kv_cache_write(buf, new, index: int):
    """Write ``new`` (B, s, KV, D) into ``buf`` (B, S_cache, KV, D) in place at
    sequence position ``index``, clamped so the slice fits (the reference's
    ``dynamic_update_slice``)."""
    i = min(max(int(index), 0), buf.shape[1] - new.shape[1])
    buf[:, i:i + new.shape[1]] = new.to(buf.dtype)
    return buf


def _decode_mask(cfg: ModelConfig, positions, s_cache: int, cache_index: int,
                 device):
    """Mask (B, 1, s, S_cache) of a decode step against the whole cache. A
    sliding-window cache of exactly ``window`` slots is a ring: slot ``j``
    holds position ``cache_index - (cache_index - j) % window`` (valid when
    >= 0). Otherwise the cache is positional: causal, plus the window."""
    slot = torch.arange(s_cache, device=device)
    q = positions[..., :, None][:, None]                   # (B, 1, s, 1)
    if cfg.sliding_window and s_cache == cfg.sliding_window:
        kv_pos = cache_index - torch.remainder(cache_index - slot, s_cache)
        return (kv_pos <= q) & (kv_pos >= 0)
    mask = slot <= q
    if cfg.sliding_window:
        mask = mask & (slot > q - cfg.sliding_window)
    return mask


def attention(params, cfg: ModelConfig, x, positions, *, causal=True,
              cache=None, cache_index=None, return_kv: bool = False,
              valid_len=None, use_kernels=False):
    """Multi-head attention with GQA + RoPE + optional SWA and a KV cache.

    cache: None (a full sequence) or ``{"k", "v"}`` of shape (B, S_cache,
    KV, D): decode writes this step's post-RoPE k and v into it IN PLACE at
    ``cache_index`` (an int; ``cache_index % window`` for a sliding-window
    ring of ``window`` slots) and attends over the whole cache.
    return_kv: prefill -- return the post-RoPE k and v as the cache, in
    ring layout of ``window`` slots when ``sliding_window`` is set and the
    sequence is longer than the window.
    valid_len: optional (B,) int -- per-row true sequence length when rows
    are right-padded to a bucketed S; key positions >= valid_len are masked
    out so a row's content does not depend on the bucket it landed in.
    use_kernels: the scores run through kernel K2
    (:func:`repro_torch.kernels.ops.flash_attention`), which reads the KV
    heads in place. K2 has no padding operand, no softcap and no cache, so
    ``valid_len``, a ``cache`` or a config with ``logit_softcap`` raises
    rather than run the plain route or drop the softcap (the reference's
    ``use_pallas`` takes K2 only with ``valid_len`` and ``cache`` None).
    Returns ``(out, new_cache)``: the block's output (B, S, d_model) and
    the cache (None unless ``cache`` or ``return_kv``).
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = matmul(x, params["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = matmul(x, params["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = matmul(x, params["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    cos, sin = rope_frequencies(hd, positions, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    new_cache = None
    if return_kv and cache is None:
        w = cfg.sliding_window
        if w and s > w:
            slots = torch.arange(s - w, s, device=x.device) % w
            ck = k.new_zeros((b, w) + k.shape[2:])
            cv = v.new_zeros((b, w) + v.shape[2:])
            ck[:, slots] = k[:, s - w:]
            cv[:, slots] = v[:, s - w:]
            new_cache = {"k": ck, "v": cv}
        else:
            new_cache = {"k": k, "v": v}
    if cache is not None:
        s_cache = cache["k"].shape[1]
        ring = bool(cfg.sliding_window) and s_cache == cfg.sliding_window
        write = cache_index % s_cache if ring else cache_index
        k = _kv_cache_write(cache["k"], k, write)
        v = _kv_cache_write(cache["v"], v, write)
        new_cache = {"k": k, "v": v}

    if use_kernels:
        if valid_len is not None or cache is not None:
            raise ValueError("kernel K2 has no per-row key length and no KV "
                             "cache; run valid_len or a cache with "
                             "use_kernels=False")
        if cfg.logit_softcap:
            raise ValueError("kernel K2 has no logit softcap; run "
                             f"{cfg.name} with use_kernels=False")
        out = ops.flash_attention(q, k, v, causal=causal,
                                  window=cfg.sliding_window)
        return matmul(out.reshape(b, s, cfg.q_dim), params["wo"]), new_cache
    n_rep = cfg.n_heads // max(1, k.shape[2])
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    if cache is not None:
        mask = _decode_mask(cfg, positions, k.shape[1], cache_index, x.device)
    else:
        kv_valid = None
        if valid_len is not None:
            kv_valid = torch.arange(s, device=x.device)[None, :] < valid_len[:, None]
        mask = make_attention_mask(positions, positions, causal,
                                   cfg.sliding_window, kv_valid=kv_valid)
    out = attention_scores(q, k, v, mask, cfg.logit_softcap)
    return matmul(out.reshape(b, s, cfg.q_dim), params["wo"]), new_cache


# --------------------------------------------------------------------- MLPs
def init_mlp(gen, cfg: ModelConfig, dtype, device):
    d, f = cfg.d_model, cfg.d_ff
    s = 1.0 / math.sqrt(d)
    n = lambda shape: torch.randn(shape, generator=gen, device=device)
    p = {"w_up": (n((d, f)) * s).to(dtype),
         "w_down": (n((f, d)) * s / math.sqrt(2 * cfg.n_layers)).to(dtype)}
    if cfg.glu:
        p["w_gate"] = (n((d, f)) * s).to(dtype)
    return p


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation; so does the reference
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def mlp(params, cfg: ModelConfig, x):
    up = matmul(x, params["w_up"])
    if cfg.glu:
        up = _act(cfg.act)(matmul(x, params["w_gate"])) * up
    else:
        up = _act(cfg.act)(up)
    return matmul(up, params["w_down"])
