"""Mamba2 / SSD mixer (arXiv:2405.21060) for the ssm archs.

The counterpart of ``repro.models.ssm``: the in-projection, the depthwise
causal convolution, the SSD chunked scan and the gated RMS norm. State-space
duality with one scalar decay per head::

    h_t = a_t h_{t-1} + B_t x_t^T      (per head: h in R^{P x N})
    y_t = C_t h_t

:func:`ssd_chunked` is the reference's plain chunked form; with
``use_kernels=True`` :func:`ssm_forward` calls kernel K3
(:func:`repro_torch.kernels.ops.ssd_scan`) instead, as the reference's
``use_pallas`` does, and the pointwise work around it in two one-pass
kernels (:mod:`repro_torch.kernels.ssm_pointwise`), where XLA fuses it for
the reference. Autoregressive decode carries a cache of the conv
history and the state and takes the O(1) recurrent update per token.

Under a mesh (the sharded train step, parameters placed by
:func:`repro_torch.sharding.tensor_parallel.place`) ``in_proj`` is split
over 'model' on its output and ``out_proj`` on its input, ``conv_w`` /
``conv_b`` on their channels. The in-projection's blocks cut across its
``[z, xBC, dt]`` parts, so its output is gathered; the convolution runs on
this rank's channels and is gathered again; the scan and the gated norm
run whole on every model rank, and ``out_proj`` takes its block of y. A
decode cache on a mesh holds this rank's conv channels and the whole
state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from ..kernels import ssm_pointwise as SP
from ..obs.trace import NULL_TRACER
from ..sharding import tensor_parallel as TP


def ssm_dims(cfg: ModelConfig):
    """``(d_inner, n_heads)`` of the mixer."""
    d_inner = cfg.ssm.expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm.head_dim


def init_ssm(gen, cfg: ModelConfig, dtype, device):
    """Random mixer parameters with the reference's shapes and scales."""
    d = cfg.d_model
    d_inner, n_heads = ssm_dims(cfg)
    n = cfg.ssm.state_dim
    s = 1.0 / math.sqrt(d)
    f32 = torch.float32
    rand = lambda shape: torch.randn(shape, generator=gen, device=device)
    # in_proj produces [z (gate), x, B, C, dt] along features
    proj_out = 2 * d_inner + 2 * n + n_heads
    return {
        "in_proj": (rand((d, proj_out)) * s).to(dtype),
        "conv_w": (rand((cfg.ssm.conv_width, d_inner + 2 * n)) * 0.1).to(dtype),
        "conv_b": torch.zeros((d_inner + 2 * n,), dtype=dtype, device=device),
        "A_log": torch.zeros((n_heads,), dtype=f32, device=device),   # A = -exp(A_log)
        "dt_bias": torch.full((n_heads,), math.log(math.e - 1), dtype=f32, device=device),
        "D": torch.ones((n_heads,), dtype=f32, device=device),
        "norm_scale": torch.zeros((d_inner,), dtype=dtype, device=device),
        "out_proj": (rand((d_inner, d)) * s / math.sqrt(2 * cfg.n_layers)).to(dtype),
    }


def _split_proj(cfg: ModelConfig, zxbcdt):
    d_inner, n_heads = ssm_dims(cfg)
    n = cfg.ssm.state_dim
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * n, n_heads], dim=-1)


def ssd_chunked(x, a, B, C, chunk: int):
    """The SSD chunked scan in plain tensor operations (the reference's
    ``ssd_chunked``: no clamp before the log, float32 products).

    x: (B, S, H, P); a: (B, S, H) per-step decay in (0, 1); B, C: (B, S, N)
    shared across heads. Returns y (B, S, H, P) float32 and the final state
    (B, H, P, N) float32.
    """
    bsz, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        # pad to a chunk multiple with identity steps (a = 1, x = 0) at the end
        pad = chunk - s % chunk
        y, final = ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)),
                               F.pad(a, (0, 0, 0, pad), value=1.0),
                               F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)),
                               chunk)
        return y[:, :s], final
    f32 = torch.float32
    nc = s // chunk
    xr = x.reshape(bsz, nc, chunk, h, p).to(f32)
    ar = a.reshape(bsz, nc, chunk, h)
    Br = B.reshape(bsz, nc, chunk, n).to(f32)
    Cr = C.reshape(bsz, nc, chunk, n).to(f32)

    cum = torch.cumsum(torch.log(ar.to(f32)), dim=2)        # (B, nc, L, H) inclusive
    # within chunk: y_intra[t] = sum_{u<=t} C_t . B_u exp(cum_t - cum_u) x_u
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B, nc, T, U, H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    decay = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    scores = torch.einsum("bctn,bcun->bctu", Cr, Br)
    w = scores[..., None] * decay
    y_intra = torch.einsum("bctuh,bcuhp->bcthp", w, xr)

    # chunk summaries: S_c = sum_u exp(cum_last - cum_u) B_u x_u^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)       # (B, nc, L, H)
    chunk_state = torch.einsum("bcuh,bcun,bcuhp->bchpn", decay_to_end, Br, xr)
    a_chunk = torch.exp(cum[:, :, -1, :])                   # (B, nc, H)

    # recurrence across chunks; prev[c] is the state entering chunk c
    state = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * a_chunk[:, c, :, None, None] + chunk_state[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (B, nc, H, P, N)

    # inter-chunk: y_inter[t] = C_t . (exp(cum_t) S_{c-1})
    y_inter = torch.einsum("bctn,bcth,bchpn->bcthp", Cr, torch.exp(cum), prev_states)
    return (y_intra + y_inter).reshape(bsz, s, h, p), state


def ssm_forward(params, cfg: ModelConfig, x, *, cache=None, use_kernels: bool = False,
                tracer=NULL_TRACER):
    """The full Mamba2 mixer. x: (B, S, D).

    cache: None (a full sequence: training, prefill, the eps-net) or
    ``{"conv": (B, K-1, C), "state": (B, H, P, N)}`` for the O(1) decode
    update (S must be 1): ``state = state * a + B x^T``, ``y = C state`` in
    float32. ``use_kernels`` routes a full sequence's scan through kernel
    K3 (the reference's ``use_pallas``) and its pointwise work through
    :func:`~repro_torch.kernels.ops.ssm_conv_prep` and
    :func:`~repro_torch.kernels.ops.ssm_gated_norm`; otherwise
    :func:`ssd_chunked` and the plain pieces of
    :mod:`~repro_torch.kernels.ssm_pointwise` run it. Returns ``(out,
    {"conv", "state"})`` like the reference.

    ``tracer``: five spans in turn, ``in_proj``; ``pre`` (the decay, the
    causal convolution, the split into K3's operands: one kernel on the
    kernel route); ``scan`` (K3, :func:`ssd_chunked` or the decode update
    alone); ``post`` (the D skip, the gated RMS norm, the cast: one kernel
    on the kernel route; the gate before the norm where ``cfg.ssm.gate_first``
    says so); ``out_proj``."""
    bsz, s, _ = x.shape
    scfg = cfg.ssm
    d_inner, n_heads = ssm_dims(cfg)
    n, p = scfg.state_dim, scfg.head_dim
    f32 = torch.float32

    with tracer.span("in_proj"):
        zxbcdt, split = TP.linear(x, params["in_proj"])
        z, xbc, dt = _split_proj(cfg, TP.whole(zxbcdt, split, params["in_proj"]))
    kernels = use_kernels and cache is None      # K3 and the two passes around it
    with tracer.span("pre"):
        conv = TP.split_of(params["conv_w"])
        if conv is not None and use_kernels:
            raise ValueError("the mixer on a mesh runs on the plain route: no kernel")
        if kernels:
            xh, B, C, a = ops.ssm_conv_prep(xbc, dt, params["conv_w"], params["conv_b"],
                                            params["dt_bias"], params["A_log"], head_dim=p)
            conv_state = SP.conv_tail(xbc, params["conv_w"].shape[0])
        else:
            a = SP.decay(dt, params["dt_bias"], params["A_log"])
            channels = conv is not None and conv.dim is not None
            if channels:
                xbc = TP.split_model(xbc, -1, conv.ax)
            xbc, conv_state = SP.causal_conv(xbc, params["conv_w"], params["conv_b"],
                                             state=None if cache is None else cache["conv"])
            if channels:
                xbc = TP.gather_model(xbc, -1, conv.ax)
            xs, B, C = torch.split(xbc, [d_inner, n, n], dim=-1)
            xh = xs.reshape(bsz, s, n_heads, p)
    with tracer.span("scan"):
        if cache is not None:
            if s != 1:
                raise ValueError(f"the SSM decode cache takes one token at a time, got {s}")
            st = cache["state"] * a[:, 0, :, None, None] + torch.einsum(
                "bn,bhp->bhpn", B[:, 0].to(f32), xh[:, 0].to(f32))
            y = torch.einsum("bn,bhpn->bhp", C[:, 0].to(f32), st)[:, None]
            state = st
        else:
            chunk = min(scfg.chunk_size, s)
            if kernels:
                y, state = ops.ssd_scan(xh, a, B, C, chunk=chunk)
            else:
                y, state = ssd_chunked(xh, a, B, C, chunk=chunk)

    with tracer.span("post"):
        if kernels:
            y = ops.ssm_gated_norm(y, xh, z, params["D"], params["norm_scale"],
                                   eps=cfg.norm_eps, gate_first=scfg.gate_first)
        else:
            y = SP.gated_norm_ref(y, xh, z, params["D"], params["norm_scale"], cfg.norm_eps,
                                  scfg.gate_first)
    with tracer.span("out_proj"):
        out, _ = TP.linear(y, params["out_proj"])
    return out, {"conv": conv_state, "state": state}
