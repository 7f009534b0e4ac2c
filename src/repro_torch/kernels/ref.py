"""Plain PyTorch versions of the port's kernels: the ground truth the
kernels are held to, and what the wrappers run on CPU tensors.

Each follows the arithmetic of its JAX counterpart in ``repro.kernels``
(the Pallas kernel body, not only its oracle): the same accumulation dtype
and the same order of operations.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30

# The tolerances at which the card's K2 and K3 are held to these versions
# (chip_smoke.py, tools/kernel_stress.py; the card tests use the same
# figures): K2's are the JAX kernel tests' _tol, K3's the JAX ssd_scan
# test's; K3 in float32 at full width takes atol K3_F32_SCALE * max|want|.
K2_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
K3_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
K3_F32_SCALE = 1e-5


def fused_ab_step_ref(x, hist, psi, coeffs, *, s=None, noise=None,
                      err_coeffs=None):
    """Stacked AB step, the full signature of
    ``repro.kernels.deis_step.fused_ab_step``.

    x: (R, M, D); hist: (r, R, M, D); psi: (R,); coeffs: (R, r); optional
    s: (R,) with noise: (R, M, D); optional err_coeffs: (R, r). Per row,
    in float32 and in this order::

        acc = psi*x + C_0*h_0 + ... + C_{r-1}*h_{r-1} (+ s*noise)
        err = max |E_0*h_0 + ... + E_{r-1}*h_{r-1}|

    ``acc`` is returned in ``x.dtype``, ``err`` as (R,) float32 (or None).
    """
    f32 = torch.float32
    col = lambda v: v.to(f32)[:, None, None]
    acc = col(psi) * x.to(f32)
    for j in range(hist.shape[0]):
        acc = acc + col(coeffs[:, j]) * hist[j].to(f32)
    if noise is not None:
        acc = acc + col(s) * noise.to(f32)
    err = None
    if err_coeffs is not None:
        e = col(err_coeffs[:, 0]) * hist[0].to(f32)
        for j in range(1, hist.shape[0]):
            e = e + col(err_coeffs[:, j]) * hist[j].to(f32)
        err = e.abs().amax(dim=(1, 2))
    return acc.to(x.dtype), err


def deis_step_ref(x, eps_hist, psi, coeffs):
    """x' = psi * x + sum_j coeffs[j] * eps_hist[j], accumulated in float32.

    x: (M, D); eps_hist: (r, M, D); psi scalar; coeffs (r,)."""
    f32 = torch.float32
    comb = torch.tensordot(coeffs.to(f32), eps_hist.to(f32), dims=1)
    return (psi.to(f32) * x.to(f32) + comb).to(x.dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """Attention in the arithmetic of the Pallas body
    (``repro.kernels.flash_attention._kernel``), in one block.

    q: (B, Sq, H, D); k, v: (B, Sk, KV, D) with H % KV == 0, any float
    dtype. Query head h reads KV head ``h // (H // KV)``. Float32 logits
    times ``scale`` (None: ``1/sqrt(D)``); query positions offset by
    ``Sk - Sq``; causal and window masks set to -1e30 (no key is padded here, so the kernel's
    padding mask has nothing to mask); probabilities ``exp(s - max)`` in
    float32 (0 where masked) into a float32 PV product, divided by
    ``max(l, 1e-30)``. Returns (B, Sq, H, D) in q's dtype.
    """
    f32 = torch.float32
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    head = torch.arange(h, device=q.device) // (h // kv)
    kf = k.to(f32).index_select(2, head)
    vf = v.to(f32).index_select(2, head)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), kf) * (
        1.0 / math.sqrt(d) if scale is None else scale)
    qp = (sk - sq) + torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1).clamp_min(1e-30)                       # (B, H, Sq)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ssd_scan_ref(x, a, B, C, *, chunk=128):
    """The Mamba2 SSD chunked scan in the arithmetic of the Pallas body
    (``repro.kernels.ssd_scan._kernel``), chunk by chunk.

    x: (Bb, S, H, P); a: (Bb, S, H); B, C: (Bb, S, N), shared by the heads.
    The chunk is ``min(chunk, S)``; S is padded to a multiple of it with
    a = 1 and x = B = C = 0. Per chunk, in float32::

        cum   = cumsum(log(max(a, 1e-37)))
        y     = (C B^T o tril exp(cum_t - cum_u)) x + (C o exp(cum)) h^T
        h     = h exp(cum_L) + x^T (B o exp(cum_L - cum))

    Returns y (Bb, S, H, P) in x's dtype and the final state (Bb, H, P, N)
    in float32.
    """
    f32 = torch.float32
    bb, s, h, p = x.shape
    n = B.shape[-1]
    L = min(chunk, s)
    pad = (-s) % L
    xf = F.pad(x.to(f32), (0, 0, 0, 0, 0, pad))
    af = F.pad(a.to(f32), (0, 0, 0, pad), value=1.0)
    Bf = F.pad(B.to(f32), (0, 0, 0, pad))
    Cf = F.pad(C.to(f32), (0, 0, 0, pad))
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    state = torch.zeros((bb, h, p, n), dtype=f32, device=x.device)
    ys = []
    for c0 in range(0, s + pad, L):
        xc, Bc, Cc = xf[:, c0:c0 + L], Bf[:, c0:c0 + L], Cf[:, c0:c0 + L]
        cum = torch.cumsum(torch.log(af[:, c0:c0 + L].clamp_min(1e-37)), dim=1)
        seg = cum[:, :, None, :] - cum[:, None, :, :]              # (Bb, t, u, H)
        decay = torch.where(tri[None, :, :, None], torch.exp(seg), 0.0)
        w = torch.einsum("btn,bun->btu", Cc, Bc)[..., None] * decay
        y = torch.einsum("btuh,buhp->bthp", w, xc)
        c_in = Cc[:, :, None, :] * torch.exp(cum)[..., None]       # (Bb, L, H, N)
        y = y + torch.einsum("bthn,bhpn->bthp", c_in, state)
        b_out = Bc[:, :, None, :] * torch.exp(cum[:, -1:] - cum)[..., None]
        state = state * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "buhp,buhn->bhpn", xc, b_out)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s].to(x.dtype), state
