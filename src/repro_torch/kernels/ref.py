"""Plain PyTorch versions of the port's kernels: the ground truth the
kernels are held to, and what the wrappers run on CPU tensors.

Each follows the arithmetic of its JAX counterpart in ``repro.kernels``
(the Pallas kernel body, not only its oracle): the same accumulation dtype
and the same order of operations.
"""
from __future__ import annotations

import torch


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
