"""Public wrappers for the port's kernels (``repro.kernels.ops``'s
counterpart). Each takes CUDA tensors to its hand-written kernel and CPU
tensors to its plain version (:mod:`repro_torch.kernels.runtime`)."""
from __future__ import annotations

from .deis_step import deis_step as _deis_step
from .deis_step import fused_ab_step as _fused_ab_step
from .flash_attention import flash_attention as _flash_attention
from .ssm_pointwise import conv_prep as _conv_prep
from .ssm_pointwise import gated_norm as _gated_norm
from .ssd_scan import ssd_scan as _ssd_scan


def deis_step(x, eps_hist, psi, coeffs):
    return _deis_step(x, eps_hist, psi, coeffs)


def fused_ab_step(x, hist, psi, coeffs, *, s=None, noise=None,
                  err_coeffs=None):
    # stacked serving entry: per-row [psi, C, s?, E?] + optional noise/err
    return _fused_ab_step(x, hist, psi, coeffs, s=s, noise=noise,
                          err_coeffs=err_coeffs)


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    # scale: the logits' factor, None for 1/sqrt(head_dim)
    return _flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def ssd_scan(x, a, B, C, *, chunk=128):
    return _ssd_scan(x, a, B, C, chunk=chunk)


def ssm_conv_prep(xbc, dt, conv_w, conv_b, dt_bias, A_log, *, head_dim):
    # the SSM mixer's `pre`: K3's operands (xh, B, C, a) in one pass
    return _conv_prep(xbc, dt, conv_w, conv_b, dt_bias, A_log, head_dim=head_dim)


def ssm_gated_norm(y, xh, z, D, norm_scale, *, eps, gate_first=False):
    # the SSM mixer's `post`: the D skip, the gated RMS norm, the gate
    # (gate_first: the gate before the norm)
    return _gated_norm(y, xh, z, D, norm_scale, eps=eps, gate_first=gate_first)
