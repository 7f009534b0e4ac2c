"""Public wrappers for the port's kernels (``repro.kernels.ops``'s
counterpart). Each takes CUDA tensors to its hand-written kernel and CPU
tensors to its plain version (:mod:`repro_torch.kernels.runtime`)."""
from __future__ import annotations

from .deis_step import deis_step as _deis_step
from .deis_step import fused_ab_step as _fused_ab_step


def deis_step(x, eps_hist, psi, coeffs):
    return _deis_step(x, eps_hist, psi, coeffs)


def fused_ab_step(x, hist, psi, coeffs, *, s=None, noise=None,
                  err_coeffs=None):
    # stacked serving entry: per-row [psi, C, s?, E?] + optional noise/err
    return _fused_ab_step(x, hist, psi, coeffs, s=s, noise=noise,
                          err_coeffs=err_coeffs)
