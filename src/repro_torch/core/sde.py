"""Forward diffusion SDEs (paper Sec. 2, Tab. 1), as host float64 numpy.

All SDEs here are scalar-coefficient linear diffusions

    dx = f(t) x dt + g(t) dw,          x in R^D,

with Gaussian conditionals  p_{0t}(x_t | x_0) = N(mu(t) x_0, sigma(t)^2 I).
The coefficient engine (``coeffs.py``) only needs mu/sigma/rho, all computed
once on the host in float64 numpy. ``mu`` and ``sigma`` also take a torch
tensor ``t`` and then compute in its dtype on its device (the counterpart of
``repro.core.sde``'s traced-array branch), for the training losses and the
analytic oracles, whose times are per-row tensors.

    rho(t) = sigma(t)/mu(t)                  (the DEIS time rescaling, Prop. 3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch


def _mod(t):
    """torch for a tensor ``t``, numpy otherwise."""
    return torch if isinstance(t, torch.Tensor) else np


def _as_array(t):
    """A tensor as it is; anything else as a float64 numpy array."""
    return t if isinstance(t, torch.Tensor) else np.asarray(t, dtype=np.float64)


class SDE:
    """Scalar-coefficient linear forward SDE."""

    #: sampling integration endpoints (overridable per instance)
    T: float = 1.0
    t0: float = 1e-3

    def mu(self, t):
        """Signal coefficient of p_{0t} (paper's sqrt(alpha_t) for VPSDE)."""
        raise NotImplementedError

    def sigma(self, t):
        """Noise std of p_{0t}."""
        raise NotImplementedError

    def f(self, t):
        """Drift coefficient f(t) = d log mu / dt (numeric default)."""
        return _central_diff(lambda u: np.log(self.mu(u)), t)

    def g2(self, t):
        """g(t)^2 = d sigma^2/dt - 2 f sigma^2 (numeric default)."""
        ds2 = _central_diff(lambda u: self.sigma(u) ** 2, t)
        return ds2 - 2.0 * self.f(t) * self.sigma(t) ** 2

    def psi(self, t, s):
        """Transition 'matrix' Psi(t, s) = mu(t)/mu(s)."""
        return self.mu(t) / self.mu(s)

    def rho(self, t):
        """DEIS rescaled time rho(t) = sigma(t)/mu(t) (Prop. 3)."""
        return self.sigma(t) / self.mu(t)

    def t_of_rho(self, rho):
        """Inverse of rho(t); generic bisection fallback."""
        lo = np.full_like(np.asarray(rho, dtype=np.float64), 0.0)
        hi = np.full_like(lo, self.T)
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            val = self.rho(mid)
            lo = np.where(val < rho, mid, lo)
            hi = np.where(val < rho, hi, mid)
        return 0.5 * (lo + hi)

    def prior_std(self):
        """Std of pi(x_T) used to draw x_T."""
        return math.sqrt(self.mu(self.T) ** 2 + self.sigma(self.T) ** 2)

    def score_from_eps(self, eps, t):
        """score = -L_t^{-T} eps = -eps / sigma(t)."""
        return -eps / self.sigma(t)

    def eps_from_score(self, score, t):
        return -score * self.sigma(t)


def _central_diff(fn: Callable, t, h: float = 1e-5):
    t = np.asarray(t, dtype=np.float64)
    return (fn(t + h) - fn(t - h)) / (2.0 * h)


@dataclasses.dataclass
class VPSDE(SDE):
    """Variance-preserving SDE (Ho et al. 2020; paper Tab. 1).

    log alpha_bar(t) = -0.25 t^2 (beta_max - beta_min) - 0.5 t beta_min
    mu(t) = sqrt(alpha_bar(t)),  sigma(t) = sqrt(1 - alpha_bar(t)).
    """

    beta_min: float = 0.1
    beta_max: float = 20.0
    T: float = 1.0
    t0: float = 1e-3

    def log_alpha_bar(self, t):
        t = _as_array(t)
        return -0.5 * t ** 2 * (self.beta_max - self.beta_min) - t * self.beta_min

    def alpha_bar(self, t):
        return _mod(t).exp(self.log_alpha_bar(t))

    def beta(self, t):
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def mu(self, t):
        return _mod(t).exp(0.5 * self.log_alpha_bar(t))

    def sigma(self, t):
        mod = _mod(t)
        return mod.sqrt(-mod.expm1(self.log_alpha_bar(t)))

    def f(self, t):
        return -0.5 * self.beta(t)

    def g2(self, t):
        return self.beta(t)

    def t_of_rho(self, rho):
        """Closed form: alpha_bar = 1/(1+rho^2) and solve the quadratic in t."""
        rho = np.asarray(rho, dtype=np.float64)
        c = np.log1p(rho ** 2)  # = -log alpha_bar
        a = 0.5 * (self.beta_max - self.beta_min)
        b = self.beta_min
        return (-b + np.sqrt(b ** 2 + 4.0 * a * c)) / (2.0 * a)

    def prior_std(self):
        return 1.0  # mu_T^2 + sigma_T^2 = 1 exactly for VP


@dataclasses.dataclass
class VESDE(SDE):
    """Variance-exploding SDE (Song et al. 2020b; paper Tab. 1).

    mu(t) = 1,  sigma(t) = sigma_min (sigma_max/sigma_min)^t.
    """

    sigma_min: float = 0.02
    sigma_max: float = 100.0
    T: float = 1.0
    t0: float = 1e-5

    def mu(self, t):
        return _mod(t).ones_like(_as_array(t)) * 1.0

    def sigma(self, t):
        log_ratio = math.log(self.sigma_max / self.sigma_min)
        return self.sigma_min * _mod(t).exp(_as_array(t) * log_ratio)

    def f(self, t):
        return np.zeros_like(np.asarray(t, dtype=np.float64))

    def g2(self, t):
        log_ratio = math.log(self.sigma_max / self.sigma_min)
        return 2.0 * log_ratio * self.sigma(t) ** 2

    def psi(self, t, s):
        return np.ones_like(np.asarray(t, dtype=np.float64) * np.asarray(s, dtype=np.float64))

    def rho(self, t):
        return self.sigma(t)

    def t_of_rho(self, rho):
        rho = np.asarray(rho, dtype=np.float64)
        return np.log(rho / self.sigma_min) / math.log(self.sigma_max / self.sigma_min)

    def prior_std(self):
        return math.sqrt(1.0 + self.sigma(self.T) ** 2)


@dataclasses.dataclass
class SubVPSDE(VPSDE):
    """sub-VP SDE (Song et al. 2020b): the coefficient engine is SDE-generic."""

    def sigma(self, t):
        return -_mod(t).expm1(self.log_alpha_bar(t))  # 1 - alpha_bar

    def g2(self, t):
        return self.beta(t) * (-np.expm1(2.0 * self.log_alpha_bar(t)))

    def t_of_rho(self, rho):
        # rho = (1-ab)/sqrt(ab): ab^2 - (2+rho^2) ab + 1 = 0, root < 1
        rho = np.asarray(rho, dtype=np.float64)
        ab = 0.5 * ((2.0 + rho ** 2) - np.sqrt((2.0 + rho ** 2) ** 2 - 4.0))
        c = -np.log(ab)
        a = 0.5 * (self.beta_max - self.beta_min)
        b = self.beta_min
        return (-b + np.sqrt(b ** 2 + 4.0 * a * c)) / (2.0 * a)


def get_sde(name: str, **kw) -> SDE:
    name = name.lower()
    if name in ("vp", "vpsde"):
        return VPSDE(**kw)
    if name in ("ve", "vesde"):
        return VESDE(**kw)
    if name in ("subvp", "subvpsde"):
        return SubVPSDE(**kw)
    raise ValueError(f"unknown SDE {name!r}")
