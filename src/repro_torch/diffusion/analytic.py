"""Analytic score oracles (zero fitting error) for controlled experiments
(the counterpart of ``repro.diffusion.analytic``).

The paper separates *fitting error* from *discretization error* (Sec. 3).
These oracles give the exact eps(x, t), so discretization error can be
measured alone:

  - Gaussian data N(m, diag(v)): p_t is Gaussian, and the PF-ODE solution
    is the quantile map x_t = mu_t m + s_t z with s_t^2 = mu_t^2 v +
    sigma_t^2, an *exact* x_0 for any x_T.
  - Gaussian mixture: the exact posterior-weighted score; a reference x_0
    comes from a fine-grid rho_rk4 solve.

The eps functions take torch tensors and compute in ``x``'s dtype on its
device; the data's parameters are host numpy arrays, moved at each call.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.sampler import bcast as _per_request
from ..core.sde import SDE


def _tensor(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)


@dataclasses.dataclass
class GaussianData:
    """Data ~ N(mean, diag(var)). Exact eps and exact PF-ODE flow.

    ``eps_fn`` accepts a scalar ``t`` or a per-request vector ``t: (R,)``
    paired with ``x: (R, *inner)`` (the stacked-plan executor contract).
    """

    sde: SDE
    mean: np.ndarray
    var: np.ndarray

    def eps_fn(self):
        sde = self.sde

        def eps(x, t):
            m, v = _tensor(self.mean, x), _tensor(self.var, x)
            t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
            mu = _per_request(sde.mu(t), x)
            sig = _per_request(sde.sigma(t), x)
            marg_var = mu ** 2 * v + sig ** 2
            score = -(x - mu * m) / marg_var
            return -sig * score

        return eps

    def exact_flow(self, x_from, t_from: float, t_to: float):
        """Exact PF-ODE transport of ``x_from`` from ``t_from`` to ``t_to``."""
        sde = self.sde
        m, v = _tensor(self.mean, x_from), _tensor(self.var, x_from)
        s = lambda t: torch.sqrt(float(sde.mu(t)) ** 2 * v + float(sde.sigma(t)) ** 2)
        z = (x_from - float(sde.mu(t_from)) * m) / s(t_from)
        return float(sde.mu(t_to)) * m + s(t_to) * z


@dataclasses.dataclass
class GMMData:
    """Data ~ sum_i w_i N(m_i, var_i I) in R^D; exact score via posterior
    weights."""

    sde: SDE
    means: np.ndarray      # (K, D)
    variances: np.ndarray  # (K,)
    weights: np.ndarray    # (K,)

    def eps_fn(self):
        sde = self.sde
        d = self.means.shape[-1]

        def eps(x, t):
            means, variances = _tensor(self.means, x), _tensor(self.variances, x)
            logw = torch.log(_tensor(self.weights, x))
            t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
            mu, sig = sde.mu(t), sde.sigma(t)
            marg_var = mu ** 2 * variances + sig ** 2          # (K,)
            diff = x[..., None, :] - mu * means                # (..., K, D)
            sq = torch.sum(diff ** 2, -1)                      # (..., K)
            logp_k = logw - 0.5 * sq / marg_var - 0.5 * d * torch.log(2 * math.pi * marg_var)
            post = torch.softmax(logp_k, dim=-1)               # (..., K)
            score_k = -diff / marg_var[..., None]              # (..., K, D)
            score = torch.sum(post[..., None] * score_k, dim=-2)
            return -sig * score

        return eps

    def sample_data(self, gen: torch.Generator, n: int, dtype=torch.float32):
        """``n`` draws on ``gen``'s device: the components first, then the
        unit normals."""
        device = gen.device
        w = torch.as_tensor(self.weights, dtype=torch.float64, device=device)
        comps = torch.multinomial(w, n, replacement=True, generator=gen)
        noise = torch.randn((n, self.means.shape[-1]), generator=gen, device=device,
                            dtype=dtype)
        m = torch.as_tensor(self.means, dtype=dtype, device=device)[comps]
        s = torch.sqrt(torch.as_tensor(self.variances, dtype=dtype, device=device))[comps, None]
        return m + s * noise

    def log_prob(self, x):
        means, variances = _tensor(self.means, x), _tensor(self.variances, x)
        logw = torch.log(_tensor(self.weights, x))
        d = means.shape[-1]
        diff = x[..., None, :] - means
        sq = torch.sum(diff ** 2, -1)
        logp_k = logw - 0.5 * sq / variances - 0.5 * d * torch.log(2 * math.pi * variances)
        return torch.logsumexp(logp_k, dim=-1)


def default_gmm(sde: SDE, d: int = 2, seed: int = 0) -> GMMData:
    """A well-separated 8-mode GMM in R^d (a ring for d=2)."""
    rng = np.random.RandomState(seed)
    k = 8
    if d == 2:
        ang = np.linspace(0, 2 * np.pi, k, endpoint=False)
        means = 4.0 * np.stack([np.cos(ang), np.sin(ang)], -1)
    else:
        means = 4.0 * rng.randn(k, d)
    return GMMData(sde, means.astype(np.float64),
                   np.full((k,), 0.09), np.full((k,), 1.0 / k))
