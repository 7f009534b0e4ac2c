r"""Data log-likelihood via the transformed PF-ODE (paper App. B Q1; the
counterpart of ``repro.core.likelihood``).

In the DEIS y-coordinates (Prop. 3) the PF-ODE is ``dy/drho = eps_hat(y,
rho)``, so by the instantaneous change-of-variables formula

    d log p(y_rho) / drho = -div_y eps_hat(y, rho),

and with x = mu(t) y the data NLL follows from integrating y and log p
jointly from t0 to T with a fixed-grid rhoRK method. The divergence is
exact (the trace of ``torch.func.jacfwd``) for small D, or Hutchinson's
estimate (``torch.func.jvp`` against Rademacher probes).

``eps_fn`` is called on ONE flat sample at a time: ``eps_fn(y (D,), t)``,
``t`` a 0-d tensor, vectorised over the batch by ``torch.func.vmap`` (the
reference ``vmap``\ s the same per-sample call). An eps-net that needs a
batch axis, such as :func:`repro_torch.diffusion.score_net.mlp_score_apply`
(which reads ``x.shape[0]`` as the batch), does not take this call, in the
reference either; the analytic oracles do.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch.func import jacfwd, jvp, vmap

from .plan import _TABLEAUS, _f64
from .sde import SDE


def _divergence_exact(fn, y):
    """trace of d fn / d y for a single flat vector y."""
    return torch.trace(jacfwd(fn)(y))


def _divergence_hutchinson(fn, y, probes):
    """mean over the probes v (P, D) of v . (d fn / d y) v."""
    return torch.stack([torch.sum(jvp(fn, (y,), (v,))[1] * v) for v in probes]).mean()


def nll_bits_per_dim(sde: SDE, eps_fn: Callable, x0: torch.Tensor, n_steps: int = 12,
                     method: str = "kutta3", exact_div: bool = True,
                     gen: torch.Generator | None = None,
                     n_probes: int = 8) -> torch.Tensor:
    """NLL of a batch of flat data vectors x0 (B, D) in bits/dim, (B,).

    Integrates y and log p from t0 to T with the fixed-grid rhoRK
    ``method`` on a geometric (uniform in log rho) grid: the divergence
    integrand concentrates at small rho, where a uniform-in-rho grid
    undersamples. Hutchinson's probes (``exact_div=False``) are Rademacher
    draws from ``gen`` (a fresh generator seeded 0 on x0's device when
    None), all drawn before the integration: (B, n_steps, stages,
    n_probes, D).
    """
    b, d = x0.shape
    rho_lo = float(sde.rho(sde.t0))
    rho_hi = float(sde.rho(sde.T))
    rhos = np.exp(np.linspace(np.log(rho_lo), np.log(rho_hi), n_steps + 1))
    mus = _f64(sde.mu(_f64(sde.t_of_rho(rhos))))
    c, a, bw = _TABLEAUS[method]
    s = len(c)
    stage_rho = rhos[:-1, None] + c[None, :] * np.diff(rhos)[:, None]
    stage_t = _f64(sde.t_of_rho(stage_rho))
    stage_mu = _f64(sde.mu(stage_t))
    h = np.diff(rhos)
    a_mat = np.zeros((s, s))
    for i, row in enumerate(a):
        a_mat[i, : len(row)] = row

    probes = None
    if not exact_div:
        if gen is None:
            gen = torch.Generator(device=x0.device).manual_seed(0)
        probes = torch.randint(0, 2, (b, n_steps, s, n_probes, d), generator=gen,
                               device=x0.device).to(x0.dtype) * 2 - 1

    def single(x0_i, probes_i):
        y = x0_i / float(mus[0])
        logp_delta = torch.zeros((), dtype=x0.dtype, device=x0.device)
        for k in range(n_steps):  # static unroll: n_steps is small
            ks, divs = [], []
            for i in range(s):
                y_i = y
                for j in range(i):
                    y_i = y_i + float(h[k] * a_mat[i, j]) * ks[j]
                t_ki = torch.tensor(stage_t[k, i], dtype=x0.dtype, device=x0.device)
                fn = lambda yy, mu=float(stage_mu[k, i]), t=t_ki: eps_fn(mu * yy, t)
                ks.append(fn(y_i))
                divs.append(_divergence_exact(fn, y_i) if probes_i is None
                            else _divergence_hutchinson(fn, y_i, probes_i[k, i]))
            y = y + float(h[k]) * sum(float(bw[i]) * ks[i] for i in range(s))
            logp_delta = logp_delta - float(h[k]) * sum(float(bw[i]) * divs[i]
                                                        for i in range(s))
        # prior: x_T ~ N(0, (mu_T^2 + sigma_T^2) I) => y_T ~ N(0, (1 + rho_T^2) I)
        var_y = 1.0 + rho_hi ** 2
        logp_prior = -0.5 * torch.sum(y ** 2) / var_y - 0.5 * d * math.log(2 * math.pi * var_y)
        # log p_x(x0) = log p_y(y0) - D log mu(t0); log p_y(y_t0) came from the flow
        logp_x0 = logp_prior - logp_delta - d * math.log(mus[0])
        return -logp_x0 / d / math.log(2.0)

    if probes is None:
        return vmap(lambda x: single(x, None))(x0)
    return vmap(single)(x0, probes)
