r"""DEIS coefficient engine (paper Eqs. 11, 14, 15).

Every DEIS multistep update is a linear combination

    x_{t_next} = psi * x_{t_cur} + sum_j C_j * eps_theta(x_hist_j, t_hist_j),

where ``psi = mu(t_next)/mu(t_cur)`` and, using the identity

    (1/2) Psi(t_next, tau) g(tau)^2 / sigma(tau) dtau = mu(t_next) * drho(tau),

the polynomial-extrapolation coefficients reduce to

    C_j = mu(t_next) * \int_{rho(t_cur)}^{rho(t_next)} l_j(rho) drho,

with ``l_j`` the Lagrange basis over the history nodes, expressed either in the
``rho`` coordinate (rhoAB-DEIS -- the integral is an exact polynomial integral)
or in the ``t`` coordinate (tAB-DEIS -- evaluated through t(rho)).

We compute all integrals with fixed-order Gauss-Legendre quadrature per step
interval. For rhoAB the quadrature is *exact* (polynomial degree <= r << 2*Q-1);
for tAB it is accurate to quadrature error ~1e-14 for the smooth t(rho) maps of
VPSDE/VESDE. Coefficients are computed **once on the host in float64** and baked
into the jitted sampling loop as constants (paper: "calculated once ... reused
across batches").

Closed-form VPSDE r=0 coefficients (Prop. 2 / deterministic DDIM) are provided
separately and tested to match the quadrature to ~1e-12.
"""
from __future__ import annotations

import numpy as np

from .sde import SDE

_GL_POINTS = 48  # exact for polynomials up to degree 95


def _gauss_legendre(a: float, b: float, n: int = _GL_POINTS):
    """Nodes and weights for \\int_a^b on possibly reversed interval (a > b ok)."""
    x, w = np.polynomial.legendre.leggauss(n)
    nodes = 0.5 * (b - a) * x + 0.5 * (b + a)
    weights = 0.5 * (b - a) * w
    return nodes, weights


def _lagrange_basis(nodes: np.ndarray, j: int, x: np.ndarray) -> np.ndarray:
    """l_j(x) over the given nodes, numerically stable for few nodes (r <= 3)."""
    out = np.ones_like(x)
    for k in range(len(nodes)):
        if k == j:
            continue
        out = out * (x - nodes[k]) / (nodes[j] - nodes[k])
    return out


def ab_coefficients(sde: SDE, ts: np.ndarray, order: int, basis: str = "t") -> tuple[np.ndarray, np.ndarray]:
    r"""Coefficients for (t|rho)AB-DEIS of the given order.

    Args:
      sde: forward SDE.
      ts: decreasing times, shape (N+1,), ts[0]=T, ts[-1]=t0.
      order: polynomial order r (0 = DDIM).
      basis: 't' for tAB-DEIS, 'rho' for rhoAB-DEIS, 'lambda' for the
        half-log-SNR coordinate lambda = -log rho = log(mu/sigma). Lagrange
        extrapolation in lambda integrated against drho reproduces the
        DPM-Solver multistep updates (Lu et al. 2022, arXiv 2206.00927)
        exactly: drho = -exp(-lambda) dlambda turns
        mu' * int l_j(lambda(rho)) drho into the lambda-Taylor finite
        differences of DPM-Solver-2/3, so the "new" family is one more
        coordinate chart over the SAME quadrature engine.

    Returns:
      psi:  (N,)          linear-term weights mu(ts[k+1]) / mu(ts[k])
      C:    (N, order+1)  C[k, j] multiplies eps history eps(ts[k-j]); rows for
                          k < order use the warmup (lower effective order) and
                          are zero-padded (paper App. B Q3).
    """
    if basis not in ("t", "rho", "lambda"):
        raise ValueError(f"basis must be 't', 'rho' or 'lambda', got {basis!r}")
    ts = np.asarray(ts, dtype=np.float64)
    n = len(ts) - 1
    mu = np.asarray(sde.mu(ts), dtype=np.float64)
    rho = np.asarray(sde.rho(ts), dtype=np.float64)

    psi = mu[1:] / mu[:-1]
    C = np.zeros((n, order + 1), dtype=np.float64)
    for k in range(n):
        r_eff = min(order, k)
        hist_idx = np.array([k - j for j in range(r_eff + 1)])
        nodes_t = ts[hist_idx]
        nodes_rho = rho[hist_idx]
        q_rho, q_w = _gauss_legendre(rho[k], rho[k + 1])
        if basis == "rho":
            q_x = q_rho
            nodes = nodes_rho
        elif basis == "lambda":
            q_x = -np.log(q_rho)
            nodes = -np.log(nodes_rho)
        else:
            q_x = np.asarray(sde.t_of_rho(q_rho), dtype=np.float64)
            nodes = nodes_t
        for j in range(r_eff + 1):
            C[k, j] = mu[k + 1] * np.sum(q_w * _lagrange_basis(nodes, j, q_x))
    return psi, C


def eps_norm_profile(sde: SDE, t, data_var: float = 1.0) -> np.ndarray:
    """RMS eps magnitude profile ell(t) used by score-normalized DEIS
    (arXiv 2311.00157): under data with per-dim variance ``data_var`` the
    marginal-average eps RMS is sigma / sqrt(mu^2 v + sigma^2) (exactly
    sigma(t) for VP with unit data variance). SN-DEIS fits the polynomial to
    the *normalized* integrand eps/ell -- flat across t, so the Lagrange
    extrapolation is better conditioned over wide steps."""
    t = np.asarray(t, dtype=np.float64)
    mu = np.asarray(sde.mu(t), dtype=np.float64)
    sig = np.asarray(sde.sigma(t), dtype=np.float64)
    return sig / np.sqrt(mu ** 2 * data_var + sig ** 2)


def sn_ab_coefficients(sde: SDE, ts: np.ndarray, order: int,
                       basis: str = "t", data_var: float = 1.0
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    r"""Score-normalized DEIS coefficients (arXiv 2311.00157).

    The eps integrand is split as eps(tau) = ell(tau) * [eps(tau)/ell(tau)]
    and the Lagrange polynomial fits the normalized bracket, so the
    per-step weight keeps ell *inside* the integral:

        C[k, j] = mu(ts[k+1]) * \int l_j(x(rho)) ell(t(rho)) drho,
        nu[k, j] = 1 / ell(ts[k - j])   (the history normalization vector).

    The step-time weight on history entry j is ``C[k, j] * nu[k, j]`` -- the
    executor multiplies the two, so ``nu`` is a genuine per-step coefficient
    leaf that must survive padding/stacking/joining/sharding like any other.

    Returns (psi, C, nu), each with the AB layout of :func:`ab_coefficients`
    (warmup rows lower-order, zero-padded -- nu rows too, so padded history
    slots carry zero weight).
    """
    if basis not in ("t", "rho", "lambda"):
        raise ValueError(f"basis must be 't', 'rho' or 'lambda', got {basis!r}")
    ts = np.asarray(ts, dtype=np.float64)
    n = len(ts) - 1
    mu = np.asarray(sde.mu(ts), dtype=np.float64)
    rho = np.asarray(sde.rho(ts), dtype=np.float64)
    ell = eps_norm_profile(sde, ts, data_var)

    psi = mu[1:] / mu[:-1]
    C = np.zeros((n, order + 1), dtype=np.float64)
    nu = np.zeros((n, order + 1), dtype=np.float64)
    for k in range(n):
        r_eff = min(order, k)
        hist_idx = np.array([k - j for j in range(r_eff + 1)])
        q_rho, q_w = _gauss_legendre(rho[k], rho[k + 1])
        q_t = np.asarray(sde.t_of_rho(q_rho), dtype=np.float64)
        q_ell = eps_norm_profile(sde, q_t, data_var)
        if basis == "rho":
            q_x, nodes = q_rho, rho[hist_idx]
        elif basis == "lambda":
            q_x, nodes = -np.log(q_rho), -np.log(rho[hist_idx])
        else:
            q_x, nodes = q_t, ts[hist_idx]
        for j in range(r_eff + 1):
            C[k, j] = mu[k + 1] * np.sum(
                q_w * q_ell * _lagrange_basis(nodes, j, q_x))
            nu[k, j] = 1.0 / ell[hist_idx[j]]
    return psi, C, nu


def ddim_coefficients_vp(sde, ts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Closed-form Prop. 2 coefficients for VPSDE (deterministic DDIM).

        x' = sqrt(ab'/ab) x + [sqrt(1-ab') - sqrt(ab'/ab) sqrt(1-ab)] eps
    """
    ts = np.asarray(ts, dtype=np.float64)
    ab = np.asarray(sde.alpha_bar(ts), dtype=np.float64)
    psi = np.sqrt(ab[1:] / ab[:-1])
    C = (np.sqrt(1.0 - ab[1:]) - psi * np.sqrt(1.0 - ab[:-1]))[:, None]
    return psi, C


def naive_ei_coefficients(sde: SDE, ts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Ingredient-1-only EI (paper Eq. 8): score parameterization s_theta with
    the *frozen* L_t^{-T} taken at the step start. Used to reproduce Fig. 3a
    (naive EI is WORSE than Euler). Returned as eps-coefficients:

        C_k = [\\int_{t_k}^{t_{k+1}} 1/2 Psi(t_{k+1}, tau) g(tau)^2 dtau] / sigma(t_k)
            = mu(t_{k+1}) [\\int sigma(tau(rho)) drho] / sigma(t_k)
    """
    ts = np.asarray(ts, dtype=np.float64)
    n = len(ts) - 1
    mu = np.asarray(sde.mu(ts), dtype=np.float64)
    sig = np.asarray(sde.sigma(ts), dtype=np.float64)
    rho = np.asarray(sde.rho(ts), dtype=np.float64)
    psi = mu[1:] / mu[:-1]
    C = np.zeros((n, 1), dtype=np.float64)
    for k in range(n):
        q_rho, q_w = _gauss_legendre(rho[k], rho[k + 1])
        q_t = np.asarray(sde.t_of_rho(q_rho), dtype=np.float64)
        integral = mu[k + 1] * np.sum(q_w * np.asarray(sde.sigma(q_t), dtype=np.float64))
        C[k, 0] = integral / sig[k]
    return psi, C


# Classical Adams-Bashforth weights on a *uniform* grid, used by (i)PNDM
# (paper Eqs. 36, 38-40). AB_WEIGHTS[r][j] multiplies eps_{k-j}.
AB_WEIGHTS = {
    0: np.array([1.0]),
    1: np.array([3.0, -1.0]) / 2.0,
    2: np.array([23.0, -16.0, 5.0]) / 12.0,
    3: np.array([55.0, -59.0, 37.0, -9.0]) / 24.0,
}
