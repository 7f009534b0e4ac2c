r"""Matrix-coefficient DEIS: critically-damped Langevin diffusion (CLD); the
counterpart of ``repro.core.matrix_sde``.

The paper (Sec. 2): "Our approach is applicable to any DMs, including ... the
critically-damped Langevin diffusion (CLD) (Dockhorn et al., 2021) where
these coefficients are indeed non-diagonal matrices." This module makes that
claim concrete: the augmented state per data dimension is z = (x, v) and

    dz = beta(t) A z dt + G_t dw,
    A  = [[0, 1/M], [-1, -Gamma/M]],   G_t = diag(0, sqrt(2*Gamma*beta)),

with critical damping M = Gamma^2 / 4. Everything the scalar engine uses
generalizes:

  * transition matrix  Psi(t, s) = expm(A * (B(t) - B(s))),  B = \int beta —
    closed form under critical damping (double eigenvalue -2/Gamma):
        expm(A u) = e^{lam u} (I + (A - lam I) u).
  * marginal covariance Sigma(t): Lyapunov ODE dSigma/dB = A S + S A^T + N,
    N = [[0,0],[0, 2 Gamma]], integrated ONCE on the host in float64 (the
    paper: "even if analytic formulas are not available, one can use high
    accuracy solvers to obtain these coefficients").
  * eps-parameterization with the 2x2 Cholesky L_t of Sigma(t):
    score = -L_t^{-T} eps.
  * tAB-DEIS coefficients C_ij become 2x2 MATRICES:
        C_ij = \int Psi(t', tau) (beta/2) N L_tau^{-T} l_j(tau) dtau
    via the same Gauss-Legendre quadrature.

The coefficients are host numpy float64 (the port's Gauss-Legendre and
Lagrange helpers); the iterates ``z`` (..., 2) are torch tensors on the
caller's device, and each coefficient matrix is moved there in ``z``'s
dtype.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .coeffs import _gauss_legendre, _lagrange_basis


@dataclasses.dataclass
class CLD:
    """Critically-damped Langevin forward SDE (per data dimension)."""

    gamma: float = 2.0           # friction Gamma; M = Gamma^2/4
    beta_min: float = 0.1
    beta_max: float = 8.0
    v_init_frac: float = 0.04    # gamma_0: initial v variance = gamma_0 * M
    T: float = 1.0
    t0: float = 1e-3
    _n_lyap: int = 4000

    def __post_init__(self):
        g = self.gamma
        m_inv = 4.0 / g ** 2
        self.A = np.array([[0.0, m_inv], [-1.0, -g * m_inv]])
        self.N = np.array([[0.0, 0.0], [0.0, 2.0 * g]])
        self.lam = -2.0 / g
        self._precompute_sigma()

    # ---- time scalings -----------------------------------------------------
    def beta(self, t):
        return self.beta_min + t * (self.beta_max - self.beta_min)

    def B(self, t):
        t = np.asarray(t, dtype=np.float64)
        return self.beta_min * t + 0.5 * t ** 2 * (self.beta_max - self.beta_min)

    # ---- transition matrix --------------------------------------------------
    def psi(self, t, s) -> np.ndarray:
        """expm(A (B(t)-B(s))) in closed form (critical damping)."""
        u = float(self.B(t) - self.B(s))
        lam = self.lam
        return np.exp(lam * u) * (np.eye(2) + (self.A - lam * np.eye(2)) * u)

    # ---- marginal covariance -------------------------------------------------
    def _precompute_sigma(self):
        """Integrate the Lyapunov ODE on a fine B-grid (host, float64)."""
        b_hi = float(self.B(self.T))
        bs = np.linspace(0.0, b_hi, self._n_lyap + 1)
        m = self.gamma ** 2 / 4.0
        sig = np.zeros((2, 2))
        sig[1, 1] = self.v_init_frac * m
        a, n = self.A, self.N
        sigs = [sig.copy()]
        for i in range(self._n_lyap):
            h = bs[i + 1] - bs[i]

            def f(s):
                return a @ s + s @ a.T + n

            k1 = f(sig)
            k2 = f(sig + 0.5 * h * k1)
            k3 = f(sig + 0.5 * h * k2)
            k4 = f(sig + h * k3)
            sig = sig + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            sigs.append(sig.copy())
        self._b_grid = bs
        self._sigma_grid = np.stack(sigs)

    def sigma(self, t) -> np.ndarray:
        """Sigma(t) for the conditional p(z_t | x_0 fixed, v_0 ~ N(0, g0 M))."""
        b = float(self.B(t))
        return np.stack([np.interp(b, self._b_grid, self._sigma_grid[:, i, j])
                         for i in range(2) for j in range(2)]).reshape(2, 2)

    def chol(self, t) -> np.ndarray:
        s = self.sigma(t)
        # regularize the (near-singular at t->0) xx entry
        return np.linalg.cholesky(s + 1e-12 * np.eye(2))

    def equilibrium_cov(self) -> np.ndarray:
        """Sigma_infty = diag(1, M) for CLD's stationary unit scaling."""
        m = self.gamma ** 2 / 4.0
        return np.diag([1.0, m])


def cld_ab_coefficients(cld: CLD, ts: np.ndarray, order: int):
    """Matrix tAB-DEIS coefficients.

    Returns psi: (N, 2, 2) and C: (N, order+1, 2, 2) with the update

        z_{k+1} = psi[k] @ z_k + sum_j C[k, j] @ eps(z_{k-j}, t_{k-j}).
    """
    ts = np.asarray(ts, dtype=np.float64)
    n = len(ts) - 1
    psi = np.stack([cld.psi(ts[k + 1], ts[k]) for k in range(n)])
    C = np.zeros((n, order + 1, 2, 2))
    for k in range(n):
        r_eff = min(order, k)
        nodes_t = np.array([ts[k - j] for j in range(r_eff + 1)])
        q_t, q_w = _gauss_legendre(ts[k], ts[k + 1], 64)
        for j in range(r_eff + 1):
            lj = _lagrange_basis(nodes_t, j, q_t)
            acc = np.zeros((2, 2))
            for qi in range(len(q_t)):
                tau = float(q_t[qi])
                l_inv_t = np.linalg.inv(cld.chol(tau)).T
                integrand = cld.psi(ts[k + 1], tau) @ (
                    0.5 * cld.beta(tau) * cld.N) @ l_inv_t
                acc += q_w[qi] * lj[qi] * integrand
            C[k, j] = acc
    return psi, C


def _mat(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=like.dtype, device=like.device)


class CLDGaussianOracle:
    """Exact eps(z, t) for 1-D Gaussian data x0 ~ N(mean, var) under CLD."""

    def __init__(self, cld: CLD, mean: float, var: float):
        self.cld, self.mean, self.var = cld, mean, var

    def _moments(self, t):
        psi0 = self.cld.psi(t, 0.0)
        m_t = psi0 @ np.array([self.mean, 0.0])
        data_cov = np.array([[self.var, 0.0], [0.0, 0.0]])
        s_t = psi0 @ data_cov @ psi0.T + self.cld.sigma(t)
        return m_t, s_t

    def eps_fn(self):
        cld = self.cld

        def eps(z, t):
            # z: (..., 2); t static per call from host-side solver
            t_f = float(t)
            m_t, s_t = self._moments(t_f)
            score = -(z - _mat(m_t, z)) @ _mat(
                np.linalg.inv(s_t + 1e-12 * np.eye(2)).T, z)
            l_t = cld.chol(t_f)
            return -score @ _mat(l_t, z)   # eps = -L^T score

        return eps


def cld_sample(cld: CLD, ts, order: int, eps_fn, z_T):
    """Host-driven matrix tAB-DEIS sampler (analysis tool; times static)."""
    psi, C = cld_ab_coefficients(cld, np.asarray(ts), order)
    n = len(ts) - 1
    hist: list = []
    z = z_T
    for k in range(n):
        e = eps_fn(z, float(ts[k]))
        hist = [e] + hist[: order]
        z = z @ _mat(psi[k].T, z)
        for j in range(min(order, k) + 1):
            z = z + hist[j] @ _mat(C[k, j].T, z)
    return z


def cld_reference(cld: CLD, eps_fn, z_T, n_steps: int = 4000):
    """Fine-grid RK4 on the CLD probability-flow ODE (reference solution).

    dz/dt = beta [A z - 0.5 N score] = beta A z + 0.5 beta N L^{-T} eps
    """
    ts = np.linspace(cld.T, cld.t0, n_steps + 1)
    z = z_T

    def f(z, t):
        e = eps_fn(z, t)
        l_inv_t = np.linalg.inv(cld.chol(t)).T
        drift_lin = z @ _mat((cld.beta(t) * cld.A).T, z)
        drift_nl = e @ _mat((0.5 * cld.beta(t) * cld.N @ l_inv_t).T, z)
        return drift_lin + drift_nl

    for k in range(n_steps):
        h = ts[k + 1] - ts[k]
        k1 = f(z, ts[k])
        k2 = f(z + 0.5 * h * k1, ts[k] + 0.5 * h)
        k3 = f(z + 0.5 * h * k2, ts[k] + 0.5 * h)
        k4 = f(z + h * k3, ts[k + 1])
        z = z + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return z
