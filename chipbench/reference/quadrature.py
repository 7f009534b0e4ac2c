"""Frozen float64 copy of the DEIS coefficient engine and the solver plans
the benchmark's mixes use (host numpy, no torch).

Copied from the port's ``repro_torch/core/sde.py`` (``VPSDE``),
``core/schedules.py`` (``power_t``, the "quadratic" schedule),
``core/coeffs.py`` (``ab_coefficients``, ``eps_norm_profile``,
``sn_ab_coefficients``) and ``core/plan.py`` (the builders of the ab and rk
families), and frozen here so that a change to the program cannot move its
own yardstick. Only the solvers a mix may name are built (:data:`SOLVERS`).

A plan is a dict: ``method`` ("ab" or "rk"), ``ts`` (N + 1,), ``nfe``,
``stochastic`` and the per-step tables (ab: ``psi`` (N,), ``C`` (N, r),
optional ``nu`` (N, r) and ``s`` (N,); rk: ``h``, ``mu``, ``stage_t``,
``stage_mu``, ``A``, ``b``).
"""
from __future__ import annotations

import numpy as np

BETA_MIN, BETA_MAX, T_END, T0 = 0.1, 20.0, 1.0, 1e-3
GL_POINTS = 48


# ------------------------------------------------------------------- VPSDE
def log_alpha_bar(t):
    t = np.asarray(t, dtype=np.float64)
    return -0.5 * t ** 2 * (BETA_MAX - BETA_MIN) - t * BETA_MIN


def mu(t):
    return np.exp(0.5 * log_alpha_bar(t))


def sigma(t):
    return np.sqrt(-np.expm1(log_alpha_bar(t)))


def rho(t):
    return sigma(t) / mu(t)


def t_of_rho(r):
    r = np.asarray(r, dtype=np.float64)
    c = np.log1p(r ** 2)
    a = 0.5 * (BETA_MAX - BETA_MIN)
    return (-BETA_MIN + np.sqrt(BETA_MIN ** 2 + 4.0 * a * c)) / (2.0 * a)


PRIOR_STD = 1.0   # mu_T^2 + sigma_T^2 = 1 for VP


def quadratic_ts(n: int) -> np.ndarray:
    """The power-2 schedule in t from T to t0, n steps."""
    i = np.arange(n + 1)
    return ((n - i) / n * T_END ** 0.5 + i / n * T0 ** 0.5) ** 2


# -------------------------------------------------------------- quadrature
def _gauss_legendre(a: float, b: float):
    x, w = np.polynomial.legendre.leggauss(GL_POINTS)
    return 0.5 * (b - a) * x + 0.5 * (b + a), 0.5 * (b - a) * w


def _lagrange(nodes, j, x):
    out = np.ones_like(x)
    for k in range(len(nodes)):
        if k != j:
            out = out * (x - nodes[k]) / (nodes[j] - nodes[k])
    return out


def _eps_norm(t):
    return sigma(t) / np.sqrt(mu(t) ** 2 + sigma(t) ** 2)


def ab_coefficients(ts, order: int, basis: str, normalized: bool = False):
    """(psi, C, nu): C[k, j] = mu(t_{k+1}) int l_j(x(rho)) [ell(t(rho))] drho
    over the history nodes in the ``basis`` chart (t, rho or lambda);
    ``normalized`` keeps the eps-norm profile ell inside the integral and
    returns nu[k, j] = 1 / ell(t_{k-j}) (score-normalized DEIS)."""
    ts = np.asarray(ts, dtype=np.float64)
    n = len(ts) - 1
    m, r = mu(ts), rho(ts)
    ell = _eps_norm(ts)
    C = np.zeros((n, order + 1))
    nu = np.zeros((n, order + 1))
    for k in range(n):
        r_eff = min(order, k)
        idx = np.array([k - j for j in range(r_eff + 1)])
        q_rho, q_w = _gauss_legendre(r[k], r[k + 1])
        q_t = t_of_rho(q_rho)
        if basis == "rho":
            q_x, nodes = q_rho, r[idx]
        elif basis == "lambda":
            q_x, nodes = -np.log(q_rho), -np.log(r[idx])
        else:
            q_x, nodes = q_t, ts[idx]
        weight = _eps_norm(q_t) if normalized else 1.0
        for j in range(r_eff + 1):
            C[k, j] = m[k + 1] * np.sum(q_w * weight * _lagrange(nodes, j, q_x))
            nu[k, j] = 1.0 / ell[idx[j]]
    return m[1:] / m[:-1], C, nu


# ----------------------------------------------------------------- plans
_TABLEAUS = {
    "heun": (np.array([0.0, 1.0]), np.array([[0.0, 0.0], [1.0, 0.0]]), np.array([0.5, 0.5])),
    "midpoint": (np.array([0.0, 0.5]), np.array([[0.0, 0.0], [0.5, 0.0]]), np.array([0.0, 1.0])),
}

SOLVERS = ("ddim", "tab1", "tab2", "tab3", "rhoab1", "rhoab2", "rhoab3", "dpm2m", "dpm3m",
           "seeds1", "seeds2", "seeds3", "sndeis1", "sndeis2", "sndeis3", "rho_heun",
           "rho_midpoint")


def stages(name: str) -> int:
    """Network evaluations per grid interval."""
    return len(_TABLEAUS[name[4:]][0]) if name.startswith("rho_") else 1


def n_grid(name: str, nfe: int) -> int:
    """Grid intervals of a request of ``nfe`` evaluations (as the engine sizes them)."""
    return max(1, nfe // stages(name))


def make_plan(name: str, nfe: int) -> dict:
    if name not in SOLVERS:
        raise ValueError(f"no reference plan for solver {name!r}")
    ts = quadratic_ts(n_grid(name, nfe))
    n = len(ts) - 1
    out = {"ts": ts, "nfe": n * stages(name), "stochastic": False}
    if name.startswith("rho_"):
        c, a, b = _TABLEAUS[name[4:]]
        r = rho(ts)
        h = r[1:] - r[:-1]
        st_rho = np.maximum(r[:-1, None] + c[None, :] * h[:, None], float(r[-1]) * (1 - 1e-12))
        st_t = t_of_rho(st_rho)
        return dict(out, method="rk", h=h, mu=mu(ts), stage_t=st_t, stage_mu=mu(st_t),
                    A=np.broadcast_to(a, (n, len(c), len(c))).copy(), b=b)
    if name == "ddim" or name.startswith("tab"):
        psi, C, _ = ab_coefficients(ts, 0 if name == "ddim" else int(name[3:]), "t")
        return dict(out, method="ab", psi=psi, C=C)
    if name.startswith("rhoab"):
        psi, C, _ = ab_coefficients(ts, int(name[5:]), "rho")
        return dict(out, method="ab", psi=psi, C=C)
    if name.startswith("dpm"):
        psi, C, _ = ab_coefficients(ts, int(name[3]) - 1, "lambda")
        return dict(out, method="ab", psi=psi, C=C)
    if name.startswith("seeds"):
        psi, C, _ = ab_coefficients(ts, int(name[5:]) - 1, "lambda")
        r = rho(ts)
        s = sigma(ts)[1:] * np.sqrt(np.expm1(2.0 * np.log(r[:-1] / r[1:])))
        return dict(out, method="ab", psi=psi, C=2.0 * C, s=s, stochastic=True)
    psi, C, nu = ab_coefficients(ts, int(name[6:]), "t", normalized=True)   # sndeis
    return dict(out, method="ab", psi=psi, C=C, nu=nu)


def history_len(plan: dict) -> int:
    return plan["C"].shape[1] if plan["method"] == "ab" else 0


def n_steps(plan: dict) -> int:
    return len(plan["ts"]) - 1
