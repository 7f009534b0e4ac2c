"""Timestep schedules (paper Ingredient 4; App. H.3 Eqs. 42-44).

All schedules return a *decreasing* array ``ts`` of length N+1 with
``ts[0] = T`` (= t_N in the paper's indexing) and ``ts[-1] = t0``.
The sampler steps through consecutive pairs (ts[k], ts[k+1]).
"""
from __future__ import annotations

import numpy as np

from .sde import SDE


def uniform_t(sde: SDE, n: int, t0: float | None = None) -> np.ndarray:
    """Uniform step in t (paper's 'linear timesteps')."""
    t0 = sde.t0 if t0 is None else t0
    return np.linspace(sde.T, t0, n + 1)


def power_t(sde: SDE, n: int, t0: float | None = None, kappa: float = 2.0) -> np.ndarray:
    """Power schedule in t (Eq. 42); kappa=2 is the DDIM 'quadratic' schedule."""
    t0 = sde.t0 if t0 is None else t0
    i = np.arange(n + 1)
    return ((n - i) / n * sde.T ** (1.0 / kappa) + i / n * t0 ** (1.0 / kappa)) ** kappa


def power_rho(sde: SDE, n: int, t0: float | None = None, kappa: float = 7.0) -> np.ndarray:
    """Power schedule in rho (Eq. 43); kappa=7 is the EDM/Karras schedule."""
    t0 = sde.t0 if t0 is None else t0
    rho_lo, rho_hi = float(sde.rho(t0)), float(sde.rho(sde.T))
    i = np.arange(n + 1)
    rhos = ((n - i) / n * rho_hi ** (1.0 / kappa) + i / n * rho_lo ** (1.0 / kappa)) ** kappa
    return np.asarray(sde.t_of_rho(rhos), dtype=np.float64)


def log_rho(sde: SDE, n: int, t0: float | None = None) -> np.ndarray:
    """Uniform in log rho (Eq. 44); equivalent to uniform log-SNR (DPM-Solver)."""
    t0 = sde.t0 if t0 is None else t0
    rho_lo, rho_hi = float(sde.rho(t0)), float(sde.rho(sde.T))
    i = np.arange(n + 1)
    rhos = np.exp((n - i) / n * np.log(rho_hi) + i / n * np.log(rho_lo))
    return np.asarray(sde.t_of_rho(rhos), dtype=np.float64)


SCHEDULES = {
    "uniform": uniform_t,
    "quadratic": lambda sde, n, t0=None: power_t(sde, n, t0, kappa=2.0),
    "power_t": power_t,
    "power_rho": power_rho,
    "edm": lambda sde, n, t0=None: power_rho(sde, n, t0, kappa=7.0),
    "log_rho": log_rho,
}


def get_timesteps(sde: SDE, n: int, schedule: str = "quadratic",
                  t0: float | None = None, **kw) -> np.ndarray:
    try:
        fn = SCHEDULES[schedule]
    except KeyError:
        raise ValueError(f"unknown schedule {schedule!r}; have {sorted(SCHEDULES)}")
    ts = fn(sde, n, t0, **kw) if kw else fn(sde, n, t0)
    if not (np.all(np.diff(ts) < 0) and ts[0] > ts[-1]):
        raise AssertionError("timesteps must be strictly decreasing from T to t0")
    return ts
