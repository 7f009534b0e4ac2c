"""Error control shared by adaptive stepping and serving's early exit (the
counterpart of ``repro.core.adaptive``).

* :class:`AdaptiveRK23` -- adaptive-step rhoRK (Bogacki-Shampine 3(2)) on
  the rho-ODE dy/drho = eps_hat(y, rho) (Prop. 3), counting accepted AND
  rejected evaluations: the paper's App. B Q2 point that a rejection
  wastes NFE a small budget cannot spare.
* :class:`RetirePolicy` -- the rule by which the serving engine retires a
  row once its embedded local-error estimate (``SamplerState.err``) has
  converged.

Both go through :func:`error_ratio` and :func:`step_factor`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .plan import _f64
from .sampler import SamplerState
from .sde import SDE


def error_ratio(y_hi, y_lo, y_prev, atol: float, rtol: float) -> float:
    """Scaled Linf error of an embedded pair: max |y_hi - y_lo| / scale with
    the elementwise scale ``atol + rtol * max(|y_hi|, |y_prev|)``.
    <= 1 means the step is acceptable at these tolerances."""
    scale = atol + rtol * torch.maximum(y_hi.abs(), y_prev.abs())
    return float(((y_hi - y_lo).abs() / scale).max())


def step_factor(err: float) -> float:
    """Classic third-order step rescale on an :func:`error_ratio` value:
    0.9 err^(-1/3), clipped to [0.2, 5]."""
    return float(np.clip(0.9 * max(err, 1e-12) ** (-1 / 3), 0.2, 5.0))


@dataclasses.dataclass(frozen=True)
class RetirePolicy:
    """Early-exit decision over ``SamplerState.err``: a row whose running
    local-error estimate has dropped to ``tol`` (absolute, or relative to
    the row's own Linf magnitude) after at least ``min_k`` of its own steps
    is converged and retires early.

    The decision is a pure per-row function of ``(err, k_own, |x|_inf)``,
    so a solo solve under the same policy retires at the identical step.
    Rows whose plan carries no embedded pair report ``err == +inf`` and
    never converge.
    """

    tol: float
    min_k: int = 2        # floor of own-steps before the estimate is trusted
    norm: str = "abs"     # "abs": err <= tol; "rel": err <= tol * |x|_inf

    def __post_init__(self):
        if not (self.tol > 0):
            raise ValueError(f"tol must be positive, got {self.tol!r}")
        if self.norm not in ("abs", "rel"):
            raise ValueError(f"norm must be 'abs' or 'rel', got {self.norm!r}")
        if self.min_k < 1:
            raise ValueError(f"min_k must be >= 1, got {self.min_k!r}")

    def converged(self, err, x_inf=None):
        """Elementwise convergence mask (host-side numpy over per-row
        vectors or scalars). ``x_inf`` is required for ``norm='rel'``."""
        err = np.asarray(err, np.float64)
        if self.norm == "rel":
            if x_inf is None:
                raise ValueError("norm='rel' needs the per-row |x|_inf scale")
            bound = self.tol * np.maximum(np.asarray(x_inf, np.float64), 1e-12)
        else:
            bound = self.tol
        return np.isfinite(err) & (err <= bound)


@dataclasses.dataclass
class AdaptiveResult:
    """Adaptive solve outcome on the executor's ``SamplerState``:
    ``state.x`` is the final iterate and ``state.k`` the accepted-step
    count."""

    state: SamplerState
    nfe: int          # total evals including rejected steps
    n_accepted: int
    n_rejected: int

    @property
    def x0(self) -> torch.Tensor:
        return self.state.x


class AdaptiveRK23:
    """Embedded Bogacki-Shampine 3(2) on the rho-ODE with adaptive steps.

    3 fresh evals per attempted step (FSAL reuse on accept). The control
    flow is on the host, so the NFE accounting is exact (an analysis tool,
    not a serving sampler: the paper's point is that one should not serve
    with it). Accept/reject and step rescaling go through
    :func:`error_ratio` / :func:`step_factor`.
    """

    def __init__(self, sde: SDE, rtol: float = 1e-2, atol: float = 1e-2,
                 max_steps: int = 1000, name: str = "rk23_adaptive"):
        self.name, self.nfe = name, -1     # nfe is data-dependent (see solve)
        self.sde = sde
        self.ts = _f64(np.array([sde.T, sde.t0]))
        self.rtol, self.atol, self.max_steps = rtol, atol, max_steps

    def solve(self, eps_fn, x_T) -> AdaptiveResult:
        sde = self.sde
        rho_hi = float(sde.rho(sde.T))
        rho_lo = float(sde.rho(sde.t0))
        mu_T = float(sde.mu(sde.T))

        def eval_eps(y, rho):
            t = float(sde.t_of_rho(np.array(rho)))
            mu = float(sde.mu(t))
            return eps_fn(mu * y, torch.as_tensor(t, dtype=y.dtype, device=y.device))

        y = x_T / mu_T
        rho = rho_hi
        h = -(rho_hi - rho_lo) * 0.05   # initial step: 5% of the interval
        nfe = n_acc = n_rej = 0
        last_err = float("inf")          # y-space Linf of the last accepted pair
        k1 = eval_eps(y, rho)
        nfe += 1
        for _ in range(self.max_steps):
            if rho <= rho_lo * (1 + 1e-9):
                break
            h = -min(-h, rho - rho_lo)
            k2 = eval_eps(y + 0.5 * h * k1, rho + 0.5 * h)
            k3 = eval_eps(y + 0.75 * h * k2, rho + 0.75 * h)
            nfe += 2
            y3 = y + h * (2 / 9 * k1 + 1 / 3 * k2 + 4 / 9 * k3)
            k4 = eval_eps(y3, rho + h)
            nfe += 1
            y2 = y + h * (7 / 24 * k1 + 1 / 4 * k2 + 1 / 3 * k3 + 1 / 8 * k4)
            err = error_ratio(y3, y2, y, self.atol, self.rtol)
            if err <= 1.0:
                last_err = float((y3 - y2).abs().max())
                y, rho, k1 = y3, rho + h, k4   # FSAL
                n_acc += 1
            else:
                n_rej += 1
            h = h * step_factor(err)
        mu_0 = float(sde.mu(sde.t0))
        x0 = mu_0 * y
        state = SamplerState(x=x0, hist=x0.new_zeros((0,) + tuple(x0.shape)), key=None,
                             k=n_acc, err=torch.as_tensor(mu_0 * last_err, dtype=x0.dtype,
                                                          device=x0.device))
        return AdaptiveResult(state, nfe, n_acc, n_rej)
