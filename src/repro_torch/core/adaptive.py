"""Error control shared by adaptive stepping and serving's early exit.

The counterpart of ``repro.core.adaptive`` for the pieces the serving path
reads: :func:`error_ratio` and :func:`step_factor` (the estimate/rescale
helpers) and :class:`RetirePolicy`, the rule by which the serving engine
retires a row once its embedded local-error estimate
(``SamplerState.err``) has converged. ``AdaptiveRK23`` is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


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
