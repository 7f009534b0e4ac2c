"""DEIS core in PyTorch: host float64 coefficient engine, solver plans, the
single step executor, adaptive stepping and the likelihood (the
counterpart of ``repro.core``, with its deprecated ``make_solver``
alias)."""
from .sde import SDE, VPSDE, VESDE, SubVPSDE, get_sde
from .schedules import get_timesteps, SCHEDULES
from .coeffs import (ab_coefficients, ddim_coefficients_vp,
                     eps_norm_profile, naive_ei_coefficients,
                     sn_ab_coefficients, AB_WEIGHTS)
from .plan import (SOLVER_NAMES, SolverPlan, cached_make_plan, inert_row,
                   join_rows, make_plan, pad_plan, solver_stages,
                   stack_plans, take_rows)
from .sampler import (Hooks, SamplerState, init_state, join_state_rows,
                      sample, step, take_state_rows)
from .adaptive import (AdaptiveResult, AdaptiveRK23, RetirePolicy,
                       error_ratio, step_factor)
from .likelihood import nll_bits_per_dim
from .solvers import make_solver

__all__ = [
    "SDE", "VPSDE", "VESDE", "SubVPSDE", "get_sde",
    "get_timesteps", "SCHEDULES",
    "ab_coefficients", "ddim_coefficients_vp", "eps_norm_profile",
    "naive_ei_coefficients", "sn_ab_coefficients", "AB_WEIGHTS",
    "SOLVER_NAMES", "SolverPlan", "cached_make_plan", "inert_row",
    "join_rows", "make_plan", "pad_plan", "solver_stages", "stack_plans",
    "take_rows",
    "Hooks", "SamplerState", "init_state", "join_state_rows", "sample",
    "step", "take_state_rows",
    "AdaptiveResult", "AdaptiveRK23", "RetirePolicy", "error_ratio",
    "step_factor",
    "nll_bits_per_dim",
    "make_solver",
]
