"""DEIS core in PyTorch: host float64 coefficient engine, solver plans and
the single step executor (the counterpart of ``repro.core``)."""
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
from .adaptive import RetirePolicy, error_ratio, step_factor

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
    "RetirePolicy", "error_ratio", "step_factor",
]
