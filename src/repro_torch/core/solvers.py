"""Deprecated name-based solver factory (the counterpart of
``repro.core.solvers``).

.. deprecated::
    Every solver is a pure :class:`~repro_torch.core.plan.SolverPlan` applied
    by the single executor in :mod:`repro_torch.core.sampler`:

        from repro_torch.core import make_plan, sample
        plan = make_plan("tab3", sde, ts)          # pure builder, plan out
        x0 = sample(plan, eps_fn, x_T)             # the one executor

    ``make_solver`` survives as a thin alias that warns and returns the
    :class:`SolverPlan` ``make_plan`` would build (``fused_update=`` is
    translated to ``fused=`` for old call sites). Plans carry ``.nfe`` but no
    ``.sample`` method: pass them to :func:`repro_torch.core.sampler.sample`.

Migration map (old -> new):

    ABSolver(sde, ts, order, basis)    -> plan_ab(sde, ts, order, basis)
    ABSolver(..., fused_update=True)   -> plan_ab(..., fused=True)
    RKSolver(sde, ts, method)          -> plan_rk(sde, ts, method)
    DPMSolver2(sde, ts)                -> plan_rk(sde, ts, method="dpm2")
    EulerSolver(sde, ts)               -> plan_euler(sde, ts)
    EMSolver(sde, ts, lam)             -> plan_em(sde, ts, lam)
    DDIMSolver(sde, ts, eta)           -> plan_ddim(sde, ts, eta)
    IPNDMSolver(sde, ts, order)        -> plan_ipndm(sde, ts, order)
    PNDMSolver(sde, ts)                -> plan_pndm(sde, ts)
    make_solver(name, sde, ts).sample  -> sample(make_plan(name, sde, ts), ...)
    AdaptiveRK23 (analysis tool)       -> unchanged, repro_torch.core.adaptive
"""
from __future__ import annotations

import warnings

from .plan import SOLVER_NAMES, SolverPlan, make_plan
from .sde import SDE

__all__ = ["SOLVER_NAMES", "make_solver"]


def make_solver(name: str, sde: SDE, ts, **kw) -> SolverPlan:
    """Deprecated alias for :func:`repro_torch.core.plan.make_plan`.

    Returns the ``SolverPlan`` directly; sample with
    ``repro_torch.core.sample(plan, eps_fn, x_T, gen)``. The legacy
    ``fused_update=`` keyword maps to the plan builders' ``fused=``.
    """
    warnings.warn(
        "make_solver is deprecated: build plans with repro_torch.core.make_plan "
        "and run them with repro_torch.core.sample/step",
        DeprecationWarning, stacklevel=2)
    if "fused_update" in kw:
        kw["fused"] = kw.pop("fused_update")
    return make_plan(name, sde, ts, **kw)
