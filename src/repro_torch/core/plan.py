r"""SolverPlan: immutable per-step coefficient tables for every DEIS-family
solver (paper Secs. 3-4, App. H.2), held as torch tensors.

The counterpart of ``repro.core.plan``. Coefficients are computed once on
the host in float64 numpy (the builders below are the reference's, line for
line) and stored as float64 CPU tensors; a consumer moves a plan to its
device and working dtype with :meth:`SolverPlan.to` /
:meth:`SolverPlan.astype`. A ``SolverPlan`` holds

  * tensors: ``ts`` and a ``coeffs`` dict of per-step tables, and
  * static metadata: the step ``method`` tag, the ``stochastic``/``fused``/
    ``stacked``/``error_estimate`` flags and the NFE count.

Three step methods cover all thirty ``SOLVER_NAMES``:

  ``ab``    x' = psi[k] x + C[k] @ eps_hist (+ s[k] xi for stochastic plans).
  ``rk``    rhoRK-DEIS on dy/drho = eps_hat (Prop. 3) with a per-step
            Butcher tableau A[k].
  ``pndm``  original PNDM: 3 pseudo-RK4 warmup steps + an AB4 tail.

Plans are consumed by :mod:`repro_torch.core.sampler`. The splice
primitives (``stack_plans``, ``pad_plan``, ``take_rows``, ``join_rows``,
``inert_row``) are what the serving engine uses to batch, pad, compact and
join requests; they classify leaves by :func:`_leaf_role`, shape-generically.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import coeffs as C
from .sde import SDE, VPSDE

# the thirty solver names make_plan accepts (``repro.core.solvers.SOLVER_NAMES``)
SOLVER_NAMES = ["ddim", "tab1", "tab2", "tab3", "rhoab1", "rhoab2", "rhoab3",
                "rho_heun", "rho_midpoint", "rho_kutta3", "rho_rk4", "dpm2",
                "euler", "naive_ei", "em", "ddim_eta", "ipndm1", "ipndm2",
                "ipndm3", "pndm",
                "dpm2m", "dpm3m", "seeds1", "seeds2", "seeds3",
                "scire2", "scire3", "sndeis1", "sndeis2", "sndeis3"]


def _f64(x):
    return np.asarray(x, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class SolverPlan:
    """Immutable table of precomputed per-step solver coefficients.

    ``coeffs``/``ts`` are tensors; ``method``, ``stochastic``, ``fused``,
    ``nfe``, ``stacked`` and ``error_estimate`` are static. Two plans with
    equal :attr:`signature` share one serving executor.
    """

    coeffs: dict
    ts: torch.Tensor
    method: str
    stochastic: bool = False
    fused: bool = False
    nfe: int = 0
    stacked: bool = False
    # True when the plan carries an embedded lower-order companion ("E" for
    # the ab/pndm families, "b_err" for rk): step() then maintains a per-row
    # local-error estimate in SamplerState.err.
    error_estimate: bool = False

    @property
    def n_steps(self) -> int:
        """Solver steps on this plan's grid (``len(ts) - 1``; includes any
        inert steps appended by :func:`pad_plan` -- ``nfe`` does not)."""
        return self.ts.shape[-1] - 1

    @property
    def batch(self) -> int:
        """Leading request axis of a stacked plan (1 for unstacked plans)."""
        return self.ts.shape[0] if self.stacked else 1

    @property
    def history_len(self) -> int:
        """Rows of eps history carried in ``SamplerState.hist``."""
        if self.method == "ab":
            return self.coeffs["C"].shape[-1]
        if self.method == "pndm":
            return 4
        return 0  # rk: stage evals live inside one step

    @property
    def signature(self) -> tuple:
        """Executor identity: plans with equal signatures (and equal batch and
        shape of the sampled state) share one serving executor."""
        leaves = tuple(sorted((k, tuple(v.shape), str(v.dtype))
                              for k, v in self.coeffs.items()))
        return (self.method, self.stochastic, self.fused, self.stacked,
                self.error_estimate, tuple(self.ts.shape), leaves)

    @property
    def family(self) -> tuple:
        """Signature with the step-count axis wildcarded (unstacked plans):
        the serving engine's admission-bucketing key. Plans of one family
        padded to one ``n_steps`` with :func:`pad_plan` stack."""
        if self.stacked:
            raise ValueError("family is defined for unstacked plans (it is "
                             "the admission-bucketing key, applied before "
                             "stacking)")

        n = self.n_steps

        def wild(name, shape):
            if _leaf_role(name, shape, n) != "static":
                return ("*",) + shape[1:]
            return shape

        leaves = tuple(sorted((k, wild(k, tuple(v.shape)), str(v.dtype))
                              for k, v in self.coeffs.items()))
        return (self.method, self.stochastic, self.fused,
                self.error_estimate, ("*",), leaves)

    def astype(self, dtype) -> "SolverPlan":
        """Cast floating leaves to ``dtype`` (returns ``self`` when already
        there -- ``step()`` calls this every step)."""
        needs = lambda a: a.is_floating_point() and a.dtype != dtype
        if not needs(self.ts) and not any(needs(v) for v in self.coeffs.values()):
            return self
        cast = lambda a: a.to(dtype) if a.is_floating_point() else a
        return dataclasses.replace(
            self, coeffs={k: cast(v) for k, v in self.coeffs.items()},
            ts=cast(self.ts))

    def to(self, device=None, dtype=None) -> "SolverPlan":
        """Move every leaf to ``device`` and cast floating leaves to
        ``dtype`` (either may be None to keep it)."""
        plan = self if dtype is None else self.astype(dtype)
        if device is None or plan.ts.device == torch.device(device):
            return plan
        return dataclasses.replace(
            plan, coeffs={k: v.to(device) for k, v in plan.coeffs.items()},
            ts=plan.ts.to(device))


def stack_plans(plans) -> SolverPlan:
    """Stack same-signature plans along a new leading *request* axis.

    Row ``i`` of the stacked plan is plan ``i`` bit-for-bit; the executor
    applies it to row ``i`` of a batched ``SamplerState``, so one executor
    serves a group that mixes solver names. The stacked plan's static
    ``nfe`` is the members' maximum (ragged groups: per-request accounting
    stays with the caller).
    """
    plans = list(plans)
    if not plans:
        raise ValueError("stack_plans requires at least one plan")
    base = plans[0]
    if base.stacked:
        raise ValueError("cannot re-stack an already stacked plan")
    for p in plans[1:]:
        if p.signature != base.signature:
            raise ValueError(
                f"cannot stack plans with different signatures:\n  {base.signature}"
                f"\n  {p.signature}")
    coeffs = {k: torch.stack([p.coeffs[k] for p in plans])
              for k in base.coeffs}
    ts = torch.stack([p.ts for p in plans])
    return dataclasses.replace(base, coeffs=coeffs, ts=ts, stacked=True,
                               nfe=max(p.nfe for p in plans))


# Leaf roles, by name (the same sets as the reference's role registries):
# per-step leaves (leading axis == n_steps) are zero-padded, wildcarded and
# zeroed by inert_row; per-knot leaves (leading axis == n_steps + 1, like
# ts) and time-like per-step leaves are edge-replicated, so padded steps
# never evaluate the eps network out of domain; static leaves never change.
_STEP_LEAVES = frozenset({"psi", "C", "E", "s", "nu", "h", "stage_t",
                          "stage_mu", "A"})
_KNOT_LEAVES = frozenset({"mu"})
_TIME_LEAVES = frozenset({"stage_t"})
_STATIC_LEAVES = frozenset({"b", "b_err", "warm_ratio_m", "warm_coef_m",
                            "warm_ratio_n", "warm_coef_n", "warm_t_mid"})


def _leaf_role(name: str, shape: tuple, n_steps: int) -> str:
    """Classify a coefficient leaf as 'step' / 'knot' / 'time' / 'static'.

    Registered names win; a novel key falls through to a shape heuristic:
    leading axis == n_steps is per-step, n_steps + 1 per-knot, anything
    else static. This is what lets the splice primitives carry arbitrary
    coefficient dicts without a per-family code change."""
    if name in _TIME_LEAVES:
        return "time"
    if name in _KNOT_LEAVES:
        return "knot"
    if name in _STEP_LEAVES:
        return "step"
    if name in _STATIC_LEAVES:
        return "static"
    if len(shape) and shape[0] == n_steps:
        return "step"
    if len(shape) and shape[0] == n_steps + 1:
        return "knot"
    return "static"


def pad_plan(plan: SolverPlan, n_steps: int) -> SolverPlan:
    """Extend an unstacked plan to ``n_steps`` solver steps by padding.

    Weight-like per-step leaves are zero-filled, time/knot-like leaves (and
    ``ts``) edge-replicated. The first ``plan.n_steps`` steps are the
    original tensors bit-for-bit, which keeps a request padded into a
    ragged group reproducible. ``nfe`` is unchanged.
    """
    if plan.stacked:
        raise ValueError("pad_plan operates on unstacked plans (pad, then stack)")
    n = plan.n_steps
    if n_steps == n:
        return plan
    if n_steps < n:
        raise ValueError(f"cannot pad a {n}-step plan down to {n_steps} steps")
    pad = n_steps - n

    def edge(v):
        return torch.cat([v, v[-1:].expand((pad,) + tuple(v.shape[1:]))])

    def zeros(v):
        return torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])

    coeffs = {}
    for name, v in plan.coeffs.items():
        role = _leaf_role(name, tuple(v.shape), n)
        if role in ("knot", "time"):
            coeffs[name] = edge(v)
        elif role == "step":
            coeffs[name] = zeros(v)
        else:
            coeffs[name] = v
    return dataclasses.replace(plan, coeffs=coeffs, ts=edge(plan.ts))


def _row_index(rows, device) -> torch.Tensor:
    idx = torch.as_tensor(list(rows), dtype=torch.long)
    if idx.ndim != 1 or idx.numel() == 0:
        raise ValueError(f"rows must be a non-empty 1-D index sequence, got "
                         f"shape {tuple(idx.shape)}")
    return idx.to(device)


def place_plan(plan: SolverPlan, shardings) -> SolverPlan:
    """This rank's block of a whole (every rank holds it) plan under a
    plan-shaped tree of :class:`repro_torch.sharding.rules.NamedSharding`
    (a row-sharded leaf keeps this rank's contiguous block of rows, a
    replicated one stays whole)."""
    return dataclasses.replace(
        plan, coeffs={k: shardings.coeffs[k].local(v) for k, v in plan.coeffs.items()},
        ts=shardings.ts.local(plan.ts))


def take_rows(plan: SolverPlan, rows, shardings=None) -> SolverPlan:
    """Row-gather a stacked plan: keep requests ``rows`` (a host index
    sequence), in that order. Every leaf is gathered on axis 0, so the
    surviving rows are bit-identical to what they were in the larger stack
    (the plan half of mid-flight compaction; the state half is
    :func:`repro_torch.core.sampler.take_state_rows`).

    ``shardings`` (a plan-shaped tree of ``NamedSharding``, e.g. from
    :func:`repro_torch.sharding.rules.plan_specs`) returns this rank's block
    of the new row layout instead (:func:`place_plan`); ``plan`` is then the
    whole plan, which every rank of the mesh holds."""
    if not plan.stacked:
        raise ValueError("take_rows requires a stacked plan")
    idx = _row_index(rows, plan.ts.device)
    out = dataclasses.replace(
        plan, coeffs={k: v[idx] for k, v in plan.coeffs.items()},
        ts=plan.ts[idx])
    return out if shardings is None else place_plan(out, shardings)


def _rowless_signature(plan: SolverPlan) -> tuple:
    """Identity of a stacked plan's ROWS (leading request axis stripped)."""
    leaves = tuple(sorted((k, tuple(v.shape[1:]), str(v.dtype))
                          for k, v in plan.coeffs.items()))
    return (plan.method, plan.stochastic, plan.fused, plan.error_estimate,
            tuple(plan.ts.shape[1:]), leaves)


def join_rows(plan: SolverPlan, new_plans, shardings=None) -> SolverPlan:
    """Splice joiner rows onto a stacked plan's request axis.

    ``new_plans`` are unstacked same-family plans; each is padded to the
    stack's step horizon (a longer joiner is rejected: it must form a fresh
    group). The leading rows are the original stack bit-for-bit and the
    appended rows the padded joiners bit-for-bit, so
    ``take_rows(join_rows(p, new), range(p.batch))`` round-trips to ``p``.
    ``shardings`` returns this rank's block of the joined rows, as in
    :func:`take_rows`.
    """
    if not plan.stacked:
        raise ValueError("join_rows splices rows onto a stacked plan")
    new_plans = list(new_plans)
    if not new_plans:
        raise ValueError("join_rows requires at least one joiner plan")
    padded = []
    for p in new_plans:
        if p.stacked:
            raise ValueError("joiner plans must be unstacked (one per row)")
        if p.n_steps > plan.n_steps:
            raise ValueError(
                f"cannot join a {p.n_steps}-step plan into a stack with a "
                f"{plan.n_steps}-step horizon: extending the grid would "
                "change the stack's signature (form a fresh group instead)")
        padded.append(pad_plan(p, plan.n_steps))
    add = stack_plans(padded)
    if _rowless_signature(add) != _rowless_signature(plan):
        raise ValueError(
            f"joiner rows are not of the stack's family:\n  "
            f"{_rowless_signature(plan)}\n  {_rowless_signature(add)}")
    out = dataclasses.replace(
        plan,
        coeffs={k: torch.cat([plan.coeffs[k], add.coeffs[k]])
                for k in plan.coeffs},
        ts=torch.cat([plan.ts, add.ts]),
        nfe=max(plan.nfe, add.nfe))
    return out if shardings is None else place_plan(out, shardings)


def inert_row(plan: SolverPlan) -> SolverPlan:
    """A same-signature plan whose every step is inert: weight-like per-step
    leaves are zeroed (the iterate update is the zero map), time-like and
    static leaves are kept so every eps call stays in domain."""
    if plan.stacked:
        raise ValueError("inert_row operates on unstacked plans (build the "
                         "filler, then stack with the real rows)")
    coeffs = {}
    for name, v in plan.coeffs.items():
        if _leaf_role(name, tuple(v.shape), plan.n_steps) == "step":
            coeffs[name] = torch.zeros_like(v)
        else:
            coeffs[name] = v
    return dataclasses.replace(plan, coeffs=coeffs, nfe=0)


def _mk(method: str, coeffs: dict, ts: np.ndarray, *, stochastic=False,
        fused=False, nfe: int, error_estimate=False) -> SolverPlan:
    coeffs = {k: torch.from_numpy(np.array(v, dtype=np.float64))
              for k, v in coeffs.items()}
    return SolverPlan(coeffs=coeffs, ts=torch.from_numpy(np.array(_f64(ts))),
                      method=method, stochastic=stochastic, fused=fused,
                      nfe=nfe, error_estimate=error_estimate)


# --------------------------------------------------------------------- AB
def plan_ab(sde: SDE, ts, order: int = 0, basis: str = "t",
            naive_ei: bool = False, fused: bool = False,
            error_estimate: bool = False) -> SolverPlan:
    """tAB/rhoAB-DEIS (Eq. 14); r=0 == deterministic DDIM (Prop. 2).

    ``fused`` routes the multistep combination through the fused AB-step
    kernel (:mod:`repro_torch.kernels.deis_step`): one pass over memory
    instead of r+2.

    ``error_estimate`` adds the embedded order-(r-1) companion weights
    ``E = C_r - C_{r-1}`` (zero-padded to C's width): ``E[k] @ hist`` is the
    difference between this step's update and the one-order-lower update --
    a free local-error proxy from the SAME eps evaluations (the DPM-Solver
    trick). Warmup rows, where both orders coincide, are exactly zero, which
    ``step()`` reads as "no estimate yet". Order 0 has no lower order, so the
    request is ignored there (the plan's ``error_estimate`` stays False and
    such rows never early-exit).
    """
    ts = _f64(ts)
    if naive_ei:
        if order != 0:
            raise ValueError("naive EI is zero-order only")
        psi, Cm = C.naive_ei_coefficients(sde, ts)
    else:
        psi, Cm = C.ab_coefficients(sde, ts, order, basis)
    coeffs = {"psi": psi, "C": Cm}
    has_pair = error_estimate and order >= 1 and not naive_ei
    if has_pair:
        _, C_lo = C.ab_coefficients(sde, ts, order - 1, basis)
        E = np.array(Cm, dtype=np.float64, copy=True)
        E[:, :order] -= C_lo
        coeffs["E"] = E
    return _mk("ab", coeffs, ts, fused=fused, nfe=len(ts) - 1,
               error_estimate=has_pair)


def plan_ddim(sde: VPSDE, ts, eta: float = 0.0) -> SolverPlan:
    """Stochastic DDIM(eta) for VPSDE (Prop. 4, Eq. 34); eta=0 is the
    deterministic DDIM and produces a deterministic plan."""
    if not isinstance(sde, VPSDE):
        raise TypeError("stochastic DDIM is defined for VPSDE")
    ts = _f64(ts)
    ab = _f64(sde.alpha_bar(ts))
    sig2 = (eta ** 2) * (1 - ab[1:]) / (1 - ab[:-1]) * (1 - ab[:-1] / ab[1:])
    sig2 = np.maximum(sig2, 0.0)
    a = np.sqrt(ab[1:] / ab[:-1])
    # x' = a x + b eps + s xi,  b = sqrt(1-ab'-sig2) - a sqrt(1-ab)
    b = np.sqrt(np.maximum(1 - ab[1:] - sig2, 0.0)) - a * np.sqrt(1 - ab[:-1])
    coeffs = {"psi": a, "C": b[:, None]}
    if eta > 0:
        coeffs["s"] = np.sqrt(sig2)
    return _mk("ab", coeffs, ts, stochastic=eta > 0, nfe=len(ts) - 1)


def plan_euler(sde: SDE, ts) -> SolverPlan:
    """Explicit Euler on the x-space PF-ODE (Eq. 7), folded to affine form:
    x' = (1 + dt f) x + (dt * g^2 / (2 sigma)) eps."""
    ts = _f64(ts)
    dt = ts[1:] - ts[:-1]
    psi = 1.0 + dt * _f64(sde.f(ts[:-1]))
    Cm = (dt * 0.5 * _f64(sde.g2(ts[:-1])) / _f64(sde.sigma(ts[:-1])))[:, None]
    return _mk("ab", {"psi": psi, "C": Cm}, ts, nfe=len(ts) - 1)


def plan_em(sde: SDE, ts, lam: float = 1.0) -> SolverPlan:
    """Euler-Maruyama on the lambda-SDE (Eq. 4); lambda=1 = reverse diffusion.
    Affine form with per-step noise scale s = lam g sqrt(-dt)."""
    ts = _f64(ts)
    dt = ts[1:] - ts[:-1]
    psi = 1.0 + dt * _f64(sde.f(ts[:-1]))
    coef = 0.5 * (1 + lam ** 2) * _f64(sde.g2(ts[:-1])) / _f64(sde.sigma(ts[:-1]))
    s = lam * np.sqrt(_f64(sde.g2(ts[:-1]))) * np.sqrt(-dt)
    return _mk("ab", {"psi": psi, "C": (dt * coef)[:, None], "s": s}, ts,
               stochastic=True, nfe=len(ts) - 1)


def plan_ipndm(sde: SDE, ts, order: int = 3,
               error_estimate: bool = False) -> SolverPlan:
    """Improved PNDM (App. H.2, Algo 4): classical uniform-grid AB weights
    with lower-order warmup, folded into the AB coefficient matrix.

    ``error_estimate`` folds the classical AB pair the same way:
    ``E[k] = C0[k] * (W[r_eff] - W[r_eff - 1])``, zero at k=0 (no lower
    order to compare against yet)."""
    ts = _f64(ts)
    psi, C0 = C.ab_coefficients(sde, ts, 0, "t")
    n = len(ts) - 1
    Cm = np.zeros((n, order + 1))
    for k in range(n):
        r_eff = min(order, k)
        Cm[k, : r_eff + 1] = C0[k, 0] * C.AB_WEIGHTS[r_eff]
    coeffs = {"psi": psi, "C": Cm}
    has_pair = error_estimate and order >= 1
    if has_pair:
        E = np.zeros((n, order + 1))
        for k in range(1, n):
            r_eff = min(order, k)
            E[k, : r_eff + 1] = C0[k, 0] * C.AB_WEIGHTS[r_eff]
            E[k, : r_eff] -= C0[k, 0] * C.AB_WEIGHTS[r_eff - 1]
        coeffs["E"] = E
    return _mk("ab", coeffs, ts, nfe=n, error_estimate=has_pair)


# --------------------------------------------- next-gen multistep families
def plan_dpm_multistep(sde: SDE, ts, order: int = 2,
                       error_estimate: bool = False) -> SolverPlan:
    """DPM-Solver-2/3 multistep (Lu et al. 2022, arXiv 2206.00927).

    DPM-Solver's multistep variants are Adams-Bashforth extrapolation of the
    eps history in the half-log-SNR coordinate lambda = log(mu/sigma):
    ``drho = -exp(-lambda) dlambda`` turns the DEIS quadrature
    ``mu' * int l_j(lambda(rho)) drho`` into exactly DPM-Solver's
    lambda-Taylor finite-difference updates, so the family reuses the AB
    history machinery wholesale -- an ``ab`` plan with lambda-basis
    coefficients. ``order`` is the overall convergence order (2 or 3; the
    polynomial degree is ``order - 1``).

    ``error_estimate`` adds the embedded DPM-(order-1) companion ``E``
    (lambda-basis lower-degree weights on the same grid): the order-2/3 pair
    the serving early-exit retire path consumes. Warmup rows are exactly
    zero, as for ``plan_ab``."""
    if order not in (2, 3):
        raise ValueError(f"DPM-Solver multistep order must be 2 or 3, got "
                         f"{order}")
    ts = _f64(ts)
    psi, Cm = C.ab_coefficients(sde, ts, order - 1, "lambda")
    coeffs = {"psi": psi, "C": Cm}
    if error_estimate:
        _, C_lo = C.ab_coefficients(sde, ts, order - 2, "lambda")
        E = np.array(Cm, dtype=np.float64, copy=True)
        E[:, : order - 1] -= C_lo
        coeffs["E"] = E
    return _mk("ab", coeffs, ts, nfe=len(ts) - 1,
               error_estimate=error_estimate)


def plan_seeds(sde: SDE, ts, order: int = 1) -> SolverPlan:
    """SEEDS: exponential-integrator solvers for the reverse *SDE* (Gonzalez
    et al. 2023, arXiv 2305.14267).

    The reverse SDE ``dx = [f x + g^2 eps/sigma] dt + g dw`` has the same
    semilinear split as the PF-ODE but a DOUBLED eps drift (g^2/sigma instead
    of g^2/(2 sigma)), so the deterministic part is 2x the lambda-basis AB
    coefficients of degree ``order - 1``. The linear-SDE noise accumulated
    over a step is exact (not Euler-Maruyama): with g^2 = 2 mu^2 rho rho',
    Var = sigma_{k+1}^2 (e^{2h} - 1) for h = lambda_{k+1} - lambda_k > 0,
    recovering the published SEEDS-1 / DPM-SDE-1 transition for order 1.

    Stochastic like ``plan_em``: the plan carries a per-step noise scale
    ``s`` and consumes one per-row PRNG draw per step, so SEEDS rows stack
    with the existing stochastic serving machinery unchanged. No embedded
    pair (the local error is noise-dominated); SEEDS rows never early-exit.
    """
    if order not in (1, 2, 3):
        raise ValueError(f"SEEDS order must be 1, 2 or 3, got {order}")
    ts = _f64(ts)
    psi, Cm = C.ab_coefficients(sde, ts, order - 1, "lambda")
    rho = _f64(sde.rho(ts))
    h = np.log(rho[:-1] / rho[1:])          # lambda increments, > 0
    s = _f64(sde.sigma(ts))[1:] * np.sqrt(np.expm1(2.0 * h))
    return _mk("ab", {"psi": psi, "C": 2.0 * Cm, "s": s}, ts,
               stochastic=True, nfe=len(ts) - 1)


def plan_sndeis(sde: SDE, ts, order: int = 2, basis: str = "t",
                data_var: float = 1.0,
                error_estimate: bool = False) -> SolverPlan:
    """Score-normalized DEIS (arXiv 2311.00157).

    Fits the Lagrange polynomial to the *normalized* integrand
    ``eps(tau)/ell(tau)`` (``ell`` = the RMS eps-magnitude profile, flat
    across t), keeping ``ell`` inside the quadrature. The plan carries the
    per-step normalization vector ``nu[k, j] = 1/ell(ts[k-j])`` as a NEW
    coefficient key: the executor weights history entry j by
    ``C[k, j] * nu[k, j]``. The splice primitives treat coefficient dicts
    generically, so ``nu`` survives padding, stacking, joining, compaction
    and sharding like any registered leaf.

    ``error_estimate`` adds the order-(r-1) companion ``E`` computed with
    the SAME normalization profile (the step applies ``E * nu`` too), so
    SN-DEIS rows retire through serving's early-exit path."""
    ts = _f64(ts)
    psi, Cm, nu = C.sn_ab_coefficients(sde, ts, order, basis, data_var)
    coeffs = {"psi": psi, "C": Cm, "nu": nu}
    has_pair = error_estimate and order >= 1
    if has_pair:
        _, C_lo, _ = C.sn_ab_coefficients(sde, ts, order - 1, basis, data_var)
        E = np.array(Cm, dtype=np.float64, copy=True)
        E[:, :order] -= C_lo
        coeffs["E"] = E
    return _mk("ab", coeffs, ts, nfe=len(ts) - 1, error_estimate=has_pair)


# --------------------------------------------------------------------- RK
_TABLEAUS = {
    "heun": (np.array([0.0, 1.0]),
             [np.array([]), np.array([1.0])],
             np.array([0.5, 0.5])),
    "midpoint": (np.array([0.0, 0.5]),
                 [np.array([]), np.array([0.5])],
                 np.array([0.0, 1.0])),
    "kutta3": (np.array([0.0, 0.5, 1.0]),
               [np.array([]), np.array([0.5]), np.array([-1.0, 2.0])],
               np.array([1.0, 4.0, 1.0]) / 6.0),
    "rk4": (np.array([0.0, 0.5, 0.5, 1.0]),
            [np.array([]), np.array([0.5]), np.array([0.0, 0.5]), np.array([0.0, 0.0, 1.0])],
            np.array([1.0, 2.0, 2.0, 1.0]) / 6.0),
}


# lower-order companion weights per tableau: Euler-from-stage-0 for the
# 2-stage methods, the embedded midpoint rule for the 3/4-stage ones.
# b_err = b - b_lo turns the stage evals already in hand into a local-error
# proxy (err = |mu h (b_err . ks)| in x-space) at zero extra NFE.
_B_LO = {
    "heun": np.array([1.0, 0.0]),
    "midpoint": np.array([1.0, 0.0]),
    "kutta3": np.array([0.0, 1.0, 0.0]),
    "rk4": np.array([0.0, 1.0, 0.0, 0.0]),
}


def plan_rk(sde: SDE, ts, method: str = "heun",
            error_estimate: bool = False) -> SolverPlan:
    """rhoRK-DEIS: explicit RK on dy/drho = eps_hat(y, rho) (Eq. 17, Prop. 3).

    ``method`` in {heun, midpoint, kutta3, rk4, dpm2}; ``dpm2`` is
    DPM-Solver-2 (Lu et al. 2022): midpoint with its stage at the geometric
    mean of (rho_k, rho_{k+1}), expressed here as a per-step a21.

    ``error_estimate`` adds the embedded companion weights ``b_err`` (full
    tableau minus a lower-order rule over the same stages); every step then
    yields a local-error estimate from the stage evals already computed.
    """
    ts = _f64(ts)
    n = len(ts) - 1
    tab = _TABLEAUS["midpoint" if method == "dpm2" else method]
    c, a, b = tab
    s = len(c)
    rho = _f64(sde.rho(ts))
    h = rho[1:] - rho[:-1]  # negative steps
    a_mat = np.zeros((s, s))
    for i, row in enumerate(a):
        a_mat[i, : len(row)] = row
    A = np.broadcast_to(a_mat, (n, s, s)).copy()
    if method == "dpm2":
        lam = -np.log(rho)
        stage_lam = np.stack([lam[:-1], 0.5 * (lam[:-1] + lam[1:])], axis=1)
        stage_rho = np.exp(-stage_lam)
        # stage sits at the geometric mean of (rho_k, rho_{k+1}); advance the
        # stage STATE there with a per-step a21 (exact for the EI transfer)
        A[:, 1, 0] = (stage_rho[:, 1] - rho[:-1]) / h
    else:
        stage_rho = rho[:-1, None] + c[None, :] * h[:, None]
        stage_rho = np.maximum(stage_rho, float(sde.rho(ts[-1])) * (1 - 1e-12))
    stage_t = _f64(sde.t_of_rho(stage_rho))
    coeffs = {"h": h, "mu": _f64(sde.mu(ts)), "stage_t": stage_t,
              "stage_mu": _f64(sde.mu(stage_t)), "A": A, "b": b}
    if error_estimate:
        coeffs["b_err"] = b - _B_LO["midpoint" if method == "dpm2" else method]
    return _mk("rk", coeffs, ts, nfe=n * s, error_estimate=error_estimate)


def plan_scire(sde: SDE, ts, order: int = 2, rd_m: float = 1,
               error_estimate: bool = False) -> SolverPlan:
    """SciRE-Solver: recursive-difference score-integrand RK on the NSR
    coordinate (Li et al. 2023, arXiv 2308.07896).

    SciRE integrates ``dy/drho = eps_hat`` (the NSR rho is the paper's
    score-integrand coordinate) with explicit RK stages whose combination
    weights are scaled by the recursive-difference factor

        phi1(m) = (3/4) * (1 - (-1/3)^m),

    the paper's truncation of the recursive finite-difference expansion of
    the score integrand. ``rd_m = 1`` gives ``phi1 = 1`` -- the classical
    tableau with provable order (the default, so the convergence-order
    harness holds at the nominal order); ``rd_m = float("inf")`` gives the
    paper's asymptotic variant ``phi1 = 3/4`` (formally lower classical
    order, tuned to trained score networks' integrand statistics).

    ``order`` in {2, 3} sets the stage count (2/3 evals per interval --
    serving budgets via :func:`solver_stages`). ``error_estimate`` adds the
    embedded Euler-from-stage-0 companion ``b_err``, so SciRE rows carry a
    local-error estimate from their first step."""
    if order not in (2, 3):
        raise ValueError(f"SciRE order must be 2 or 3, got {order}")
    phi1 = 0.75 * (1.0 - (-1.0 / 3.0) ** rd_m)
    ts = _f64(ts)
    n = len(ts) - 1
    rho = _f64(sde.rho(ts))
    h = rho[1:] - rho[:-1]  # negative steps
    if order == 2:
        c = np.array([0.0, 0.5])
        a_rows = [np.array([]), np.array([0.5])]
        # b2 = 1/(2 r1 phi1) with r1 = 1/2; phi1 = 1 recovers midpoint-Heun
        b = np.array([1.0 - 1.0 / phi1, 1.0 / phi1])
        b_lo = np.array([1.0, 0.0])
    else:
        c = np.array([0.0, 1.0 / 3.0, 2.0 / 3.0])
        a_rows = [np.array([]), np.array([1.0 / 3.0]),
                  np.array([0.0, 2.0 / 3.0])]
        # b3 = 3/(4 phi1); phi1 = 1 recovers Heun's third-order rule
        b = np.array([1.0 - 0.75 / phi1, 0.0, 0.75 / phi1])
        b_lo = np.array([1.0, 0.0, 0.0])
    s = len(c)
    a_mat = np.zeros((s, s))
    for i, row in enumerate(a_rows):
        a_mat[i, : len(row)] = row
    A = np.broadcast_to(a_mat, (n, s, s)).copy()
    stage_rho = rho[:-1, None] + c[None, :] * h[:, None]
    stage_rho = np.maximum(stage_rho, float(sde.rho(ts[-1])) * (1 - 1e-12))
    stage_t = _f64(sde.t_of_rho(stage_rho))
    coeffs = {"h": h, "mu": _f64(sde.mu(ts)), "stage_t": stage_t,
              "stage_mu": _f64(sde.mu(stage_t)), "A": A, "b": b}
    if error_estimate:
        coeffs["b_err"] = b - b_lo
    return _mk("rk", coeffs, ts, nfe=n * s, error_estimate=error_estimate)


# ------------------------------------------------------------------- PNDM
def plan_pndm(sde: SDE, ts, error_estimate: bool = False) -> SolverPlan:
    """Original PNDM (Liu et al. 2022): pseudo-RK4 warmup for the first 3
    steps (4 NFE each, DDIM transfers precomputed as affine ratios) then
    4th-order AB with DDIM transfer. NFE = N + 9.

    ``error_estimate`` equips the AB4 tail with the AB3 companion
    (``E = C0 * (W4 - W3)``); warmup rows carry no estimate (zero rows)."""
    ts = _f64(ts)
    n = len(ts) - 1
    if n < 4:
        raise ValueError("PNDM needs at least 4 steps")
    mu, rho = _f64(sde.mu(ts)), _f64(sde.rho(ts))
    tm = 0.5 * (ts[:-1] + ts[1:])
    mu_mid, rho_mid = _f64(sde.mu(tm)), _f64(sde.rho(tm))
    w = 3  # warmup steps (n >= 4 guaranteed)
    # F_DDIM(x, eps; s->t) = (mu_t/mu_s) x + mu_t (rho_t - rho_s) eps, for
    # the current->midpoint and current->next transfers of each warmup step
    coeffs = {
        "warm_ratio_m": mu_mid[:w] / mu[:w],
        "warm_coef_m": mu_mid[:w] * (rho_mid[:w] - rho[:w]),
        "warm_ratio_n": mu[1:w + 1] / mu[:w],
        "warm_coef_n": mu[1:w + 1] * (rho[1:w + 1] - rho[:w]),
        "warm_t_mid": tm[:w],
    }
    psi, C0 = C.ab_coefficients(sde, ts, 0, "t")
    Cm = np.zeros((n, 4))
    Cm[w:] = C0[w:, :1] * C.AB_WEIGHTS[3][None, :]
    coeffs.update(psi=psi, C=Cm)
    if error_estimate:
        w_err = np.array(C.AB_WEIGHTS[3], dtype=np.float64, copy=True)
        w_err[:3] -= C.AB_WEIGHTS[2]
        E = np.zeros((n, 4))
        E[w:] = C0[w:, :1] * w_err[None, :]
        coeffs["E"] = E
    return _mk("pndm", coeffs, ts, nfe=n + 9, error_estimate=error_estimate)


# ---------------------------------------------------------------- factory
def solver_stages(name: str) -> int:
    """Network evaluations one grid interval costs for solver ``name`` (the
    RK stage count; 1 for every single-eval-per-step family). Lives next to
    the tableau registry so serving's NFE-budget grid sizing can never drift
    from what ``make_plan`` actually builds."""
    n = name.lower()
    if n == "dpm2":
        return len(_TABLEAUS["midpoint"][0])
    if n.startswith("rho_") and n[4:] in _TABLEAUS:
        return len(_TABLEAUS[n[4:]][0])
    if n.startswith("scire"):
        return int(n[5:] or 2)  # SciRE-r runs r stages per interval
    return 1


def make_plan(name: str, sde: SDE, ts, **kw) -> SolverPlan:
    """Name-based plan factory. Names: ddim, tab{0..3},
    rhoab{0..3}, rho_heun, rho_midpoint, rho_kutta3, rho_rk4, dpm2, euler,
    naive_ei, em, ddim_eta (requires explicit ``eta=``), ipndm{1..3}, pndm,
    dpm{2,3}m (DPM-Solver multistep), seeds{1..3} (exponential SDE solvers,
    stochastic), scire{2,3} (recursive-difference RK; ``rd_m=`` selects the
    phi1 variant), sndeis{1..3} (score-normalized DEIS; ``data_var=`` sets
    the normalization profile).

    ``error_estimate=True`` requests embedded local-error estimates and is
    accepted for EVERY name: families with a genuine lower-order pair
    (order>=1 ab/ipndm, rk, pndm) emit companion coefficients; the rest
    ignore the request (their plans keep ``error_estimate=False``), so a
    serving engine can ask uniformly across mixed traffic.
    """
    n = name.lower()
    ee = bool(kw.pop("error_estimate", False))
    if n in ("ddim", "tab0", "rhoab0"):
        return plan_ab(sde, ts, order=0, basis="t", error_estimate=ee, **kw)
    if n.startswith("tab"):
        return plan_ab(sde, ts, order=int(n[3:]), basis="t",
                       error_estimate=ee, **kw)
    if n.startswith("rhoab"):
        return plan_ab(sde, ts, order=int(n[5:]), basis="rho",
                       error_estimate=ee, **kw)
    if n.startswith("rho_"):
        return plan_rk(sde, ts, method=n[4:], error_estimate=ee)
    if n in ("dpm2m", "dpm3m"):
        return plan_dpm_multistep(sde, ts, order=int(n[3]), error_estimate=ee)
    if n == "dpm2":
        return plan_rk(sde, ts, method="dpm2", error_estimate=ee)
    if n.startswith("seeds"):
        return plan_seeds(sde, ts, order=int(n[5:] or 1))
    if n.startswith("scire"):
        return plan_scire(sde, ts, order=int(n[5:] or 2),
                          rd_m=kw.get("rd_m", 1), error_estimate=ee)
    if n.startswith("sndeis"):
        return plan_sndeis(sde, ts, order=int(n[6:] or 2),
                           basis=kw.get("basis", "t"),
                           data_var=kw.get("data_var", 1.0),
                           error_estimate=ee)
    if n == "euler":
        return plan_euler(sde, ts)
    if n == "naive_ei":
        return plan_ab(sde, ts, order=0, naive_ei=True)
    if n == "em":
        return plan_em(sde, ts, lam=kw.get("lam", 1.0))
    if n == "ddim_eta":
        if "eta" not in kw:
            raise TypeError("make_plan('ddim_eta') requires an explicit eta= "
                            "(eta=0 is deterministic DDIM, eta=1 ancestral)")
        return plan_ddim(sde, ts, eta=kw["eta"])
    if n.startswith("ipndm"):
        order = int(n[5:]) if len(n) > 5 else 3
        return plan_ipndm(sde, ts, order=order, error_estimate=ee)
    if n == "pndm":
        return plan_pndm(sde, ts, error_estimate=ee)
    raise ValueError(f"unknown solver {name!r}")


# ------------------------------------------------- plan coefficient cache
# Plans are pure functions of (solver name, SDE parameters, grid, builder
# kwargs): the float64 host precompute (Vandermonde solves, phi integrals,
# quadrature) is deterministic, and the result is an immutable plan every
# consumer treats as read-only (all splice primitives go through
# dataclasses.replace). Memoizing moves plan construction off the serving
# hot path: an engine's _plan() hits this cache, so admission of a known
# (solver, nfe, eta) costs a dict lookup, not a coefficient solve.

_PLAN_CACHE: dict = {}


def _sde_fingerprint(sde):
    """Hashable identity of an SDE's parameters, or None when the SDE is
    not a plain dataclass (then caching would risk keying on stale state)."""
    if dataclasses.is_dataclass(sde) and not isinstance(sde, type):
        try:
            items = sorted(dataclasses.asdict(sde).items())
        except TypeError:
            return None
        if any(not isinstance(v, (int, float, str, bool, type(None)))
               for _k, v in items):
            return None
        return (type(sde).__name__, tuple(items))
    return None


def cached_make_plan(name: str, sde: SDE, ts, **kw) -> SolverPlan:
    """:func:`make_plan` memoized on ``(family, schedule fingerprint, grid,
    kwargs)``.

    Falls back to an uncached build when the SDE has no stable fingerprint
    (non-dataclass or non-scalar fields). Cached plans are shared objects --
    callers must never mutate them (use ``dataclasses.replace``)."""
    fp = _sde_fingerprint(sde)
    if fp is None:
        return make_plan(name, sde, ts, **kw)
    key = (name.lower(), fp, np.asarray(ts, np.float64).tobytes(),
           tuple(sorted(kw.items())))
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = _PLAN_CACHE[key] = make_plan(name, sde, ts, **kw)
    return plan
