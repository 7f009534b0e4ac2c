"""The port's deprecated ``make_solver`` alias (``repro_torch.core.solvers``)
against its ``make_plan``, mirroring ``tests/test_plan_sampler.py``'s
factory tests, and its solver names against the reference's."""
import numpy as np
import pytest
import torch

from repro.core.solvers import SOLVER_NAMES as REF_NAMES
from repro_torch.core import VPSDE, get_timesteps, make_plan, make_solver, sample
from repro_torch.core.solvers import SOLVER_NAMES

SDE = VPSDE()
TS = get_timesteps(SDE, 8, "quadratic")


def _problem(batch=4, d=3):
    """A Gaussian's exact eps and a prior draw from a seeded numpy state."""
    mean, var = 1.5, 0.25

    def eps(x, t):
        mu, sig = SDE.mu(t), SDE.sigma(t)
        return sig * (x - mu * mean) / (mu ** 2 * var + sig ** 2)
    x_T = torch.from_numpy(np.random.default_rng(0).standard_normal((batch, d))) \
        * SDE.prior_std()
    return eps, x_T


def _kw(name):
    return {"eta": 1.0} if name == "ddim_eta" else {}


def _gen():
    return torch.Generator().manual_seed(0)


def test_solver_names_are_the_reference_s():
    assert SOLVER_NAMES == REF_NAMES


@pytest.mark.parametrize("name", SOLVER_NAMES)
def test_deprecated_make_solver_aliases_make_plan(name):
    """``make_solver`` warns and returns exactly the plan ``make_plan``
    builds, for every solver name, and samples the same."""
    with pytest.deprecated_call():
        legacy = make_solver(name, SDE, TS, **_kw(name))
    plan = make_plan(name, SDE, TS, **_kw(name))
    assert legacy.signature == plan.signature and legacy.nfe == plan.nfe
    assert set(legacy.coeffs) == set(plan.coeffs)
    for k in plan.coeffs:
        torch.testing.assert_close(legacy.coeffs[k], plan.coeffs[k], rtol=0, atol=0)
    eps, x_T = _problem()
    torch.testing.assert_close(sample(legacy, eps, x_T, _gen()), sample(plan, eps, x_T, _gen()),
                               rtol=0, atol=0)


def test_make_solver_translates_fused_update():
    with pytest.deprecated_call():
        legacy = make_solver("tab3", SDE, TS, fused_update=True)
    assert legacy.signature == make_plan("tab3", SDE, TS, fused=True).signature


def test_make_solver_ddim_eta_requires_explicit_eta():
    """Both factories require ``eta`` for ddim_eta."""
    with pytest.raises(TypeError, match="eta"), pytest.deprecated_call():
        make_solver("ddim_eta", SDE, TS)
    with pytest.raises(TypeError, match="eta"):
        make_plan("ddim_eta", SDE, TS)
