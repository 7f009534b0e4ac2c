"""The port's host coefficient engine (SDEs, schedules, DEIS coefficient
tables) against the JAX package's, on the same float64 grids.

Both sides compute in float64 numpy with the same formulas, so every table
is held to 1e-12 (relative and absolute)."""
import jax  # noqa: F401  (the reference package imports it)
import numpy as np
import pytest

from repro.core import coeffs as RC
from repro.core import schedules as RS
from repro.core import sde as RSDE
from repro_torch.core import coeffs as PC
from repro_torch.core import schedules as PS
from repro_torch.core import sde as PSDE

TOL = dict(rtol=1e-12, atol=1e-12)
SDES = ["vp", "ve", "subvp"]
BASES = ["t", "rho", "lambda"]


def _pair(name):
    return RSDE.get_sde(name), PSDE.get_sde(name)


@pytest.mark.parametrize("sde_name", SDES)
def test_sde_primitives_match(sde_name):
    ref, port = _pair(sde_name)
    t = np.linspace(port.t0, port.T, 17)
    for fn in ("mu", "sigma", "rho", "f", "g2"):
        np.testing.assert_allclose(getattr(port, fn)(t), getattr(ref, fn)(t), **TOL)
    rho = port.rho(t)
    np.testing.assert_allclose(port.t_of_rho(rho), ref.t_of_rho(rho), **TOL)
    assert port.prior_std() == pytest.approx(ref.prior_std(), rel=1e-12)


@pytest.mark.parametrize("sde_name", SDES)
@pytest.mark.parametrize("schedule", sorted(PS.SCHEDULES))
def test_timesteps_match(sde_name, schedule):
    ref, port = _pair(sde_name)
    np.testing.assert_allclose(PS.get_timesteps(port, 9, schedule),
                               RS.get_timesteps(ref, 9, schedule), **TOL)


@pytest.mark.parametrize("sde_name", SDES)
@pytest.mark.parametrize("basis", BASES)
def test_ab_coefficients_match(sde_name, basis):
    ref, port = _pair(sde_name)
    ts = RS.get_timesteps(ref, 8, "quadratic")
    for order in range(4):
        psi_p, C_p = PC.ab_coefficients(port, ts, order, basis)
        psi_r, C_r = RC.ab_coefficients(ref, ts, order, basis)
        np.testing.assert_allclose(psi_p, psi_r, **TOL)
        np.testing.assert_allclose(C_p, C_r, **TOL)


@pytest.mark.parametrize("sde_name", SDES)
@pytest.mark.parametrize("basis", BASES)
def test_sn_ab_coefficients_match(sde_name, basis):
    ref, port = _pair(sde_name)
    ts = RS.get_timesteps(ref, 7, "log_rho")
    for order in (1, 2, 3):
        for got, want in zip(PC.sn_ab_coefficients(port, ts, order, basis, 0.7),
                             RC.sn_ab_coefficients(ref, ts, order, basis, 0.7)):
            np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("sde_name", SDES)
def test_closed_form_and_naive_ei_match(sde_name):
    ref, port = _pair(sde_name)
    ts = RS.get_timesteps(ref, 6, "uniform")
    for got, want in zip(PC.naive_ei_coefficients(port, ts),
                         RC.naive_ei_coefficients(ref, ts)):
        np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(PC.eps_norm_profile(port, ts, 0.5),
                               RC.eps_norm_profile(ref, ts, 0.5), **TOL)
    if sde_name == "vp":
        for got, want in zip(PC.ddim_coefficients_vp(port, ts),
                             RC.ddim_coefficients_vp(ref, ts)):
            np.testing.assert_allclose(got, want, **TOL)
    for r, w in RC.AB_WEIGHTS.items():
        np.testing.assert_array_equal(PC.AB_WEIGHTS[r], w)
