"""The paper-experiment surface of the port against the JAX package's, in
float64 on the CPU: the analytic oracles (``diffusion/analytic.py``), the
MLP score net and its training step (``diffusion/score_net.py``), the
likelihood (``core/likelihood.py``), CLD's matrix DEIS
(``core/matrix_sde.py``) and ``AdaptiveRK23`` (``core/adaptive.py``).

Tolerances: the oracles' eps, flow and log-density rtol 1e-12 (the same
float64 formulas); CLD's host coefficients 1e-12 (the same numpy code) and
its iterates rtol 1e-10 (matrix products in another order); the score
net's params after 3 training steps on the reference's own draws rtol
1e-6, atol 1e-6, a thousandth of the step lr 1e-3 (a float64 net, but
AdamW updates each param in float32 in both packages, and an entry whose
grad is near AdamW's eps moves by a slightly different fraction of lr:
1.8e-7 at most here), its eps and a tab3 solve through it from the same
params rtol 1e-5, atol 1e-9 (the time features are float32 in both, from
each framework's own sin and cos); the
exact-divergence NLL rtol 1e-9; Hutchinson within the reference test's
0.25 bits/dim of the exact divergence; ``AdaptiveRK23`` the same NFE,
accepted and rejected counts and x0 rtol 1e-9, on a problem whose error
ratios all keep 1e-6 away from the accept threshold 1 (checked)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.core.adaptive as RA
from repro.core.likelihood import nll_bits_per_dim as ref_nll
from repro.core.matrix_sde import (CLD as RCLD, CLDGaussianOracle as RCLDOracle,
                                   cld_ab_coefficients as ref_cld_coeffs,
                                   cld_reference as ref_cld_reference,
                                   cld_sample as ref_cld_sample)
from repro.diffusion import analytic as RAN
from repro.diffusion import score_net as RSN
import repro_torch.core as P
from repro_torch.core.matrix_sde import (CLD, CLDGaussianOracle, cld_ab_coefficients,
                                         cld_reference, cld_sample)
from repro_torch.diffusion import analytic as PAN
from repro_torch.diffusion import score_net as PSN
from repro_torch.training import optimizer as PO

EXACT = dict(rtol=1e-12, atol=1e-14)
D = 5
_rng = np.random.RandomState(0)
MEAN, VAR = _rng.randn(D), _rng.uniform(0.5, 1.5, D)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- analytic
@pytest.mark.parametrize("per_request", [False, True])
def test_gaussian_eps_and_flow(per_request):
    x = np.random.RandomState(1).randn(4, D)
    t = np.array([0.9, 0.5, 0.1, 0.02]) if per_request else np.float64(0.37)
    want = RAN.GaussianData(R.VPSDE(), MEAN, VAR).eps_fn()(jnp.asarray(x), jnp.asarray(t))
    got = PAN.GaussianData(P.VPSDE(), MEAN, VAR).eps_fn()(_t(x), _t(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
    want = RAN.GaussianData(R.VPSDE(), MEAN, VAR).exact_flow(jnp.asarray(x), 1.0, 1e-3)
    got = PAN.GaussianData(P.VPSDE(), MEAN, VAR).exact_flow(_t(x), 1.0, 1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)


@pytest.mark.parametrize("d", [2, 3])
def test_gmm_eps_and_log_prob(d):
    r, p = RAN.default_gmm(R.VPSDE(), d=d), PAN.default_gmm(P.VPSDE(), d=d)
    np.testing.assert_array_equal(r.means, p.means)
    x = np.random.RandomState(2).randn(6, d) * 3
    for t in (0.8, 0.05):
        np.testing.assert_allclose(p.eps_fn()(_t(x), _t(t)).numpy(),
                                   np.asarray(r.eps_fn()(jnp.asarray(x), jnp.asarray(t))),
                                   **EXACT)
    np.testing.assert_allclose(p.log_prob(_t(x)).numpy(), np.asarray(r.log_prob(jnp.asarray(x))),
                               **EXACT)


def test_gmm_sample_data_draws_the_mixture():
    gmm = PAN.default_gmm(P.VPSDE(), d=2)
    x = gmm.sample_data(torch.Generator().manual_seed(0), 4000)
    assert x.shape == (4000, 2) and x.dtype == torch.float32
    nearest = torch.cdist(x.double(), torch.from_numpy(gmm.means)).argmin(-1)
    counts = torch.bincount(nearest, minlength=8).double() / 4000
    assert (counts - 1 / 8).abs().max() < 0.03
    resid = x.double() - torch.from_numpy(gmm.means)[nearest]
    assert abs(resid.var().item() - 0.09) < 0.01


# --------------------------------------------------------------- score net
def test_train_score_net_steps_match_reference():
    """3 steps of the reference's ``train_score_net`` against the port's
    step on the same initial params and the same draws (the reference's
    own key splits)."""
    sde_r, sde_p = R.VPSDE(), P.VPSDE()
    gmm = RAN.default_gmm(sde_r, d=2)
    steps, batch, lr = 3, 64, 1e-3
    want = RSN.train_score_net(sde_r, lambda k, n: gmm.sample_data(k, n), 2, steps=steps,
                               batch=batch, lr=lr, hidden=32, depth=2, seed=0).params
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(lambda a: _t(a), RSN.init_mlp_score_net(key, 2, 32, 2))
    opt = PO.AdamW(PO.cosine_schedule(lr, steps // 20, steps), weight_decay=1e-4)
    state = opt.init(params)
    step = PSN.make_score_step(sde_p, opt)
    for _ in range(steps):
        key, sub = jax.random.split(key)
        k1, k2, k3 = jax.random.split(sub, 3)
        x0 = gmm.sample_data(k1, batch)
        t = jax.random.uniform(k2, (batch,), jnp.float32, sde_r.t0, sde_r.T)
        eps = jax.random.normal(k3, x0.shape)
        params, state, loss = step(params, state, _t(x0), _t(t), _t(eps))
        assert torch.isfinite(loss)
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda v: v.numpy(), params)),
                    jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-3 * lr)
    # the trained net as an eps function of the samplers, on the same params
    params = jax.tree.map(lambda a: _t(a), want)
    x = np.random.RandomState(3).randn(16, 2)
    eps_r = RSN.TrainedScoreModel(want, sde_r).eps_fn()
    eps_p = PSN.TrainedScoreModel(params, sde_p).eps_fn()
    np.testing.assert_allclose(eps_p(_t(x), _t(0.4)).numpy(),
                               np.asarray(eps_r(jnp.asarray(x), jnp.asarray(0.4))), rtol=1e-5,
                               atol=1e-9)
    ts = R.get_timesteps(sde_r, 10, "quadratic")
    got = P.sample(P.make_plan("tab3", sde_p, ts), eps_p, _t(x))
    ref = R.sample(R.make_plan("tab3", sde_r, ts), eps_r, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-9)


def test_train_score_net_runs_and_learns():
    sde = P.VPSDE()
    gmm = PAN.default_gmm(sde, d=2)
    losses = []
    model = PSN.train_score_net(sde, gmm.sample_data, 2, steps=60, batch=128, hidden=32,
                                depth=2, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(5)
    x0 = gmm.sample_data(gen, 512)
    for params in (PSN.init_mlp_score_net(torch.Generator().manual_seed(1), 2, 32, 2),
                   model.params):
        t = torch.full((512,), 0.5)
        eps = torch.randn(x0.shape, generator=gen)
        xt = float(sde.mu(0.5)) * x0 + float(sde.sigma(0.5)) * eps
        losses.append(float(((PSN.mlp_score_apply(params, xt, t) - eps) ** 2).mean()))
    assert losses[1] < 0.8 * losses[0], losses


# -------------------------------------------------------------- likelihood
def test_nll_exact_divergence_matches_reference():
    g_r = RAN.GaussianData(R.VPSDE(), np.full(2, 1.0), np.full(2, 0.5))
    g_p = PAN.GaussianData(P.VPSDE(), np.full(2, 1.0), np.full(2, 0.5))
    x0 = np.array([[1.2, 0.8], [0.5, 1.5], [1.0, 1.0]])
    want = ref_nll(R.VPSDE(), g_r.eps_fn(), jnp.asarray(x0), n_steps=8)
    got = P.nll_bits_per_dim(P.VPSDE(), g_p.eps_fn(), _t(x0), n_steps=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    gmm_r, gmm_p = RAN.default_gmm(R.VPSDE()), PAN.default_gmm(P.VPSDE())
    x0 = np.random.RandomState(4).randn(5, 2) * 3
    want = ref_nll(R.VPSDE(), gmm_r.eps_fn(), jnp.asarray(x0), n_steps=6, method="rk4")
    got = P.nll_bits_per_dim(P.VPSDE(), gmm_p.eps_fn(), _t(x0), n_steps=6, method="rk4")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)


def test_nll_gmm_converges_with_steps():
    gmm = PAN.default_gmm(P.VPSDE(), d=2)
    x0 = gmm.sample_data(torch.Generator().manual_seed(0), 24).double()
    exact = float(-gmm.log_prob(x0).mean() / 2 / np.log(2.0))
    errs = [abs(float(P.nll_bits_per_dim(P.VPSDE(), gmm.eps_fn(), x0, n_steps=n,
                                         method="kutta3").mean()) - exact)
            for n in (8, 16, 32)]
    assert errs[2] < errs[0] and errs[2] < 0.02, errs


def test_nll_hutchinson_close_to_exact_divergence():
    gmm = PAN.default_gmm(P.VPSDE(), d=2)
    x0 = gmm.sample_data(torch.Generator().manual_seed(1), 8).double()
    a = P.nll_bits_per_dim(P.VPSDE(), gmm.eps_fn(), x0, n_steps=12, exact_div=True)
    b = P.nll_bits_per_dim(P.VPSDE(), gmm.eps_fn(), x0, n_steps=12, exact_div=False,
                           gen=torch.Generator().manual_seed(2), n_probes=64)
    assert float((a - b).abs().mean()) < 0.25
    b2 = P.nll_bits_per_dim(P.VPSDE(), gmm.eps_fn(), x0, n_steps=12, exact_div=False,
                            gen=torch.Generator().manual_seed(2), n_probes=64)
    assert torch.equal(b, b2)           # the probes come from the generator alone


# --------------------------------------------------------------------- CLD
@pytest.fixture(scope="module")
def clds():
    return RCLD(), CLD()


def test_cld_host_arithmetic_matches_reference(clds):
    rc, pc = clds
    np.testing.assert_allclose(pc._sigma_grid, rc._sigma_grid, rtol=1e-12, atol=1e-12)
    ts = np.linspace(pc.T, pc.t0, 9)
    for order in (0, 1, 2):
        psi_r, c_r = ref_cld_coeffs(rc, ts, order)
        psi_p, c_p = cld_ab_coefficients(pc, ts, order)
        np.testing.assert_allclose(psi_p, psi_r, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(c_p, c_r, rtol=1e-12, atol=1e-12)


def test_cld_sample_and_reference_match(clds):
    rc, pc = clds
    orc_r, orc_p = RCLDOracle(rc, mean=1.0, var=0.25), CLDGaussianOracle(pc, mean=1.0, var=0.25)
    m_t, s_t = orc_r._moments(1.0)
    z_T = m_t + np.random.RandomState(0).randn(16, 2) @ np.linalg.cholesky(s_t).T
    ts = np.linspace(pc.T, pc.t0, 9)
    for order in (0, 2):
        want = ref_cld_sample(rc, ts, order, orc_r.eps_fn(), jnp.asarray(z_T))
        got = cld_sample(pc, ts, order, orc_p.eps_fn(), _t(z_T))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
    want = ref_cld_reference(rc, orc_r.eps_fn(), jnp.asarray(z_T), n_steps=100)
    got = cld_reference(pc, orc_p.eps_fn(), _t(z_T), n_steps=100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------- AdaptiveRK23
@pytest.mark.parametrize("tol", [1e-2, 1e-4])
def test_adaptive_rk23_matches_reference(tol, monkeypatch):
    ratios = []
    real = RA.error_ratio
    monkeypatch.setattr(RA, "error_ratio", lambda *a: ratios.append(real(*a)) or ratios[-1])
    x_T = np.random.RandomState(5).randn(3, D)
    res_r = RA.AdaptiveRK23(R.VPSDE(), rtol=tol, atol=tol).solve(
        RAN.GaussianData(R.VPSDE(), MEAN, VAR).eps_fn(), jnp.asarray(x_T))
    assert min(abs(r - 1.0) for r in ratios) > 1e-6
    res_p = P.AdaptiveRK23(P.VPSDE(), rtol=tol, atol=tol).solve(
        PAN.GaussianData(P.VPSDE(), MEAN, VAR).eps_fn(), _t(x_T))
    assert (res_p.nfe, res_p.n_accepted, res_p.n_rejected) == \
        (res_r.nfe, res_r.n_accepted, res_r.n_rejected)
    assert res_p.state.k == res_p.n_accepted and res_p.state.hist.shape == (0, 3, D)
    np.testing.assert_allclose(res_p.x0.numpy(), np.asarray(res_r.x0), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(res_p.state.err), float(res_r.state.err), rtol=1e-6)
