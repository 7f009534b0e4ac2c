"""The port's executor against the JAX package's, in float64.

Both run the exact Gaussian-data eps of the same data: the reference's
``repro.diffusion.analytic.GaussianData`` on the JAX side, the port's own
``repro_torch.diffusion.analytic.GaussianData`` on the port's (held to
the reference's at rtol 1e-12 in ``tests/test_torch_paper.py``).
Stochastic names receive the reference's own
noise (its per-step key splits) through the port's ``noise=`` seam. The
only differences left are summation orders, so the final iterates are held
to rtol = 1e-10 (atol 1e-12)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.diffusion.analytic import GaussianData
import repro_torch.core as P
from repro_torch.diffusion.analytic import GaussianData as PortGaussianData

TOL = dict(rtol=1e-10, atol=1e-12)
D = 6
_rng = np.random.RandomState(0)
MEAN, VAR = _rng.randn(D), _rng.uniform(0.5, 1.5, D)


def _eps_pair():
    return (GaussianData(R.VPSDE(), MEAN, VAR).eps_fn(),
            PortGaussianData(P.VPSDE(), MEAN, VAR).eps_fn())


def _plans(name, n, **kw):
    if name == "ddim_eta":
        kw["eta"] = 0.6
    ts = R.get_timesteps(R.VPSDE(), n, "quadratic")
    return (P.make_plan(name, P.VPSDE(), ts, **kw),
            R.make_plan(name, R.VPSDE(), ts, **kw))


def _ref_noise(key, shape, n_steps, stacked_rows=None):
    """The draws the reference's sampler makes from ``key``: split, then a
    normal draw of the iterate's shape, each step (per row when stacked)."""
    out = []
    for _ in range(n_steps):
        if stacked_rows is None:
            key, sub = jax.random.split(key)
            out.append(np.asarray(jax.random.normal(sub, shape, jnp.float64)))
        else:
            ks = jax.vmap(jax.random.split)(key)
            key, sub = ks[:, 0], ks[:, 1]
            out.append(np.asarray(jax.vmap(
                lambda kk: jax.random.normal(kk, shape[1:], jnp.float64))(sub)))
    return [torch.from_numpy(np.array(a)) for a in out]


@pytest.mark.parametrize("name", R.SOLVER_NAMES)
def test_sample_matches_reference(name):
    eps_j, eps_t = _eps_pair()
    pp, pr = _plans(name, 12 if name == "pndm" else 6, error_estimate=True)
    x_T = np.random.RandomState(1).randn(3, D)
    key = jax.random.PRNGKey(5)
    noise = _ref_noise(key, x_T.shape, pp.n_steps) if pp.stochastic else None
    want = np.asarray(R.sample(pr, eps_j, jnp.asarray(x_T), key))
    got = P.sample(pp, eps_t, torch.from_numpy(x_T), noise=noise).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["tab3", "rho_heun", "pndm", "sndeis2", "seeds2"])
def test_stacked_steps_and_err_match_reference(name):
    """Step by step on a stacked group with per-row step vectors: iterate
    and the Linf error estimate agree with the reference after every step."""
    eps_j, eps_t = _eps_pair()
    pp, pr = _plans(name, 8, error_estimate=True)
    rows = 3
    sp, sr = P.stack_plans([pp] * rows), R.stack_plans([pr] * rows)
    x_T = np.random.RandomState(2).randn(rows, D)
    keys = jnp.stack([jax.random.PRNGKey(40 + i) for i in range(rows)])
    noise = (_ref_noise(keys, x_T.shape, sp.n_steps, stacked_rows=rows)
             if sp.stochastic else None)
    st_p = P.init_state(sp, torch.from_numpy(x_T))
    st_r = R.init_state(sr, jnp.asarray(x_T), keys)
    for k in range(sp.n_steps):
        kv = [k] * rows
        st_p = P.step(sp, kv, st_p, eps_t, noise=None if noise is None else noise[k])
        st_r = R.step(sr, jnp.asarray(kv, jnp.int32), st_r, eps_j)
        np.testing.assert_allclose(st_p.x.numpy(), np.asarray(st_r.x), **TOL)
        np.testing.assert_allclose(st_p.err.numpy(), np.asarray(st_r.err), **TOL)


def _det_eps(x, t):
    return torch.tanh(x) * (1.0 + t.reshape((-1,) + (1,) * (x.ndim - 1)))


@pytest.mark.parametrize("name", ["tab2", "pndm", "rho_kutta3", "em"])
def test_per_row_k_matches_scalar_k(name):
    """A uniform per-row k vector is bitwise the scalar k, and a k past the
    grid clamps to its last (padded) step."""
    pp, _ = _plans(name, 6, error_estimate=True)
    sp = P.stack_plans([pp] * 2)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, D))
    gens = lambda: [torch.Generator().manual_seed(s) for s in (1, 2)]
    a, b = P.init_state(sp, x, gens()), P.init_state(sp, x, gens())
    for k in range(sp.n_steps):
        a = P.step(sp, k, a, _det_eps)
        b = P.step(sp, [k, k], b, _det_eps)
        assert torch.equal(a.x, b.x) and torch.equal(a.err, b.err)
    # take_state_rows copies the generators, so both continuations draw alike
    past = P.step(sp, [sp.n_steps + 3, sp.n_steps - 1],
                  P.take_state_rows(a, [0, 1]), _det_eps)
    last = P.step(sp, [sp.n_steps - 1, sp.n_steps - 1],
                  P.take_state_rows(a, [0, 1]), _det_eps)
    assert torch.equal(past.x, last.x)


def test_take_and_join_state_rows_bitwise():
    """Compaction and joining move rows whole (iterate, history, err and
    generator state): a compacted or joined solve continues bitwise like
    the uncompacted one and like the joiner's solo solve."""
    pp, _ = _plans("em", 6)
    sp = P.stack_plans([pp] * 3)
    x = torch.from_numpy(np.random.RandomState(4).randn(3, D))
    gens = lambda seeds: [torch.Generator().manual_seed(s) for s in seeds]
    full = P.init_state(sp, x, gens([7, 8, 9]))
    full = P.step(sp, 0, full, _det_eps)
    part = P.take_state_rows(full, [2, 0])
    for k in range(1, sp.n_steps):
        full = P.step(sp, k, full, _det_eps)
        part = P.step(P.take_rows(sp, [2, 0]), k, part, _det_eps)
    assert torch.equal(part.x, full.x[[2, 0]])

    two = P.stack_plans([pp] * 2)
    vet = P.step(two, 0, P.init_state(two, x[:2], gens([7, 8])), _det_eps)
    new = P.init_state(P.stack_plans([pp]), x[2:], gens([9]))
    joined = P.join_state_rows(vet, new)
    assert torch.equal(joined.x[:2], vet.x) and torch.equal(joined.hist[:, :2], vet.hist)
    plan3 = P.join_rows(two, [pp])
    solo = new
    one = P.stack_plans([pp])
    for k in range(1, sp.n_steps):
        joined = P.step(plan3, [k, k, k - 1], joined, _det_eps)
        solo = P.step(one, [k - 1], solo, _det_eps)
    assert torch.equal(joined.x[2], solo.x[0])


def test_sample_records_trajectory_and_requires_generators():
    pp, pr = _plans("tab1", 5)
    x = torch.from_numpy(np.random.RandomState(5).randn(2, D))
    x0, traj = P.sample(pp, _det_eps, x, hooks=P.Hooks(record_trajectory=True))
    assert traj.shape == (5, 2, D) and torch.equal(traj[-1], x0)
    em, _ = _plans("em", 5)
    with pytest.raises(ValueError, match="generator"):
        P.sample(em, _det_eps, x)
    st = P.sample(em, _det_eps, x, torch.Generator().manual_seed(0))
    assert torch.equal(st, P.sample(em, _det_eps, x, torch.Generator().manual_seed(0)))
    hooked = P.sample(pp, _det_eps, x, hooks=P.Hooks(
        eps_transform=lambda x_, t_, e: 0.0 * e))
    assert torch.isfinite(hooked).all()
    assert dataclasses.is_dataclass(P.Hooks())
