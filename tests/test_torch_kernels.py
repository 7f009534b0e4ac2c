"""Kernel K1 (the fused AB step): the port's plain version against the JAX
package's Pallas kernel run in interpret mode, and the port's stacked-vs-
solo invariants. The Triton kernel itself runs only on the card
(``tests/test_torch_cuda.py``).

Tolerance for float32 across the two frameworks: rtol = atol = 1e-6 --
the two may contract multiply-adds into FMAs differently and sum the
history in another order. Within the port, stacked rows are held bitwise."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R_ops
from repro.kernels import ref as R_ref
from repro_torch.core import (VPSDE, get_timesteps, init_state, make_plan,
                              stack_plans, step)
from repro_torch.kernels import deis_step as K
from repro_torch.kernels import ops as P_ops
from repro_torch.kernels import ref as P_ref

TOL = dict(rtol=1e-6, atol=1e-6)
M, D = 70, 33           # odd sizes: ragged blocks on both sides


def _inputs(seed, R, r, noise, err):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    kw = {}
    if noise:
        kw.update(s=rng.uniform(0, 0.2, R).astype(np.float32), noise=f(R, M, D))
    if err:
        kw["err_coeffs"] = f(R, r) * 0.1
    return (f(R, M, D), f(r, R, M, D), rng.uniform(0.5, 1, R).astype(np.float32),
            f(R, r)), kw


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("err", [False, True])
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_fused_ab_step_matches_pallas_interpret(r, noise, err, R):
    args, kw = _inputs(100 * r + 10 * noise + 2 * err + R, R, r, noise, err)
    got, got_err = P_ops.fused_ab_step(*map(torch.from_numpy, args),
                                       **{k: torch.from_numpy(v) for k, v in kw.items()})
    want, want_err = R_ops.fused_ab_step(*map(jnp.asarray, args), interpret=True,
                                         **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if err:
        np.testing.assert_allclose(got_err.numpy(), np.asarray(want_err), **TOL)
    else:
        assert got_err is None and want_err is None
    # a stacked row is bitwise the same row called alone
    targs = [torch.from_numpy(a) for a in args]
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    for i in range(R):
        sl = slice(i, i + 1)
        o_i, e_i = P_ops.fused_ab_step(targs[0][sl], targs[1][:, sl], targs[2][sl],
                                       targs[3][sl], **{k: v[sl] for k, v in tkw.items()})
        assert torch.equal(o_i[0], got[i])
        if err:
            assert torch.equal(e_i[0], got_err[i])


def test_deis_step_matches_reference():
    rng = np.random.RandomState(0)
    x, h = rng.randn(M, D).astype(np.float32), rng.randn(3, M, D).astype(np.float32)
    psi, c = np.float32(0.9), rng.randn(3).astype(np.float32)
    got = P_ops.deis_step(torch.from_numpy(x), torch.from_numpy(h),
                          torch.tensor(psi), torch.from_numpy(c))
    want = R_ops.deis_step(jnp.asarray(x), jnp.asarray(h), jnp.asarray(psi),
                           jnp.asarray(c), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        P_ref.deis_step_ref(torch.from_numpy(x), torch.from_numpy(h),
                            torch.tensor(psi), torch.from_numpy(c)).numpy(),
        np.asarray(R_ref.deis_step_ref(jnp.asarray(x), jnp.asarray(h),
                                       jnp.asarray(psi), jnp.asarray(c))), **TOL)


def test_cpu_operands_take_the_plain_version_and_count_nothing():
    args, kw = _inputs(0, 2, 2, True, True)
    before = K.fused_ab_step.launches
    out, err = K.fused_ab_step(*map(torch.from_numpy, args),
                               **{k: torch.from_numpy(v) for k, v in kw.items()})
    want, want_err = P_ref.fused_ab_step_ref(*map(torch.from_numpy, args),
                                             **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert torch.equal(out, want) and torch.equal(err, want_err)
    assert K.fused_ab_step.launches == before
    with pytest.raises(ValueError, match="device"):
        K.fused_ab_step(torch.zeros(1, 2, 2, device="meta"),
                        torch.zeros(1, 1, 2, 2, device="meta"),
                        torch.zeros(1, device="meta"), torch.zeros(1, 1, device="meta"))


_FUSED_FAMILIES = [("tab2", {}), ("tab3", {}), ("sndeis2", {}),
                   ("seeds2", {}), ("em", {}), ("ddim_eta", {"eta": 0.7})]


@pytest.mark.parametrize("name,kw", _FUSED_FAMILIES)
def test_stacked_fused_bitwise_vs_solo(name, kw):
    """The serving invariant at the sampler level, per family (mirrors the
    reference's test of the same name): a row of a stacked fused group is
    bitwise the same request solved alone through the fused path, with
    per-row generators for the stochastic leaf; the fused path tracks the
    unfused one to float32 round-off."""
    sde = VPSDE()
    base = make_plan(name, sde, get_timesteps(sde, 6, "quadratic"),
                     error_estimate=True, **kw).to("cpu", torch.float32)
    fused = dataclasses.replace(base, fused=True)

    def eps_fn(x, t):
        return torch.tanh(x) * (1.0 + t.reshape((-1,) + (1,) * (x.ndim - 1)))

    R, m, d = 3, 4, 16
    rng = np.random.RandomState(7)
    x_rows = [torch.from_numpy(rng.randn(m, d).astype(np.float32)) for _ in range(R)]

    def solve(plan, rows):
        splan = stack_plans([plan] * len(rows))
        gens = [torch.Generator().manual_seed(100 + i) for i in rows]
        st = init_state(splan, torch.stack([x_rows[i] for i in rows]), gens)
        for k in range(splan.n_steps):
            st = step(splan, k, st, eps_fn)
        return st

    group = solve(fused, list(range(R)))
    for i in range(R):
        solo = solve(fused, [i])
        assert torch.equal(group.x[i], solo.x[0]), f"{name}: stacked row {i} != solo"
        assert torch.equal(group.err[i], solo.err[0])
    unfused = solve(base, list(range(R)))
    np.testing.assert_allclose(group.x.numpy(), unfused.x.numpy(), rtol=1e-5, atol=1e-5)
    if base.error_estimate:
        np.testing.assert_allclose(group.err.numpy(), unfused.err.numpy(),
                                   rtol=1e-5, atol=1e-5)
