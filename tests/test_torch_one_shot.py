"""The whole slice: the port's one-shot generator ``sample_tokens(...,
use_kernels=True)`` against the JAX package's ``sample_tokens(...,
use_pallas=True)`` (its Pallas kernels in interpret mode), with the
reference's weights carried over and the reference's own prior injected
(``x_T``: the normal draw from the first half of its split key), on
``gemma_2b.reduced()`` (attention through K2) and ``mamba2_2p7b.reduced()``
(the scan through K3), with a fused ``tab3`` plan (K1 every step) and an
unfused ``ddim`` plan.

Tolerance: tokens equal; x0 at rtol = atol = 1e-4 (float32 eps-net and
solver round-off accumulated over the steps, as in the serving tests)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.configs.base import get_config as ref_get_config
from repro.diffusion import lm as RLM
from repro.models.transformer import init_params as ref_init
import repro_torch.core as P
from repro_torch.configs import get_config
from repro_torch.diffusion import lm as PLM
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import init_params

X0_TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, SEQ = 2, 24


@pytest.mark.parametrize("solver,fused,n_steps", [("tab3", True, 6), ("ddim", False, 5)])
@pytest.mark.parametrize("arch", ["gemma_2b", "mamba2_2p7b"])
def test_sample_tokens_kernel_route_matches_reference(arch, solver, fused, n_steps):
    rcfg = ref_get_config(arch).reduced().with_(objective="diffusion")
    pcfg = get_config(arch).reduced().with_(objective="diffusion")
    rp = ref_init(rcfg, jax.random.PRNGKey(0))
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), pcfg, "cpu")
    sde = R.VPSDE()
    ts = R.get_timesteps(sde, n_steps, "quadratic")
    rplan = R.make_plan(solver, sde, ts, fused=fused)
    pplan = P.make_plan(solver, P.VPSDE(), ts, fused=fused)
    assert pplan.fused == rplan.fused == fused

    key = jax.random.PRNGKey(3)
    toks_r, x0_r = RLM.sample_tokens(rp, rcfg, rplan, key, batch=BATCH, seq_len=SEQ,
                                     prior_std=sde.prior_std(), use_pallas=True)
    k_prior, _ = jax.random.split(key)
    x_T = np.array(jax.random.normal(k_prior, (BATCH, SEQ, rcfg.d_model), jnp.float32)
                     * sde.prior_std())
    toks_p, x0_p = PLM.sample_tokens(pp, pcfg, pplan, None, batch=BATCH, seq_len=SEQ,
                                     prior_std=sde.prior_std(), use_kernels=True,
                                     x_T=torch.from_numpy(x_T))
    assert tuple(toks_p.shape) == (BATCH, SEQ) and torch.isfinite(x0_p).all()
    np.testing.assert_allclose(x0_p.numpy(), np.asarray(x0_r), **X0_TOL)
    np.testing.assert_array_equal(toks_p.numpy(), np.asarray(toks_r))


def test_sample_tokens_draws_its_prior_from_the_prior_generator():
    """Without ``x_T`` the prior comes from the pair's first generator: the
    same seed gives the same sample, the kernel route agrees with the plain
    route on the CPU (both take the plain versions there), and a
    stochastic plan draws its noise from the second generator."""
    cfg = get_config("mamba2_2p7b").reduced().with_(objective="diffusion")
    params = init_params(cfg, 0, "cpu")
    sde = P.VPSDE()
    plan = dataclasses.replace(P.make_plan("tab2", sde, P.get_timesteps(sde, 4)),
                               fused=True)
    gens = lambda: PLM.request_generators([21], "cpu")[0]
    t1, x1 = PLM.sample_tokens(params, cfg, plan, gens(), batch=1, seq_len=8,
                               prior_std=sde.prior_std())
    t2, x2 = PLM.sample_tokens(params, cfg, plan, gens(), batch=1, seq_len=8,
                               prior_std=sde.prior_std(), use_kernels=True)
    assert torch.equal(x1, x2) and torch.equal(t1, t2)
    g_prior, _ = gens()
    x_T = torch.randn((1, 8, cfg.d_model), generator=g_prior) * sde.prior_std()
    _, x3 = PLM.sample_tokens(params, cfg, plan, None, batch=1, seq_len=8,
                              prior_std=sde.prior_std(), x_T=x_T)
    assert torch.equal(x1, x3)
    em = P.make_plan("em", sde, P.get_timesteps(sde, 4))
    _, y1 = PLM.sample_tokens(params, cfg, em, gens(), batch=1, seq_len=8,
                              prior_std=sde.prior_std())
    _, y2 = PLM.sample_tokens(params, cfg, em, gens(), batch=1, seq_len=8,
                              prior_std=sde.prior_std())
    assert torch.equal(y1, y2) and not torch.equal(y1, x1)
