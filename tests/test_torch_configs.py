"""The configurations of the port against the JAX package's: the eleven
``ARCH_IDS`` in the reference's order, and the three dense ones that need
no arch code of their own (glm4-9b, GQA 32/2 at head_dim 128;
granite-3-8b, GQA 32/8; cifar10-scorenet, the paper's float32 score
network) held field for field, then through their reduced float32 eps
forward on both routes and their AR logits, with the reference's weights
carried over (``params_from_numpy``).

Tolerance: eps and logits at float32 rtol = atol = 1e-5 (summation
order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS as REF_ARCH_IDS
from repro.configs.base import get_config as ref_get_config
from repro.models import transformer as RT
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy

F32 = dict(rtol=1e-5, atol=1e-5)
DENSE = ["glm4_9b", "granite_3_8b", "cifar10_scorenet"]


def _models(arch, objective):
    rcfg = ref_get_config(arch).reduced().with_(objective=objective)
    pcfg = get_config(arch).reduced().with_(objective=objective)
    rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, pcfg, rp, params_from_numpy(jax.tree.map(np.asarray, rp), pcfg, "cpu")


def test_arch_ids_are_the_references():
    assert ARCH_IDS == REF_ARCH_IDS and len(ARCH_IDS) == 11


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_matches_reference(arch):
    """Every field (the mesh lever ``act_shard_axes`` too), published and
    reduced."""
    for r, p in ((ref_get_config(arch), get_config(arch)),
                 (ref_get_config(arch).reduced(), get_config(arch).reduced())):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_eps_forward_matches_reference(arch, use_kernels):
    rcfg, pcfg, rp, pp = _models(arch, "diffusion")
    rng = np.random.RandomState(3)
    x = rng.randn(2, 24, pcfg.d_model).astype(np.float32)
    t = np.array([0.9, 0.2], np.float32)
    want = RT.forward(rp, rcfg, embeds=jnp.asarray(x), t_cond=jnp.asarray(t),
                      use_pallas=use_kernels)
    with torch.no_grad():
        got = PT.forward(pp, pcfg, embeds=torch.from_numpy(x), t_cond=torch.from_numpy(t),
                         use_kernels=use_kernels)
    np.testing.assert_allclose(got["eps"].numpy(), np.asarray(want["eps"]), **F32)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), **F32)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_ar_logits_match_reference(arch):
    rcfg, pcfg, rp, pp = _models(arch, "ar")
    tok = np.random.RandomState(4).randint(0, pcfg.vocab_size, (2, 20))
    want = RT.forward(rp, rcfg, tokens=jnp.asarray(tok), mode="train")["logits"]
    with torch.no_grad():
        got = PT.forward(pp, pcfg, tokens=torch.from_numpy(tok), mode="train")["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
