"""The port's train step against the JAX package's, for every arch type
(dense gemma-2b, ssm mamba2-2.7b, moe mixtral-8x7b with its aux losses,
hybrid jamba-1.5-large, encdec whisper-tiny with frames, vlm paligemma-3b
with a prefix) and both objectives, on the reduced float32 configs with
the reference's own weights carried over (``params_from_numpy``), the same
numpy batch from the Markov corpus (``make_batch``) and, for the diffusion
objective, the reference's own ``t`` and ``eps`` draws fed through the
port's ``t=`` / ``eps=`` seam.

Held: the loss and its metrics, every grad (``params_to_numpy`` back to
the reference's layout) and, after one ``train_step``, the updated params,
``m``, ``v``, ``step``, ``grad_norm`` and ``lr``.

Tolerances (float32, summation order): loss and metrics rtol 1e-5; grads
rtol 1e-4 with an absolute floor of 1e-5 x the leaf's max |grad|; the
moments likewise (m is the clipped grad x 0.1, v its square x 0.05). The
updated params are held to the reference's ``AdamW.update`` applied to the
port's own grads, at rtol 1e-6, atol 1e-8: the first AdamW step moves a
weight by lr x g / (|g| + eps), about lr whatever |g|, so against the
reference's own step an entry whose grad is small beside the two
frameworks' summation noise moves by another fraction of lr (1.25e-5 of
lr 1e-3 at most on these weights); the grads themselves are held above."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.configs.base import get_config as ref_get_config
from repro.data.pipeline import MarkovTextSource as RefSource, make_batch as ref_make_batch
from repro.models import transformer as RT
from repro.training import optimizer as RO
from repro.training import steps as RS
import repro_torch.core as P
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.training import optimizer as PO
from repro_torch.training import steps as PS

ARCHS = ["gemma_2b", "mamba2_2p7b", "mixtral_8x7b", "jamba_1p5_large", "whisper_tiny",
         "paligemma_3b"]
LOSS = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
B, S = 2, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(arch, objective):
    rcfg = ref_get_config(arch).reduced().with_(objective=objective)
    pcfg = get_config(arch).reduced().with_(objective=objective)
    rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
    pp = params_from_numpy(_np(rp), pcfg, "cpu")
    batch = ref_make_batch(rcfg, RefSource(rcfg.vocab_size, 0), 3, B, S)
    return rcfg, pcfg, rp, pp, batch


def _ref_draws(rcfg, rp, batch, key):
    """The t and eps the reference's diffusion_loss draws from ``key``."""
    k_t, k_eps = jax.random.split(key)
    sde = R.VPSDE()
    t = jax.random.uniform(k_t, (batch["tokens"].shape[0],), jnp.float32, sde.t0, sde.T)
    shape = batch["tokens"].shape + (rcfg.d_model,)
    eps = jax.random.normal(k_eps, shape, jnp.float32)
    return {"t": torch.from_numpy(np.array(t)), "eps": torch.from_numpy(np.array(eps))}


def _tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _assert_tree_close(got, want, rtol, floor, what):
    """Leaf by leaf (the reference's layout): rtol, with an absolute floor of
    ``floor`` x the leaf's max |want|."""
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g = jax.tree.leaves(got)
    assert len(flat_g) == len(flat_w)
    for (path, w), g in zip(flat_w, flat_g):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        assert g.shape == w.shape, (what, path)
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=floor * scale,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("objective", ["diffusion", "ar"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, objective):
    rcfg, pcfg, rp, pp, batch = _setup(arch, objective)
    key = jax.random.PRNGKey(11)
    rloss_fn = RS.make_loss_fn(rcfg)
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(rloss_fn, has_aux=True))(
        rp, jax.tree.map(jnp.asarray, batch), key)
    draws = _ref_draws(rcfg, rp, batch, key) if objective == "diffusion" else {}
    (ploss, pmet), pgrads = PO.value_and_grad(PS.make_loss_fn(pcfg), pp, _tensors(batch),
                                              has_aux=True, **draws)
    np.testing.assert_allclose(float(ploss), float(rloss), **LOSS)
    assert set(pmet) == set(rmet)
    for k in rmet:
        np.testing.assert_allclose(float(pmet[k]), float(rmet[k]), **LOSS, err_msg=k)
    if arch in ("mixtral_8x7b", "jamba_1p5_large"):   # the MoE aux losses are in it
        main = pmet["loss"] if objective == "ar" else pmet["mse"] + 0.1 * pmet["ce"]
        assert float(ploss) - float(main) > 1e-4
    _assert_tree_close(params_to_numpy(pgrads), rgrads, 1e-4, 1e-5, "grad")


@pytest.mark.parametrize("objective", ["diffusion", "ar"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, objective):
    rcfg, pcfg, rp, pp, batch = _setup(arch, objective)
    key = jax.random.PRNGKey(5)
    ropt = RO.AdamW(RO.cosine_schedule(LR, 2, 10))
    popt = PO.AdamW(PO.cosine_schedule(LR, 2, 10))
    rstate = ropt.init(rp)
    pstate = popt.init(pp)
    pp0 = PO.tree_map(torch.clone, pp)      # train_step updates pp in place
    rp1, rstate1, rmet = jax.jit(RS.make_train_step(rcfg, ropt))(
        rp, rstate, jax.tree.map(jnp.asarray, batch), key)
    draws = _ref_draws(rcfg, rp, batch, key) if objective == "diffusion" else {}
    pp1, pstate1, pmet = PS.make_train_step(pcfg, popt)(pp, pstate, _tensors(batch),
                                                         **draws)
    assert set(pmet) == set(rmet)
    for k in rmet:
        np.testing.assert_allclose(float(pmet[k]), float(rmet[k]), **LOSS, err_msg=k)
    assert int(pstate1.step) == int(rstate1.step) == 1
    _assert_tree_close(params_to_numpy(pstate1.m), rstate1.m, 1e-4, 1e-5, "m")
    _assert_tree_close(params_to_numpy(pstate1.v), rstate1.v, 1e-4, 1e-5, "v")
    # the update's arithmetic: the reference's AdamW on the port's grads
    _, pgrads = PO.value_and_grad(PS.make_loss_fn(pcfg), pp0, _tensors(batch),
                                  has_aux=True, **draws)
    want, _, _ = ropt.update(jax.tree.map(jnp.asarray, params_to_numpy(pgrads)), rstate, rp)
    for g, w in zip(jax.tree.leaves(params_to_numpy(pp1)), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-8)
    # the step moved the weights
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(rp1), jax.tree.leaves(rp)))
    assert moved > 0.5 * LR * 0.5
