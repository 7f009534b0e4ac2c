"""The port's optimizer, schedules, cross-entropy and remat against the JAX
package's (``repro.training.optimizer`` / ``steps``).

* AdamW, 3 steps with weight decay 0.5 from the same grads, on the reduced
  float32 gemma-2b (every leaf drawn N(0, 1), so the per-layer norms are
  nonzero and their decay shows: the reference decays every leaf under
  ``blocks``, each stacked on a block axis there, and not the top-level
  vectors) and on the MLP score net (whose ``layers`` list is not
  stacked: its biases are not decayed): params, ``m``, ``v`` and
  ``step`` at rtol 1e-6, atol 1e-7 (float32 elementwise arithmetic, the
  order of operations kept);
* the schedules and ``global_norm`` at rtol 1e-6;
* ``cross_entropy`` in both ``ce_mode``\\ s at rtol 1e-6;
* ``remat`` False / "block" / True / "loss": the same loss (rtol 1e-6) and
  grads (rtol 1e-5, atol 1e-7) on the port, each against the reference's
  same mode within the train-step tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.diffusion import score_net as RSN
from repro.models import transformer as RT
from repro.training import optimizer as RO
from repro.training import steps as RS
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.training import optimizer as PO
from repro_torch.training import steps as PS

ELEM = dict(rtol=1e-6, atol=1e-7)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _randomised(tree, seed):
    """Every leaf of a (reference) tree replaced by N(0, 1) float32 draws."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), _np(tree))


def _run_adamw(ref_params, port_params, to_port, to_ref, steps=3):
    """3 AdamW steps in both packages from the same grads (drawn N(0, 1) per
    step in the reference's layout); returns (reference, port) states."""
    kw = dict(weight_decay=0.5, clip_norm=5.0)
    ropt = RO.AdamW(RO.cosine_schedule(1e-2, 1, 5), **kw)
    popt = PO.AdamW(PO.cosine_schedule(1e-2, 1, 5), **kw)
    rp = jax.tree.map(jnp.asarray, ref_params)
    rs = ropt.init(rp)
    pp, ps = port_params, popt.init(port_params)
    for i in range(steps):
        g = _randomised(ref_params, 100 + i)
        rp, rs, rm = ropt.update(jax.tree.map(jnp.asarray, g), rs, rp)
        pp, ps, pm = popt.update(to_port(g), ps, pp)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), **ELEM)
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]), **ELEM)
    for a, b in zip(jax.tree.leaves(to_ref(pp)), jax.tree.leaves(rp)):
        np.testing.assert_allclose(a, np.asarray(b), **ELEM)
    assert int(ps.step) == int(rs.step) == steps
    for mine, theirs in ((ps.m, rs.m), (ps.v, rs.v)):
        for a, b in zip(jax.tree.leaves(to_ref(mine)), jax.tree.leaves(theirs)):
            np.testing.assert_allclose(a, np.asarray(b), **ELEM)
    return rp, pp


def test_adamw_weight_decay_on_stacked_block_vectors():
    rcfg = ref_get_config("gemma_2b").reduced()
    pcfg = get_config("gemma_2b").reduced()
    ref_params = _randomised(RT.init_params(rcfg, jax.random.PRNGKey(0)), 0)
    port_params = params_from_numpy(ref_params, pcfg, "cpu")
    to_port = lambda g: params_from_numpy(g, pcfg, "cpu")
    rp, pp = _run_adamw(ref_params, port_params, to_port, params_to_numpy)
    # the per-layer norms are decayed (2-D in the reference), final_norm is not
    assert pp["blocks"][0]["norm1"].ndim == 1
    assert np.asarray(rp["blocks"]["slot0"]["norm1"]).ndim == 2


def test_adamw_on_the_score_net():
    ref_params = _np(RSN.init_mlp_score_net(jax.random.PRNGKey(0), 2, hidden=16, depth=2))
    to_port = lambda g: jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), g)
    port_params = to_port(ref_params)
    ref_params = jax.tree.map(lambda a: np.asarray(a, np.float32), ref_params)
    to_ref = lambda t: jax.tree.map(lambda a: a.numpy(), t)
    _run_adamw(ref_params, port_params, to_port, to_ref)


def test_schedules_match_reference():
    rcos, pcos = RO.cosine_schedule(1e-3, 10, 100), PO.cosine_schedule(1e-3, 10, 100)
    for step in (0, 1, 5, 10, 11, 37, 55, 99, 100, 140):
        np.testing.assert_allclose(float(pcos(step)), float(rcos(step)), rtol=1e-6)
        np.testing.assert_allclose(float(pcos(torch.tensor(step, dtype=torch.int32))),
                                   float(rcos(step)), rtol=1e-6)
    assert float(pcos(0)) == 0.0
    assert float(PO.constant_schedule(3e-4)(7)) == float(RO.constant_schedule(3e-4)(7))


def test_global_norm_matches_reference():
    rng = np.random.RandomState(4)
    tree = {"a": rng.randn(3, 4).astype(np.float32),
            "b": [rng.randn(5).astype(np.float32), rng.randn(2, 2).astype(np.float32)]}
    want = float(RO.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(PO.global_norm(jax.tree.map(torch.from_numpy, tree)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_grad_clip_bounds_update():
    opt = PO.AdamW(PO.constant_schedule(1.0), clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    _, state, m = opt.update({"w": torch.full((4,), 1e6)}, state, params)
    assert float(m["grad_norm"]) == pytest.approx(2e6, rel=1e-3)
    assert torch.isfinite(params["w"]).all() and int(state.step) == 1


@pytest.mark.parametrize("ce_mode", ["gather", "onehot"])
def test_cross_entropy_modes_match_reference(ce_mode):
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 7, 50) * 3).astype(np.float32)
    targets = rng.randint(0, 50, (3, 7)).astype(np.int32)
    rcfg = ref_get_config("gemma_2b").reduced().with_(ce_mode=ce_mode)
    pcfg = get_config("gemma_2b").reduced().with_(ce_mode=ce_mode)
    want = float(RS.cross_entropy(jnp.asarray(logits), jnp.asarray(targets), rcfg))
    got = float(PS.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets), pcfg))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    other = PS.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                             pcfg.with_(ce_mode="gather" if ce_mode == "onehot" else "onehot"))
    np.testing.assert_allclose(float(other), got, rtol=1e-6)


@pytest.fixture(scope="module")
def remat_case():
    rcfg = ref_get_config("mixtral_8x7b").reduced().with_(objective="diffusion")
    pcfg = get_config("mixtral_8x7b").reduced().with_(objective="diffusion")
    rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
    pp = params_from_numpy(_np(rp), pcfg, "cpu")
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, rcfg.vocab_size, (2, 12)).astype(np.int32)
    t = np.array([0.3, 0.8], np.float32)
    eps = rng.randn(2, 12, rcfg.d_model).astype(np.float32)
    base = PO.value_and_grad(PS.make_loss_fn(pcfg), pp, {"tokens": torch.from_numpy(tokens)},
                             has_aux=True, t=torch.from_numpy(t), eps=torch.from_numpy(eps))
    return rcfg, pcfg, rp, pp, tokens, t, eps, base


@pytest.mark.parametrize("remat", ["block", True, "loss"])
def test_remat_gives_the_same_loss_and_grads(remat_case, remat):
    rcfg, pcfg, rp, pp, tokens, t, eps, ((loss0, _), grads0) = remat_case
    (loss, _), grads = PO.value_and_grad(
        PS.make_loss_fn(pcfg, remat=remat), pp, {"tokens": torch.from_numpy(tokens)},
        has_aux=True, t=torch.from_numpy(t), eps=torch.from_numpy(eps))
    np.testing.assert_allclose(float(loss), float(loss0), rtol=1e-6)
    for a, b in zip(PO.tree_leaves(grads), PO.tree_leaves(grads0)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    # and the reference's same mode, fed its own draws of t and eps
    key = jax.random.PRNGKey(3)
    k_t, k_eps = jax.random.split(key)
    rt = jax.random.uniform(k_t, (2,), jnp.float32, 1e-3, 1.0)
    reps = jax.random.normal(k_eps, (2, 12, rcfg.d_model), jnp.float32)
    (rl, _), rg = jax.jit(jax.value_and_grad(RS.make_loss_fn(rcfg, remat=remat),
                                             has_aux=True))(
        rp, {"tokens": jnp.asarray(tokens)}, key)
    (pl, _), pg = PO.value_and_grad(
        PS.make_loss_fn(pcfg, remat=remat), pp, {"tokens": torch.from_numpy(tokens)},
        has_aux=True, t=torch.from_numpy(np.array(rt)), eps=torch.from_numpy(np.array(reps)))
    np.testing.assert_allclose(float(pl), float(rl), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(params_to_numpy(pg)), jax.tree.leaves(rg)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                   atol=1e-5 * float(np.abs(np.asarray(b)).max()))


def test_remat_loss_draws_as_the_plain_loss():
    """remat="loss" draws t and eps before its checkpoint, in
    diffusion_loss's order, so a generator gives the same loss as without
    remat."""
    pcfg = get_config("gemma_2b").reduced().with_(objective="diffusion")
    from repro_torch.models.transformer import init_params
    pp = init_params(pcfg, 0, "cpu")
    batch = {"tokens": torch.randint(0, pcfg.vocab_size, (2, 8),
                                     generator=torch.Generator().manual_seed(0))}
    losses = []
    for remat in (False, "loss"):
        gen = torch.Generator().manual_seed(9)
        (loss, _), _ = PO.value_and_grad(PS.make_loss_fn(pcfg, remat=remat), pp, batch, gen,
                                         has_aux=True)
        losses.append(float(loss))
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)


def test_remat_refuses_the_cached_modes():
    pcfg = get_config("gemma_2b").reduced().with_(objective="ar")
    from repro_torch.models import transformer as PT
    pp = PT.init_params(pcfg, 0, "cpu")
    with pytest.raises(ValueError, match="train mode"):
        PT.forward(pp, pcfg, tokens=torch.zeros((1, 4), dtype=torch.long), mode="prefill",
                   remat=True)
