"""The VLM arch (paligemma-3b) in the port against the JAX package, with
the reference's own weights carried over (``params_from_numpy``) on the
reduced float32 config (2 layers, d_model 256, MQA 4/1 heads of 32, an
8-token prefix) and image-patch prefixes (2, 8, 256) drawn with numpy: the
config, the eps forward with the prefix on both routes (and with
``valid_len``), the token forward, the one-shot sampler, prefill with the
prefix and decode at ``cache_index`` S + P, the parameter and checkpoint
layouts, and the launcher, which serves paligemma as a text-only decoder
as the reference's does.

Tolerances: eps, logits and caches at float32 rtol = atol = 1e-5
(summation order); one-shot x0 at rtol = atol = 1e-4 (6 solver steps of
that), tokens equal; prefill-then-decode against one full forward at the
reference's own rule (``tests/test_arch_smoke.py``): rtol 2e-3, atol 2e-3
x max|logit|; round trips byte for byte."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.configs.base import get_config as ref_get_config
from repro.diffusion import lm as RLM
from repro.models import transformer as RT
from repro.training import checkpoint as RC
from repro.training.steps import make_decode_step as ref_decode_step
import repro_torch.core as P
from repro_torch.configs import get_config
from repro_torch.diffusion import lm as PLM
from repro_torch.launch.serve import main
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.serving.engine import ARServeEngine, DiffusionServeEngine, Request
from repro_torch.training import checkpoint as PC
from repro_torch.training.steps import make_decode_step, make_prefill_step

ARCH = "paligemma_3b"
F32 = dict(rtol=1e-5, atol=1e-5)
X0_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(objective="diffusion", dtype="float32"):
    rcfg = ref_get_config(ARCH).reduced().with_(objective=objective, dtype=dtype)
    pcfg = get_config(ARCH).reduced().with_(objective=objective, dtype=dtype)
    rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, pcfg, rp, params_from_numpy(_np(rp), pcfg, "cpu")


@pytest.fixture(scope="module")
def diffusion():
    return _models("diffusion")


@pytest.fixture(scope="module")
def ar():
    return _models("ar")


def _prefix(cfg, b=2, seed=0):
    return np.random.RandomState(seed).randn(b, cfg.prefix_tokens, cfg.d_model).astype(np.float32)


def _tokens(cfg, b, s, seed=1):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s))


def test_config_matches_reference():
    """The published fields this file's paths depend on (every field is
    held against the reference in ``test_torch_configs.py``)."""
    cfg = get_config(ARCH)
    assert (cfg.arch_type, cfg.prefix_tokens, cfg.n_layers, cfg.d_model, cfg.vocab_size) == \
        ("vlm", 256, 18, 2048, 257216)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.tie_embeddings) == (8, 1, 256, True)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_eps_fn_with_prefix_matches_reference(diffusion, use_kernels):
    """``make_eps_fn(prefix=)``: the prefix in front of x at every call,
    the eps sliced to x's positions, against the reference's with
    ``use_pallas`` alike (its kernel route in interpret mode)."""
    rcfg, pcfg, rp, pp = diffusion
    rng = np.random.RandomState(5)
    x = rng.randn(2, 24, pcfg.d_model).astype(np.float32)
    pre = _prefix(pcfg)
    want = RLM.make_eps_fn(rp, rcfg, prefix=jnp.asarray(pre), use_pallas=use_kernels)(
        jnp.asarray(x), jnp.float32(0.4))
    with torch.no_grad():
        got = PLM.make_eps_fn(pp, pcfg, prefix=torch.from_numpy(pre), use_kernels=use_kernels)(
            torch.from_numpy(x), torch.tensor(0.4))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_eps_fn_with_prefix_and_valid_len_matches_reference(diffusion):
    """The served form: ``valid_len`` grows by the prefix (plain route)."""
    rcfg, pcfg, rp, pp = diffusion
    x = np.random.RandomState(6).randn(2, 16, pcfg.d_model).astype(np.float32)
    pre, vl = _prefix(pcfg, seed=6), np.array([16, 11])
    want = RLM.make_eps_fn(rp, rcfg, prefix=jnp.asarray(pre), valid_len=jnp.asarray(vl))(
        jnp.asarray(x), jnp.float32(0.7))
    with torch.no_grad():
        got = PLM.make_eps_fn(pp, pcfg, prefix=torch.from_numpy(pre),
                              valid_len=torch.from_numpy(vl))(torch.from_numpy(x),
                                                              torch.tensor(0.7))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_kernel_route_attends_over_prefix_and_text(diffusion, monkeypatch):
    """K2's wrapper is called once per layer and forward over P + S."""
    _, pcfg, _, pp = diffusion
    calls = []
    real = PL.ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return real(q, k, v, **kw)
    monkeypatch.setattr(PL.ops, "flash_attention", counted)
    with torch.no_grad():
        PLM.make_eps_fn(pp, pcfg, prefix=torch.from_numpy(_prefix(pcfg)), use_kernels=True)(
            torch.zeros(2, 24, pcfg.d_model), torch.tensor(0.5))
    s = pcfg.prefix_tokens + 24
    assert calls == [(2, s, pcfg.n_heads, pcfg.resolved_head_dim)] * pcfg.n_layers


def test_token_forward_with_prefix_matches_reference(ar):
    """``forward(tokens=, prefix=)``: logits over P + S positions."""
    rcfg, pcfg, rp, pp = ar
    tok, pre = _tokens(pcfg, 2, 20), _prefix(pcfg, seed=2)
    want = RT.forward(rp, rcfg, tokens=jnp.asarray(tok), prefix=jnp.asarray(pre))["logits"]
    with torch.no_grad():
        got = PT.forward(pp, pcfg, tokens=torch.from_numpy(tok),
                         prefix=torch.from_numpy(pre))["logits"]
    assert got.shape == (2, pcfg.prefix_tokens + 20, pcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_sample_tokens_matches_reference(diffusion):
    """The one-shot kernel route with a prefix: fused tab3 from the
    reference's own prior (text positions only), the reference on
    ``use_pallas=True``."""
    rcfg, pcfg, rp, pp = diffusion
    sde = R.VPSDE()
    ts = R.get_timesteps(sde, 6, "quadratic")
    pre = _prefix(pcfg, seed=3)
    key = jax.random.PRNGKey(4)
    toks_r, x0_r = RLM.sample_tokens(rp, rcfg, R.make_plan("tab3", sde, ts, fused=True), key,
                                     batch=2, seq_len=16, prior_std=sde.prior_std(),
                                     prefix=jnp.asarray(pre), use_pallas=True)
    k_prior, _ = jax.random.split(key)
    x_T = np.array(jax.random.normal(k_prior, (2, 16, rcfg.d_model), jnp.float32)
                   * sde.prior_std())
    with torch.no_grad():
        toks_p, x0_p = PLM.sample_tokens(
            pp, pcfg, P.make_plan("tab3", P.VPSDE(), ts, fused=True), None, batch=2,
            seq_len=16, prior_std=sde.prior_std(), prefix=torch.from_numpy(pre),
            use_kernels=True, x_T=torch.from_numpy(x_T))
    assert tuple(toks_p.shape) == (2, 16) and tuple(x0_p.shape) == (2, 16, pcfg.d_model)
    np.testing.assert_allclose(x0_p.numpy(), np.asarray(x0_r), **X0_TOL)
    np.testing.assert_array_equal(toks_p.numpy(), np.asarray(toks_r))


def test_prefill_cache_matches_reference(ar):
    """Prefill with the prefix: k and v over P + S positions."""
    rcfg, pcfg, rp, pp = ar
    tok, pre = _tokens(pcfg, 2, 12), _prefix(pcfg, seed=4)
    ref = RT.forward(rp, rcfg, tokens=jnp.asarray(tok), prefix=jnp.asarray(pre), mode="prefill")
    with torch.no_grad():
        logits, cache = make_prefill_step(pcfg)(
            pp, {"tokens": torch.from_numpy(tok), "prefix": torch.from_numpy(pre)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref["logits"][:, -1]), **F32)
    want = params_from_numpy(_np(ref["cache"]), pcfg, "cpu")["blocks"]
    for g, w in zip(cache["blocks"], want):
        assert g["k"].shape[1] == pcfg.prefix_tokens + 12
        for name in ("k", "v"):
            np.testing.assert_allclose(g[name].numpy(), w[name].numpy(), **F32)


def test_decode_step_from_reference_cache(ar):
    """One decode step at ``cache_index`` S + P from the reference's
    prefill cache (padded by 4 slots) against the reference's."""
    rcfg, pcfg, rp, pp = ar
    tok, pre = _tokens(pcfg, 2, 11, seed=7), _prefix(pcfg, seed=7)
    cache = RT.forward(rp, rcfg, tokens=jnp.asarray(tok[:, :10]), prefix=jnp.asarray(pre),
                       mode="prefill")["cache"]
    cache = {"blocks": jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)]), cache["blocks"])}
    pcache = params_from_numpy(_np(cache), pcfg, "cpu")
    index = 10 + pcfg.prefix_tokens
    want_l, want_c = ref_decode_step(rcfg)(rp, cache, jnp.asarray(tok[:, 10:]), jnp.int32(index))
    with torch.no_grad():
        got_l, got_c = make_decode_step(pcfg)(pp, pcache, torch.from_numpy(tok[:, 10:]), index)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **F32)
    want_c = params_from_numpy(_np(want_c), pcfg, "cpu")["blocks"]
    for g, w in zip(got_c["blocks"], want_c):
        for name in ("k", "v"):
            np.testing.assert_allclose(g[name].numpy(), w[name].numpy(), **F32)


def test_prefill_then_decode_matches_full_forward(ar):
    """The reference's KV-cache test on the port (``cache_index`` counts
    the prefix: S + P), then 8 more decode steps against the full forward."""
    _, pcfg, _, pp = ar
    tok, pre = torch.from_numpy(_tokens(pcfg, 2, 40)), torch.from_numpy(_prefix(pcfg, seed=8))
    p, s = pcfg.prefix_tokens, 31
    with torch.no_grad():
        full = PT.forward(pp, pcfg, tokens=tok, prefix=pre, mode="train")["logits"]
        _, pf = make_prefill_step(pcfg)(pp, {"tokens": tok[:, :s], "prefix": pre})
        cache = PT.init_cache(pcfg, 2, p + 40, device="cpu")
        for dst, src in zip(cache["blocks"], pf["blocks"]):
            for name in ("k", "v"):
                dst[name][:, :p + s] = src[name]
        decode = make_decode_step(pcfg)
        for i in range(s, 40):
            logits, cache = decode(pp, cache, tok[:, i:i + 1], p + i)
            a, b = full[:, p + i].numpy(), logits.numpy()
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3 * np.abs(a).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_and_checkpoint_round_trip(tmp_path, dtype):
    """params_to_numpy restacks the reference's tree byte for byte; the
    reference's checkpoint restores in the port bitwise."""
    rcfg, pcfg, rp, pp = _models(dtype=dtype)
    tree = _np(rp)
    back = params_to_numpy(pp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    RC.save(str(tmp_path), 1, rp)
    got, _ = PC.restore(str(tmp_path), PT.init_params(pcfg, 1, "cpu"))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(pp)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_launcher_serves_paligemma_text_only(capsys):
    """``--arch paligemma_3b --reduced --device cpu`` serves one request as
    a text-only decoder (no prefix, as the reference's engine): the printed
    tokens are the engine's; the AR mode serves too."""
    main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "1", "--nfe", "4",
          "--seq-len", "8", "--solver", "tab2"])
    out = capsys.readouterr().out
    assert "served 1 requests" in out
    cfg = get_config(ARCH).reduced().with_(objective="diffusion")
    res = DiffusionServeEngine(PT.init_params(cfg, 0, "cpu"), cfg, device="cpu").serve(
        [Request(uid=0, seq_len=8, nfe=4, solver="tab2", seed=0)])
    assert f"tokens[:10]={res[0].tokens[:10]}" in out
    main(["--arch", ARCH, "--reduced", "--device", "cpu", "--mode", "ar", "--requests", "1",
          "--max-new", "4", "--seq-len", "8"])
    out = capsys.readouterr().out
    cfg = cfg.with_(objective="ar")
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, 8)
    res = ARServeEngine(PT.init_params(cfg, 0, "cpu"), cfg, max_len=12, device="cpu").serve(
        [Request(uid=0, prompt=prompt, max_new_tokens=4)])
    assert "served 1 requests" in out and f"tokens={res[0].tokens[:10]}" in out
