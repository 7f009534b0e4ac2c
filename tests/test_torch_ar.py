"""Autoregressive serving: the port's token forward, prefill cache, decode
step and ``ARServeEngine`` against the JAX package's, with the reference's
own weights carried over (``params_from_numpy``), on the reduced float32
configs of gemma-2b (MQA), mamba2-2.7b (the SSM decode cache),
h2o-danube-3-4b (GQA, sliding window 16: the KV ring), mixtral-8x7b (MoE
behind a window-16 ring) and jamba-1.5-large (8 layers, attention at
layer 4: a cache of both kinds). MoE runs at capacity_factor 100, as in
the reference's own cache test: a decode step (S 1) drops no (token,
choice) pair, while a full forward at capacity 1.25 would.

Tolerances: across frameworks, logits and caches at rtol = atol = 1e-5
(float32 matmul summation order); greedy tokens equal. Within the port,
prefill-then-decode against the full forward at the reference's own
tolerances (``tests/test_arch_smoke.py``): rtol 2e-3 and atol 2e-3 x
max|logit| (1e-3 for the ring)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.models import transformer as RT
from repro.serving.engine import ARServeEngine as RefAREngine
from repro.serving.engine import Request as RefRequest
from repro.training.steps import make_decode_step as ref_decode_step
from repro_torch.configs import get_config
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import ARServeEngine, Request
from repro_torch.training.steps import make_decode_step, make_prefill_step

F32 = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["gemma_2b", "mamba2_2p7b", "h2o_danube_3_4b", "mixtral_8x7b", "jamba_1p5_large"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(arch):
    rcfg = ref_get_config(arch).reduced().with_(objective="ar")
    pcfg = get_config(arch).reduced().with_(objective="ar")
    if pcfg.moe is not None:
        rcfg = rcfg.with_(moe=dataclasses.replace(rcfg.moe, capacity_factor=100.0))
        pcfg = pcfg.with_(moe=dataclasses.replace(pcfg.moe, capacity_factor=100.0))
    rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
    pp = params_from_numpy(_np(rp), pcfg, "cpu")
    return rcfg, pcfg, rp, pp


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param)


def _tokens(cfg, b, s, seed=1):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s))


def test_h2o_config_matches_reference():
    rcfg, pcfg = ref_get_config("h2o_danube_3_4b"), get_config("h2o_danube_3_4b")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab_size", "act", "sliding_window", "rope_theta"):
        assert getattr(pcfg, f) == getattr(rcfg, f), f
    assert pcfg.reduced().sliding_window == rcfg.reduced().sliding_window == 16


def test_forward_logits_from_tokens(models):
    rcfg, pcfg, rp, pp = models
    tok = _tokens(pcfg, 2, 24)
    want = RT.forward(rp, rcfg, tokens=jnp.asarray(tok), mode="train")["logits"]
    got = PT.forward(pp, pcfg, tokens=torch.from_numpy(tok), mode="train")["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("s", [12, 40])
def test_prefill_cache_matches_reference(models, s):
    """Post-RoPE k and v (a ring of 16 slots for h2o at 40 tokens) and the
    ssm conv history and state, layer by layer."""
    rcfg, pcfg, rp, pp = models
    tok = _tokens(pcfg, 2, s, seed=s)
    ref = RT.forward(rp, rcfg, tokens=jnp.asarray(tok), mode="prefill")
    out = PT.forward(pp, pcfg, tokens=torch.from_numpy(tok), mode="prefill")
    want = params_from_numpy(_np(ref["cache"]), pcfg, "cpu")["blocks"]
    got = out["cache"]["blocks"]
    assert len(got) == pcfg.n_layers
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in g:
            assert g[name].shape == w[name].shape, name
            np.testing.assert_allclose(g[name].numpy(), w[name].numpy(), **F32)
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(ref["logits"]), **F32)


def test_init_cache_matches_reference(models):
    rcfg, pcfg, rp, pp = models
    want = params_from_numpy(_np(RT.init_cache(rcfg, 3, 48)), pcfg, "cpu")["blocks"]
    got = PT.init_cache(pcfg, 3, 48, device="cpu")["blocks"]
    for g, w in zip(got, want):
        assert {k: (tuple(v.shape), v.dtype) for k, v in g.items()} == \
            {k: (tuple(v.shape), v.dtype) for k, v in w.items()}
        assert all(not v.any() for v in g.values())


@pytest.mark.parametrize("s,index", [(12, 12), (40, 40), (7, 20)])
def test_decode_step_from_reference_cache(models, s, index):
    """One decode step of the port from the reference's prefill cache
    (converted, padded to 48 slots where the reference's engine pads)
    against the reference's decode step: logits and the new caches."""
    rcfg, pcfg, rp, pp = models
    tok = _tokens(pcfg, 2, s + 1, seed=3 + s)
    cache = RT.forward(rp, rcfg, tokens=jnp.asarray(tok[:, :s]), mode="prefill")["cache"]
    w = rcfg.sliding_window

    def grow(path, leaf):
        name = jax.tree_util.keystr(path)
        if (name.endswith("['k']") or name.endswith("['v']")) and \
                not (w and leaf.shape[2] == w):
            pad = [(0, 0)] * leaf.ndim
            pad[2] = (0, 48 - leaf.shape[2])
            return jnp.pad(leaf, pad)
        return leaf

    cache = {"blocks": jax.tree_util.tree_map_with_path(grow, cache["blocks"])}
    pcache = params_from_numpy(_np(cache), pcfg, "cpu")
    want_l, want_c = ref_decode_step(rcfg)(rp, cache, jnp.asarray(tok[:, s:]), jnp.int32(index))
    with torch.no_grad():
        got_l, got_c = make_decode_step(pcfg)(pp, pcache, torch.from_numpy(tok[:, s:]), index)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **F32)
    want_c = params_from_numpy(_np(want_c), pcfg, "cpu")["blocks"]
    for g, wc in zip(got_c["blocks"], want_c):
        for name in g:
            np.testing.assert_allclose(g[name].numpy(), wc[name].numpy(), **F32)


def test_prefill_then_decode_matches_full_forward(models):
    """The reference's KV-cache test (``test_arch_smoke.py``) on the port:
    the decode logits equal the full forward's at the last position."""
    rcfg, pcfg, rp, pp = models
    tok = torch.from_numpy(_tokens(pcfg, 2, 32))
    s = 31
    with torch.no_grad():
        full = PT.forward(pp, pcfg, tokens=tok, mode="train")["logits"][:, -1]
        pf = PT.forward(pp, pcfg, tokens=tok[:, :s], mode="prefill")
        w = pcfg.sliding_window
        blocks = [{k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1))
                   if k in ("k", "v") and not (w and v.shape[1] == w) else v
                   for k, v in c.items()} for c in pf["cache"]["blocks"]]
        dec = PT.forward(pp, pcfg, tokens=tok[:, s:], mode="decode",
                         cache={"blocks": blocks}, cache_index=s)["logits"][:, -1]
    a, b = full.numpy(), dec.numpy()
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3 * np.abs(a).max())


def test_swa_ring_buffer_decode_matches_full():
    """The reference's ring test: window 16, a 40-token prompt, one decode."""
    _, pcfg, _, pp = _models("h2o_danube_3_4b")
    assert pcfg.sliding_window == 16
    tok = torch.from_numpy(_tokens(pcfg, 1, 41, seed=5))
    s = 40
    with torch.no_grad():
        full = PT.forward(pp, pcfg, tokens=tok, mode="train")["logits"][:, -1]
        pf = PT.forward(pp, pcfg, tokens=tok[:, :s], mode="prefill")
        assert pf["cache"]["blocks"][0]["k"].shape[1] == 16
        dec = PT.forward(pp, pcfg, tokens=tok[:, s:], mode="decode",
                         cache=pf["cache"], cache_index=s)["logits"][:, -1]
    np.testing.assert_allclose(full.numpy(), dec.numpy(), rtol=2e-3, atol=1e-3)


def test_prefill_step_returns_last_logits():
    _, pcfg, _, pp = _models("gemma_2b")
    tok = torch.from_numpy(_tokens(pcfg, 2, 9))
    with torch.no_grad():
        logits, cache = make_prefill_step(pcfg)(pp, {"tokens": tok})
        full = PT.forward(pp, pcfg, tokens=tok, mode="train")["logits"]
    torch.testing.assert_close(logits, full[:, -1], rtol=0, atol=0)
    assert cache["blocks"][0]["k"].shape == (2, 9, pcfg.n_kv_heads, pcfg.resolved_head_dim)


def test_ar_engine_tokens_equal_reference(models):
    """Greedy tokens of the port's ARServeEngine equal the reference's on
    the same weights and prompts (prompt lengths below, at and above the
    ring's 16 slots; none equals an ssm leaf's axis, which the reference's
    engine would pad)."""
    rcfg, pcfg, rp, pp = models
    rng = np.random.RandomState(4)
    lens, news = [5, 16, 20, 9], [6, 4, 8, 1]
    prompts = [rng.randint(0, pcfg.vocab_size, n) for n in lens]
    want = RefAREngine(rp, rcfg, max_len=32).serve(
        [RefRequest(uid=i, prompt=p, max_new_tokens=m)
         for i, (p, m) in enumerate(zip(prompts, news))])
    got = ARServeEngine(pp, pcfg, max_len=32, device="cpu").serve(
        [Request(uid=i, prompt=p, max_new_tokens=m)
         for i, (p, m) in enumerate(zip(prompts, news))])
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert len(g.tokens) == len(w.tokens)
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
        assert g.latency_s > 0


def test_ar_engine_defaults_to_cuda():
    """No device given means CUDA: without a card it raises, with one the
    CPU params are refused (no silent CPU fallback)."""
    _, pcfg, _, pp = _models("gemma_2b")
    with pytest.raises((RuntimeError, ValueError), match="CUDA|lie on"):
        ARServeEngine(pp, pcfg)
