"""The encoder-decoder arch (whisper-tiny) in the port against the JAX
package, with the reference's own weights carried over
(``params_from_numpy``) on the reduced float32 config (2 decoder and 2
encoder layers, d_model 256, 4 heads of 32) and encoder frames (2, 32, 256)
drawn with numpy: the config, cross-attention, the eps forward on both
routes, the one-shot sampler, the prefill cache with its cross k and v,
decode against that cache, the parameter and checkpoint layouts, and the
clear error of the launcher and both engines (they take no frames).

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
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.training import checkpoint as RC
from repro.training.steps import make_decode_step as ref_decode_step
import repro_torch.core as P
from repro_torch.configs import get_config
from repro_torch.diffusion import lm as PLM
from repro_torch.launch.serve import main
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.convert import layers_per_block, params_from_numpy, params_to_numpy
from repro_torch.serving.engine import ARServeEngine, DiffusionServeEngine
from repro_torch.training import checkpoint as PC
from repro_torch.training.steps import make_decode_step, make_prefill_step

ARCH = "whisper_tiny"
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


def _frames(cfg, b=2, seed=0):
    return np.random.RandomState(seed).randn(b, cfg.encoder_seq, cfg.d_model).astype(np.float32)


def _tokens(cfg, b, s, seed=1):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s))


def _cross(ref_cache):
    """The reference's stacked cross cache {k, v} (n_blocks, B, F, KV, D)
    as the port's per-layer list."""
    c = _np(ref_cache["cross"])
    return [{"k": torch.from_numpy(np.array(c["k"][i])),
             "v": torch.from_numpy(np.array(c["v"][i]))} for i in range(c["k"].shape[0])]


def test_config_matches_reference():
    """The published fields this file's paths depend on (every field is
    held against the reference in ``test_torch_configs.py``)."""
    cfg = get_config(ARCH)
    assert (cfg.arch_type, cfg.n_layers, cfg.encoder_layers, cfg.encoder_seq) == \
        ("encdec", 4, 4, 1500)
    assert (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (384, 6, 64, 1536, 51865)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_cross_attention_matches_reference(diffusion, use_kernels):
    """``attention(kv_override=)``: q without RoPE, every key visible, no
    cache; the plain route even under ``use_kernels`` (no raise)."""
    rcfg, pcfg, rp, pp = diffusion
    rng = np.random.RandomState(2)
    x = rng.randn(2, 12, pcfg.d_model).astype(np.float32)
    k = rng.randn(2, 20, pcfg.n_kv_heads, pcfg.resolved_head_dim).astype(np.float32)
    v = rng.randn(2, 20, pcfg.n_kv_heads, pcfg.resolved_head_dim).astype(np.float32)
    pos = np.broadcast_to(np.arange(12)[None], (2, 12)) + 7    # RoPE would see these
    ref_w = _np(rp["blocks"]["slot0"]["cross"])
    want, want_c = RL.attention({n: w[0] for n, w in ref_w.items()}, rcfg, jnp.asarray(x),
                                jnp.asarray(pos), causal=True,
                                kv_override=(jnp.asarray(k), jnp.asarray(v)))
    got, got_c = PL.attention(pp["blocks"][0]["cross"], pcfg, torch.from_numpy(x),
                              torch.from_numpy(pos.copy()), causal=True,
                              kv_override=(torch.from_numpy(k), torch.from_numpy(v)),
                              use_kernels=use_kernels)
    assert got_c is None and want_c is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_eps_forward_matches_reference(diffusion, use_kernels):
    """``make_eps_fn(frames=)`` and ``forward(frames=)`` (eps and logits)
    against the reference's, ``use_pallas`` set alike (the reference's
    kernel route in interpret mode; the port's K2 plain version)."""
    rcfg, pcfg, rp, pp = diffusion
    rng = np.random.RandomState(5)
    x = rng.randn(2, 24, pcfg.d_model).astype(np.float32)
    t = np.array([0.8, 0.3], np.float32)
    fr = _frames(pcfg)
    want = RT.forward(rp, rcfg, embeds=jnp.asarray(x), t_cond=jnp.asarray(t),
                      frames=jnp.asarray(fr), use_pallas=use_kernels)
    with torch.no_grad():
        got = PT.forward(pp, pcfg, embeds=torch.from_numpy(x), t_cond=torch.from_numpy(t),
                         frames=torch.from_numpy(fr), use_kernels=use_kernels)
        eps = PLM.make_eps_fn(pp, pcfg, frames=torch.from_numpy(fr),
                              use_kernels=use_kernels)(torch.from_numpy(x), torch.tensor(0.3))
    np.testing.assert_allclose(got["eps"].numpy(), np.asarray(want["eps"]), **F32)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), **F32)
    want_eps = RLM.make_eps_fn(rp, rcfg, frames=jnp.asarray(fr), use_pallas=use_kernels)(
        jnp.asarray(x), jnp.float32(0.3))
    np.testing.assert_allclose(eps.numpy(), np.asarray(want_eps), **F32)


def test_kernel_route_sends_only_decoder_self_attention_to_k2(diffusion, monkeypatch):
    """Under ``use_kernels`` K2's wrapper is called once per decoder layer
    and forward (at the decoder's S); the encoder and cross-attention run
    plain, as in the reference."""
    _, pcfg, _, pp = diffusion
    calls = []
    real = PL.ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)
    monkeypatch.setattr(PL.ops, "flash_attention", counted)
    x = torch.zeros(2, 24, pcfg.d_model)
    with torch.no_grad():
        PLM.make_eps_fn(pp, pcfg, frames=torch.from_numpy(_frames(pcfg)),
                        use_kernels=True)(x, torch.tensor(0.5))
    hd = pcfg.resolved_head_dim
    assert calls == [((2, 24, pcfg.n_heads, hd), (2, 24, pcfg.n_kv_heads, hd))] * pcfg.n_layers


def test_sample_tokens_matches_reference(diffusion):
    """The one-shot kernel route with frames: fused tab3 from the
    reference's own prior, the reference on ``use_pallas=True``."""
    rcfg, pcfg, rp, pp = diffusion
    sde = R.VPSDE()
    ts = R.get_timesteps(sde, 6, "quadratic")
    fr = _frames(pcfg, seed=3)
    key = jax.random.PRNGKey(3)
    toks_r, x0_r = RLM.sample_tokens(rp, rcfg, R.make_plan("tab3", sde, ts, fused=True), key,
                                     batch=2, seq_len=16, prior_std=sde.prior_std(),
                                     frames=jnp.asarray(fr), use_pallas=True)
    k_prior, _ = jax.random.split(key)
    x_T = np.array(jax.random.normal(k_prior, (2, 16, rcfg.d_model), jnp.float32)
                   * sde.prior_std())
    with torch.no_grad():
        toks_p, x0_p = PLM.sample_tokens(
            pp, pcfg, P.make_plan("tab3", P.VPSDE(), ts, fused=True), None, batch=2,
            seq_len=16, prior_std=sde.prior_std(), frames=torch.from_numpy(fr),
            use_kernels=True, x_T=torch.from_numpy(x_T))
    assert tuple(toks_p.shape) == (2, 16) and torch.isfinite(x0_p).all()
    np.testing.assert_allclose(x0_p.numpy(), np.asarray(x0_r), **X0_TOL)
    np.testing.assert_array_equal(toks_p.numpy(), np.asarray(toks_r))


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_missing_frames_raise(ar, mode):
    _, pcfg, _, pp = ar
    with pytest.raises(ValueError, match="encoder-decoder.*frames"):
        PT.forward(pp, pcfg, tokens=torch.zeros(1, 4, dtype=torch.long), mode=mode)


def test_decode_without_cross_cache_raises(ar):
    _, pcfg, _, pp = ar
    cache = {"blocks": PT.init_cache(pcfg, 1, 8, device="cpu")["blocks"]}
    with pytest.raises(ValueError, match="cross"):
        PT.forward(pp, pcfg, tokens=torch.zeros(1, 1, dtype=torch.long), mode="decode",
                   cache=cache, cache_index=0)


def test_prefill_cache_matches_reference(ar):
    """Prefill with frames: the self-attention k and v of every decoder
    layer and the cross k and v projected from the encoder's output."""
    rcfg, pcfg, rp, pp = ar
    tok, fr = _tokens(pcfg, 2, 12), _frames(pcfg, seed=4)
    ref = RT.forward(rp, rcfg, tokens=jnp.asarray(tok), frames=jnp.asarray(fr), mode="prefill")
    with torch.no_grad():
        logits, cache = make_prefill_step(pcfg)(
            pp, {"tokens": torch.from_numpy(tok), "frames": torch.from_numpy(fr)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref["logits"][:, -1]), **F32)
    want = params_from_numpy(_np({"blocks": ref["cache"]["blocks"]}), pcfg, "cpu")["blocks"]
    for g, w in zip(cache["blocks"], want):
        for name in ("k", "v"):
            np.testing.assert_allclose(g[name].numpy(), w[name].numpy(), **F32)
    assert len(cache["cross"]) == pcfg.n_layers
    for g, w in zip(cache["cross"], _cross(ref["cache"])):
        assert g["k"].shape == (2, pcfg.encoder_seq, pcfg.n_kv_heads, pcfg.resolved_head_dim)
        for name in ("k", "v"):
            np.testing.assert_allclose(g[name].numpy(), w[name].numpy(), **F32)


def test_init_cache_matches_reference(ar):
    """Self-attention k and v as zeros of the reference's shapes; with
    ``enc_out`` and ``params`` the cross entries are the reference's.
    Without them the cache has no cross entry (the reference's are zeros),
    so decode raises rather than attend to zeros."""
    rcfg, pcfg, rp, pp = ar
    ref = params_from_numpy(_np({"blocks": RT.init_cache(rcfg, 3, 40)["blocks"]}),
                            pcfg, "cpu")["blocks"]
    got = PT.init_cache(pcfg, 3, 40, device="cpu")
    assert "cross" not in got and len(got["blocks"]) == len(ref) == pcfg.n_layers
    for g, w in zip(got["blocks"], ref):
        assert all(g[n].shape == w[n].shape and not g[n].any() for n in ("k", "v"))
    with pytest.raises(ValueError, match="cross"):
        PT.forward(pp, pcfg, tokens=torch.zeros(3, 1, dtype=torch.long), mode="decode",
                   cache=got, cache_index=0)
    with pytest.raises(ValueError, match="enc_out"):
        PT.init_cache(pcfg, 3, 40, device="cpu", params=pp)
    enc = np.random.RandomState(6).randn(2, pcfg.encoder_seq, pcfg.d_model).astype(np.float32)
    want = RT.init_cache(rcfg, 2, 40, enc_out=jnp.asarray(enc), params=rp)
    got = PT.init_cache(pcfg, 2, 40, device="cpu", enc_out=torch.from_numpy(enc), params=pp)
    for g, w in zip(got["cross"], _cross(want)):
        for name in ("k", "v"):
            np.testing.assert_allclose(g[name].numpy(), w[name].numpy(), **F32)


def test_decode_step_from_reference_cache(ar):
    """One decode step of the port from the reference's prefill cache
    (padded to 16 slots) against the reference's decode step."""
    rcfg, pcfg, rp, pp = ar
    tok, fr = _tokens(pcfg, 2, 11, seed=7), _frames(pcfg, seed=7)
    cache = RT.forward(rp, rcfg, tokens=jnp.asarray(tok[:, :10]), frames=jnp.asarray(fr),
                       mode="prefill")["cache"]
    blocks = jax.tree.map(lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 6), (0, 0), (0, 0)]),
                          cache["blocks"])
    cache = {"blocks": blocks, "cross": cache["cross"]}
    pcache = {"blocks": params_from_numpy(_np({"blocks": blocks}), pcfg, "cpu")["blocks"],
              "cross": _cross(cache)}
    want_l, _ = ref_decode_step(rcfg)(rp, cache, jnp.asarray(tok[:, 10:]), jnp.int32(10))
    with torch.no_grad():
        got_l, got_c = make_decode_step(pcfg)(pp, pcache, torch.from_numpy(tok[:, 10:]), 10)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **F32)
    assert got_c["cross"] is pcache["cross"]


def test_prefill_then_decode_matches_full_forward(ar):
    """The reference's KV-cache test on the port: prefill 31 tokens with
    frames, one decode step against the cache (self k/v padded by one
    slot, the cross k/v as prefill left them), the logits of one full
    forward at the last position. Then 8 more decode steps, each against
    the full forward."""
    _, pcfg, _, pp = ar
    tok, fr = torch.from_numpy(_tokens(pcfg, 2, 40)), torch.from_numpy(_frames(pcfg, seed=8))
    s = 31
    with torch.no_grad():
        full = PT.forward(pp, pcfg, tokens=tok, frames=fr, mode="train")["logits"]
        _, pf = make_prefill_step(pcfg)(pp, {"tokens": tok[:, :s], "frames": fr})
        cache = PT.init_cache(pcfg, 2, 40, device="cpu")
        for dst, src in zip(cache["blocks"], pf["blocks"]):
            for name in ("k", "v"):
                dst[name][:, :s] = src[name]
        cache["cross"] = pf["cross"]
        decode = make_decode_step(pcfg)
        for i in range(s, 40):
            logits, cache = decode(pp, cache, tok[:, i:i + 1], i)
            a, b = full[:, i].numpy(), logits.numpy()
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3 * np.abs(a).max())


def test_ar_forward_matches_reference(ar):
    rcfg, pcfg, rp, pp = ar
    tok, fr = _tokens(pcfg, 2, 20, seed=9), _frames(pcfg, seed=9)
    want = RT.forward(rp, rcfg, tokens=jnp.asarray(tok), frames=jnp.asarray(fr))["logits"]
    with torch.no_grad():
        got = PT.forward(pp, pcfg, tokens=torch.from_numpy(tok),
                         frames=torch.from_numpy(fr))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_restacks_exactly(dtype):
    """``encoder`` splits into ``encoder_layers`` layers of one slot, the
    decoder layers carry ``norm_x`` and ``cross``; params_to_numpy gives the
    reference's tree back byte for byte."""
    rcfg, pcfg, rp, pp = _models(dtype=dtype)
    tree = _np(rp)
    assert len(pp["encoder"]) == pcfg.encoder_layers and layers_per_block(pp["encoder"]) == 1
    assert set(pp["encoder"][0]) == {"norm1", "attn", "norm2", "mlp"}
    assert set(pp["blocks"][0]) == {"norm1", "attn", "norm_x", "cross", "norm2", "mlp"}
    for i, layer in enumerate(pp["encoder"]):
        w = tree["encoder"]["slot0"]["attn"]["wq"][i].astype(np.float32)
        np.testing.assert_array_equal(layer["attn"]["wq"].float().numpy(), w)
    back = params_to_numpy(pp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


def test_init_params_structure_matches_reference(diffusion):
    _, pcfg, _, pp = diffusion
    mine = PT.init_params(pcfg, 0, "cpu")
    sig = lambda tree: jax.tree.map(lambda t: (tuple(t.shape), t.dtype), tree)
    assert sig(mine) == sig(pp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_port(tmp_path, dtype):
    """``['encoder']/['slot0']/...`` restores layer by layer, bitwise."""
    rcfg, pcfg, rp, pp = _models(dtype=dtype)
    RC.save(str(tmp_path), 2, rp)
    got, _ = PC.restore(str(tmp_path), PT.init_params(pcfg, 1, "cpu"))
    want = jax.tree.leaves(pp)
    got = jax.tree.leaves(got)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_checkpoint_restores_in_reference(tmp_path):
    rcfg, pcfg, rp, pp = _models()
    port_dir = PC.save(str(tmp_path / "port"), 5, pp)
    back, _ = RC.restore(str(tmp_path / "port"), rp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ref_dir = RC.save(str(tmp_path / "ref"), 5, rp)
    with open(f"{port_dir}/manifest.json") as f, open(f"{ref_dir}/manifest.json") as g:
        assert f.read() == g.read()


def test_engines_and_launcher_refuse_encdec(diffusion, ar):
    """The engines take no frames (nor do the reference's, whose forward
    then fails): both raise the clear encdec error, and so does the
    launcher in either mode."""
    _, pcfg, _, pp = diffusion
    with pytest.raises(ValueError, match="encoder-decoder"):
        DiffusionServeEngine(pp, pcfg, device="cpu")
    _, pcfg, _, pp = ar
    with pytest.raises(ValueError, match="encoder-decoder"):
        ARServeEngine(pp, pcfg, device="cpu")
    for mode in ("diffusion", "ar"):
        with pytest.raises(ValueError, match="encoder-decoder"):
            main(["--arch", ARCH, "--reduced", "--device", "cpu", "--mode", mode,
                  "--requests", "1"])
