"""The port's eps-networks against the JAX package's, with the reference's
own weights carried over (``params_from_numpy``), on ``gemma_2b.reduced()``
(2 layers, d_model 256, MQA 4/1 heads of 32, GeGLU) and
``mamba2_2p7b.reduced()`` (2 Mamba2 layers, d_model 256, 32 heads of 16,
state 16, chunk 16) in the diffusion objective, on the plain route and on
the kernel route (the reference's ``use_pallas=True``, its Pallas kernels
in interpret mode).

Tolerances: float32 rtol = atol = 1e-5 (matmul summation order);
bfloat16 atol = 3e-2 (the frameworks round to bf16 at different places,
e.g. inside GeLU and the attention products)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.configs.gemma_2b import get_config as ref_config
from repro.diffusion import lm as RLM
from repro.models import layers as RL
from repro.models.transformer import init_params as ref_init
from repro_torch.configs import get_config
from repro_torch.diffusion import lm as PLM
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy

F32 = dict(rtol=1e-5, atol=1e-5)


def _models(dtype="float32"):
    rcfg = ref_config().reduced().with_(objective="diffusion", dtype=dtype)
    pcfg = get_config("gemma_2b").reduced().with_(objective="diffusion", dtype=dtype)
    rp = ref_init(rcfg, jax.random.PRNGKey(0))
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), pcfg, "cpu")
    return rcfg, pcfg, rp, pp


def _arch_models(arch):
    rcfg = ref_get_config(arch).reduced().with_(objective="diffusion")
    pcfg = get_config(arch).reduced().with_(objective="diffusion")
    rp = ref_init(rcfg, jax.random.PRNGKey(0))
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), pcfg, "cpu")
    return rcfg, pcfg, rp, pp


def _x(b=3, s=16, d=256, seed=0):
    return np.random.RandomState(seed).randn(b, s, d).astype(np.float32)


def test_reduced_config_matches_reference():
    rcfg = ref_config().reduced()
    pcfg = get_config("gemma_2b").reduced()
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab_size", "act", "glu", "tie_embeddings", "dtype", "rope_theta"):
        assert getattr(pcfg, f) == getattr(rcfg, f), f
    full = get_config("gemma_2b")
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab_size) == (18, 2048, 16384, 256000)


@pytest.mark.parametrize("masked", [False, True])
def test_eps_fn_matches_reference(masked):
    rcfg, pcfg, rp, pp = _models()
    x, t = _x(), np.float32(0.37)
    vl = np.array([16, 9, 12], np.int32) if masked else None
    want = RLM.make_eps_fn(rp, rcfg, valid_len=None if vl is None else jnp.asarray(vl))(
        jnp.asarray(x), jnp.asarray(t))
    got = PLM.make_eps_fn(pp, pcfg, valid_len=None if vl is None else torch.from_numpy(vl))(
        torch.from_numpy(x), torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_eps_fn_per_row_times_match_reference():
    rcfg, pcfg, rp, pp = _models()
    x, t = _x(seed=1), np.array([0.9, 0.4, 0.02], np.float32)
    want = RLM.make_eps_fn(rp, rcfg)(jnp.asarray(x), jnp.asarray(t))
    got = PLM.make_eps_fn(pp, pcfg)(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_forward_logits_and_decode_match_reference():
    """The logits path (off on the eps path) and token decoding: argmax of
    (x0 / 25) @ embed.T, first maximum on ties in both frameworks."""
    rcfg, pcfg, rp, pp = _models()
    x = _x(seed=2)
    from repro.models.transformer import forward as ref_forward
    t = np.full((3,), 0.5, np.float32)
    want = ref_forward(rp, rcfg, embeds=jnp.asarray(x), t_cond=jnp.asarray(t))
    got = PT.forward(pp, pcfg, embeds=torch.from_numpy(x), t_cond=torch.from_numpy(t))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), **F32)
    assert "logits" not in PT.forward(pp, pcfg, embeds=torch.from_numpy(x),
                                      t_cond=torch.from_numpy(t), logits=False)
    x0 = x * 25.0
    np.testing.assert_array_equal(PLM.decode_tokens(pp, pcfg, torch.from_numpy(x0)).numpy(),
                                  np.asarray(RLM.decode_tokens(rp, rcfg, jnp.asarray(x0))))


def test_bf16_eps_fn_close_to_reference():
    rcfg, pcfg, rp, pp = _models("bfloat16")
    assert pp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(pp["embed"].float().numpy(),
                                  np.asarray(rp["embed"], np.float32))
    x, t = _x(seed=3), np.float32(0.6)
    want = np.asarray(RLM.make_eps_fn(rp, rcfg)(jnp.asarray(x), jnp.asarray(t)), np.float32)
    got = PLM.make_eps_fn(pp, pcfg)(torch.from_numpy(x), torch.tensor(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2)


def test_layer_pieces_match_reference():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 4, 32).astype(np.float32)
    pos = np.broadcast_to(np.arange(8)[None], (2, 8))
    cr, sr = RL.rope_frequencies(32, jnp.asarray(pos), 10000.0)
    cp, sp = PL.rope_frequencies(32, torch.from_numpy(pos.copy()), 10000.0)
    np.testing.assert_allclose(
        PL.apply_rope(torch.from_numpy(x), cp, sp).numpy(),
        np.asarray(RL.apply_rope(jnp.asarray(x), cr, sr)), **F32)
    t = np.array([0.1, 0.7], np.float32)
    np.testing.assert_allclose(PL.sinusoidal_embedding(torch.from_numpy(t), 64).numpy(),
                               np.asarray(RL.sinusoidal_embedding(jnp.asarray(t), 64)), **F32)
    h, sc = rng.randn(2, 8, 64).astype(np.float32), rng.randn(64).astype(np.float32)
    np.testing.assert_allclose(PL.rms_norm(torch.from_numpy(h), torch.from_numpy(sc)).numpy(),
                               np.asarray(RL.rms_norm(jnp.asarray(h), jnp.asarray(sc))), **F32)
    # sliding window + causal + softcap masks
    q, k = rng.randn(2, 8, 4, 32).astype(np.float32), rng.randn(2, 8, 4, 32).astype(np.float32)
    mr = RL.make_attention_mask(jnp.asarray(pos), jnp.asarray(pos), True, 3)
    mp = PL.make_attention_mask(torch.from_numpy(pos.copy()), torch.from_numpy(pos.copy()), True, 3)
    np.testing.assert_array_equal(mp.numpy(), np.asarray(mr))
    np.testing.assert_allclose(
        PL.attention_scores(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
                            mp, softcap=5.0).numpy(),
        np.asarray(RL.attention_scores(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                                       mr, softcap=5.0)), **F32)


def test_init_params_shapes_and_scales_match_reference():
    rcfg, pcfg, rp, _ = _models()
    mine = PT.init_params(pcfg, 0, "cpu")
    ref_layer = jax.tree.map(lambda a: a[0], rp["blocks"]["slot0"])
    for name in ("embed", "final_norm", "eps_head"):
        assert tuple(mine[name].shape) == tuple(rp[name].shape)
    assert len(mine["blocks"]) == pcfg.n_layers
    for grp in ("attn", "mlp"):
        for k, v in ref_layer[grp].items():
            got = mine["blocks"][0][grp][k]
            assert tuple(got.shape) == tuple(v.shape), (grp, k)
            # same init scale: the std of a large random matrix within 10%
            assert float(got.std()) == pytest.approx(float(np.std(np.asarray(v))), rel=0.1)
    with pytest.raises(RuntimeError, match="CUDA") if not torch.cuda.is_available() \
            else _no_raise():
        PT.init_params(pcfg, 0)


class _no_raise:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("arch,use_kernels", [
    ("mamba2_2p7b", False), ("mamba2_2p7b", True), ("gemma_2b", True)])
def test_eps_fn_kernel_route_matches_reference(arch, use_kernels):
    """The eps forward of mamba2 (both routes) and gemma through K2 against
    the reference's forward with ``use_pallas`` set alike, at float32
    rtol = atol = 1e-5. S = 40 is not a multiple of mamba2's chunk 16."""
    rcfg, pcfg, rp, pp = _arch_models(arch)
    x, t = _x(b=2, s=40, seed=4), np.array([0.8, 0.3], np.float32)
    want = RLM.make_eps_fn(rp, rcfg, use_pallas=use_kernels)(jnp.asarray(x), jnp.asarray(t))
    got = PLM.make_eps_fn(pp, pcfg, use_kernels=use_kernels)(
        torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_ssm_params_from_numpy_leaf_by_leaf():
    """SSM layers cross over as ``{"norm1", "ssm"}`` per layer (no MLP, no
    norm2), every leaf equal, with the reference's dtypes: float32
    ``A_log``/``dt_bias``/``D`` in a bf16 model, conv weights (K, C)."""
    rcfg = ref_get_config("mamba2_2p7b").reduced().with_(dtype="bfloat16")
    pcfg = get_config("mamba2_2p7b").reduced().with_(dtype="bfloat16")
    rp = jax.tree.map(np.asarray, ref_init(rcfg, jax.random.PRNGKey(1)))
    pp = params_from_numpy(rp, pcfg, "cpu")
    assert len(pp["blocks"]) == pcfg.n_layers
    mine = PT.init_params(pcfg, 0, "cpu")
    for i, layer in enumerate(pp["blocks"]):
        assert set(layer) == {"norm1", "ssm"} == set(mine["blocks"][i])
        assert set(layer["ssm"]) == set(rp["blocks"]["slot0"]["ssm"])
        for k, v in rp["blocks"]["slot0"]["ssm"].items():
            got = layer["ssm"][k]
            assert tuple(got.shape) == v.shape[1:], k
            assert got.dtype == mine["blocks"][i]["ssm"][k].dtype, k
            np.testing.assert_array_equal(got.float().numpy(), v[i].astype(np.float32))
        np.testing.assert_array_equal(layer["norm1"].float().numpy(),
                                      rp["blocks"]["slot0"]["norm1"][i].astype(np.float32))
    assert pp["blocks"][0]["ssm"]["A_log"].dtype == torch.float32
    assert tuple(pp["blocks"][0]["ssm"]["conv_w"].shape) == (
        pcfg.ssm.conv_width, 2 * pcfg.d_model + 2 * pcfg.ssm.state_dim)
    assert set(pp) == set(mine)


def test_softcap_is_refused_on_the_kernel_route():
    rcfg, pcfg, rp, pp = _models()
    cfg = pcfg.with_(logit_softcap=30.0)
    x, t = torch.from_numpy(_x(seed=6)), torch.tensor(0.5)
    PLM.make_eps_fn(pp, cfg)(x, t)      # the plain route applies softcap
    with pytest.raises(ValueError, match="softcap"):
        PLM.make_eps_fn(pp, cfg, use_kernels=True)(x, t)


def test_valid_len_is_refused_on_the_kernel_route():
    """K2 has no per-row key length: a padded batch on the kernel route
    raises rather than run the plain attention unseen."""
    rcfg, pcfg, rp, pp = _models()
    x, t = torch.from_numpy(_x(seed=7)), torch.tensor(0.5)
    valid_len = torch.tensor([16, 12, 9])
    PLM.make_eps_fn(pp, pcfg, valid_len=valid_len)(x, t)
    with pytest.raises(ValueError, match="key length"):
        PLM.make_eps_fn(pp, pcfg, valid_len=valid_len, use_kernels=True)(x, t)
