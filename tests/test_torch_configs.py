"""The configurations of the port against the JAX package's: the eleven
``ARCH_IDS`` in the reference's order (the port's own configs,
``PORT_ARCH_IDS``, beside them and not among them, each loading and
setting fields only the port has), and the three dense ones that need
no arch code of their own (glm4-9b, GQA 32/2 at head_dim 128;
granite-3-8b, GQA 32/8; cifar10-scorenet, the paper's float32 score
network) held field for field, then through their reduced float32 eps
forward on both routes and their AR logits, with the reference's weights
carried over (``params_from_numpy``).

``config_from_dict`` is held against the reference's converter on the
same dicts: equal field values on valid ones, the same exception type and
message on invalid ones. The port's own fields (those the reference's
dataclasses lack) hold their defaults in every reference config:
``as_reference`` asserts that and drops them, so each config compares
whole against the reference's.

Tolerance: eps and logits at float32 rtol = atol = 1e-5 (summation
order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as RB
from repro.configs.base import ARCH_IDS as REF_ARCH_IDS
from repro.configs.base import config_from_dict as ref_config_from_dict
from repro.configs.base import get_config as ref_get_config
from repro.models import transformer as RT
from repro_torch.configs import ARCH_IDS, PORT_ARCH_IDS, get_config
from repro_torch.configs.base import MoEConfig, ModelConfig, SSMConfig, config_from_dict
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy

F32 = dict(rtol=1e-5, atol=1e-5)
DENSE = ["glm4_9b", "granite_3_8b", "cifar10_scorenet"]


def _port_fields(cfg):
    """``dataclasses.asdict(cfg)``, and [(object, field, the object's part
    of that dict)] for each field of ``cfg`` and its ``moe``/``ssm`` that
    the reference's dataclasses lack."""
    d = dataclasses.asdict(cfg)
    out = []
    for obj, sub, ref_cls in ((cfg, d, RB.ModelConfig), (cfg.moe, d["moe"], RB.MoEConfig),
                              (cfg.ssm, d["ssm"], RB.SSMConfig)):
        if obj is None:
            continue
        ref_names = {f.name for f in dataclasses.fields(ref_cls)}
        out += [(obj, f, sub) for f in dataclasses.fields(obj) if f.name not in ref_names]
    return d, out


def as_reference(cfg):
    """``dataclasses.asdict(cfg)`` without the fields the reference's
    dataclasses lack, each asserted at its default first."""
    d, port = _port_fields(cfg)
    for obj, f, sub in port:
        assert getattr(obj, f.name) == f.default, (cfg.name, f.name)
        del sub[f.name]
    return d


def _models(arch, objective):
    rcfg = ref_get_config(arch).reduced().with_(objective=objective)
    pcfg = get_config(arch).reduced().with_(objective=objective)
    rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, pcfg, rp, params_from_numpy(jax.tree.map(np.asarray, rp), pcfg, "cpu")


def test_arch_ids_are_the_references():
    assert ARCH_IDS == REF_ARCH_IDS and len(ARCH_IDS) == 11
    assert PORT_ARCH_IDS == ["granite_4p0_h_small"]
    assert not set(PORT_ARCH_IDS) & set(REF_ARCH_IDS)
    for arch in PORT_ARCH_IDS:
        cfg = get_config(arch)
        assert isinstance(cfg, ModelConfig) and cfg.reduced().n_layers <= cfg.n_layers
        # a port-only config sets the port's own fields: the reference refuses it
        with pytest.raises(ValueError, match="unknown keys"):
            ref_config_from_dict(dataclasses.asdict(cfg))
        with pytest.raises(AssertionError):
            as_reference(cfg)
    assert get_config("granite-4.0-h-small") == get_config("granite_4p0_h_small")
    _, port = _port_fields(get_config("granite_4p0_h_small"))
    assert {f.name for _, f, _ in port} == {
        "pos_embedding", "attn_scale", "embedding_multiplier", "residual_multiplier",
        "logits_scaling", "shared_ff", "gate_first"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_matches_reference(arch):
    """Every field (the mesh lever ``act_shard_axes`` too), published and
    reduced."""
    for r, p in ((ref_get_config(arch), get_config(arch)),
                 (ref_get_config(arch).reduced(), get_config(arch).reduced())):
        assert as_reference(p) == dataclasses.asdict(r)


# the cases of the reference's own converter test, a nested ssm dict, a
# tuple field given as a list, and an arch's whole published config
VALID_DICTS = [
    {"name": "m", "n_layers": 2, "d_model": 64,
     "moe": {"num_experts": 4, "top_k": 1}, "rope_theta": 10000},
    {"ssm": None},
    {"arch_type": "ssm", "ssm": {"state_dim": 16, "head_dim": 16, "chunk_size": 32},
     "norm_eps": 1, "act_shard_axes": ["data", "model"]},
    {},
    dataclasses.asdict(ref_get_config("jamba_1p5_large")),
]
INVALID_DICTS = [
    ({"not_a_field": 1}, ValueError),
    ({"moe": {"bogus": 1}}, ValueError),
    ({"ssm": {"state_dim": 16, "bogus": 1}}, ValueError),
    ({"n_layers": "four"}, TypeError),
    ({"act_shard_axes": "data"}, TypeError),
    ({"ssm": 3}, TypeError),
    (["n_layers"], TypeError),
]


@pytest.mark.parametrize("d", VALID_DICTS, ids=range(len(VALID_DICTS)))
def test_config_from_dict_matches_reference(d):
    """The port's strict converter gives the reference's field values
    (nested dataclasses, float promotion, list -> tuple)."""
    got, want = config_from_dict(d), ref_config_from_dict(d)
    assert as_reference(got) == dataclasses.asdict(want)
    for name in ("moe", "ssm"):
        sub = getattr(got, name)
        assert sub is None or isinstance(sub, {"moe": MoEConfig, "ssm": SSMConfig}[name])
    assert isinstance(got.rope_theta, float) and isinstance(got.norm_eps, float)


@pytest.mark.parametrize("d,exc", INVALID_DICTS, ids=range(len(INVALID_DICTS)))
def test_config_from_dict_rejects_like_reference(d, exc):
    with pytest.raises(exc) as ref_err:
        ref_config_from_dict(d)
    with pytest.raises(exc) as got_err:
        config_from_dict(d)
    assert str(got_err.value) == str(ref_err.value)
    if exc is ValueError:
        assert "unknown keys" in str(got_err.value)


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
