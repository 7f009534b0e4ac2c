"""The port's MoE layer (``repro_torch.models.layers.moe``) against the JAX
package's (``repro.models.layers.moe``) on the reduced float32 configs of
mixtral-8x7b (4 experts, top-2) and grok-1 (the same, with ``act="gelu"``),
layer 0's weights carried over with ``params_from_numpy``.

Routing is discrete, so it is compared first and exactly: every token's
top-2 experts, its place in each expert's queue and the set of dropped
(token, choice) pairs, over 3 x 64 = 192 tokens a case. Then, at float32
summation order: the layer's output within rtol = atol = 1e-5, the
load-balance and z losses within 1e-6, and the two dispatch modes of the
port within rtol = atol = 1e-6 of each other (the same products, summed
over k choices or over E x C slots)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.models import layers as PL
from repro_torch.models.convert import params_from_numpy

F32 = dict(rtol=1e-5, atol=1e-5)
AUX = dict(rtol=1e-6, atol=1e-6)
B, S = 3, 64


def _cfgs(arch, cf=None, dispatch="einsum", dtype="float32"):
    rcfg = ref_get_config(arch).reduced().with_(dtype=dtype, moe_dispatch=dispatch)
    pcfg = get_config(arch).reduced().with_(dtype=dtype, moe_dispatch=dispatch)
    if cf is not None:
        rcfg = rcfg.with_(moe=dataclasses.replace(rcfg.moe, capacity_factor=cf))
        pcfg = pcfg.with_(moe=dataclasses.replace(pcfg.moe, capacity_factor=cf))
    return rcfg, pcfg


def _layer0(arch, dtype="float32"):
    """Layer 0's MoE weights of the reference's model, and the same in the port."""
    rcfg, pcfg = _cfgs(arch, dtype=dtype)
    rp = jax.tree.map(np.asarray, RT.init_params(rcfg, jax.random.PRNGKey(0)))
    pp = params_from_numpy(rp, pcfg, "cpu")
    return jax.tree.map(lambda a: jnp.asarray(a[0]), rp["blocks"]["slot0"]["moe"]), \
        pp["blocks"][0]["moe"]


def _x(d=256, seed=0):
    return np.random.RandomState(seed).randn(B, S, d).astype(np.float32)


def _ref_route(params, cfg, x):
    """The routing lines of ``repro.models.layers.moe`` (its top-k, queue
    places by a float32 cumulative sum, and capacity), which it does not
    return."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cap = min(max(1, int(cfg.moe.capacity_factor * x.shape[1] * k / e)), x.shape[1])
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), params["router"])
    _, gate_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.float32)
    flat = onehot.reshape(x.shape[0], -1, e)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape) * onehot, -1)
    return cap, np.asarray(gate_idx), np.asarray(pos).astype(np.int64), np.asarray(pos < cap)


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "grok_1_314b"])
@pytest.mark.parametrize("cf", [1.25, 1.0])
def test_routing_and_drops_match_reference(arch, cf):
    """gate_idx equal for all 192 tokens, then queue places and the dropped
    (token, choice) pairs equal; at capacity_factor 1.0 some pairs drop."""
    rparams, pparams = _layer0(arch)
    rcfg, pcfg = _cfgs(arch, cf)
    x = _x()
    cap, want_idx, want_pos, want_kept = _ref_route(rparams, rcfg, jnp.asarray(x))
    r = PL.moe_route(pparams, pcfg, torch.from_numpy(x))
    assert r["gate_idx"].shape == (B, S, 2)
    np.testing.assert_array_equal(r["gate_idx"].numpy(), want_idx)
    assert r["cap"] == cap == int(cf * S * 2 / 4)
    np.testing.assert_array_equal(r["pos"].numpy(), want_pos)
    np.testing.assert_array_equal(r["within_cap"].numpy(), want_kept)
    n_dropped = int((~r["within_cap"]).sum())
    if cf == 1.0:
        assert n_dropped > 0
    torch.testing.assert_close(r["gate_vals"].sum(-1), torch.ones(B, S), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "grok_1_314b"])
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("cf", [1.25, 1.0])
def test_moe_matches_reference(arch, dispatch, cf):
    rparams, pparams = _layer0(arch)
    rcfg, pcfg = _cfgs(arch, cf, dispatch)
    x = _x(seed=1)
    want, want_aux = RL.moe(rparams, rcfg, jnp.asarray(x))
    got, got_aux = PL.moe(pparams, pcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert set(got_aux) == set(want_aux) == {"moe_lb", "moe_z"}
    for k in want_aux:
        np.testing.assert_allclose(got_aux[k].item(), float(want_aux[k]), **AUX)


@pytest.mark.parametrize("cf", [1.25, 1.0])
def test_gather_dispatch_equals_einsum_dispatch(cf):
    _, pparams = _layer0("mixtral_8x7b")
    x = torch.from_numpy(_x(seed=2))
    out = {}
    for dispatch in ("einsum", "gather"):
        _, pcfg = _cfgs("mixtral_8x7b", cf, dispatch)
        out[dispatch] = PL.moe(pparams, pcfg, x)
    torch.testing.assert_close(out["gather"][0], out["einsum"][0], rtol=1e-6, atol=1e-6)
    for k in ("moe_lb", "moe_z"):
        assert out["gather"][1][k].item() == out["einsum"][1][k].item()


def test_unknown_dispatch_raises():
    _, pparams = _layer0("mixtral_8x7b")
    _, pcfg = _cfgs("mixtral_8x7b", dispatch="sorted")
    with pytest.raises(ValueError, match="moe_dispatch"):
        PL.moe(pparams, pcfg, torch.from_numpy(_x()))


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_grok_experts_apply_silu_whatever_act(dispatch):
    """The reference's ``moe`` applies silu inside the experts whatever
    ``cfg.act`` is (grok sets gelu): the port does the same, bitwise."""
    _, pparams = _layer0("grok_1_314b")
    _, pcfg = _cfgs("grok_1_314b", dispatch=dispatch)
    assert pcfg.act == "gelu"
    x = torch.from_numpy(_x(seed=3))
    gelu, _ = PL.moe(pparams, pcfg, x)
    silu, _ = PL.moe(pparams, pcfg.with_(act="silu"), x)
    assert torch.equal(gelu, silu)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_rows_route_and_drop_independently(dispatch):
    """Capacity is per row: a row's output in a batch is bitwise its output
    alone, drops included (capacity_factor 1.0)."""
    _, pparams = _layer0("mixtral_8x7b")
    _, pcfg = _cfgs("mixtral_8x7b", 1.0, dispatch)
    x = torch.from_numpy(_x(seed=4))
    out, _ = PL.moe(pparams, pcfg, x)
    for i in range(B):
        solo, _ = PL.moe(pparams, pcfg, x[i:i + 1])
        assert torch.equal(solo[0], out[i])


@pytest.mark.parametrize("s,cf,cap", [(1, 1.25, 1), (64, 1.25, 40), (64, 100.0, 64), (7, 1.0, 3)])
def test_capacity(s, cf, cap):
    """``max(1, int(cf * S * k / E))`` capped at S (k 2, E 4): a decode step
    (S 1) keeps every pair; capacity_factor 100 never drops."""
    _, pparams = _layer0("mixtral_8x7b")
    _, pcfg = _cfgs("mixtral_8x7b", cf)
    r = PL.moe_route(pparams, pcfg, torch.zeros(2, s, 256))
    assert r["cap"] == cap
    if cap == s:
        assert bool(r["within_cap"].all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_shapes_and_scales_match_reference(dtype):
    """Router (d, E) float32, experts (E, d, f) and (E, f, d) in the
    model's dtype, each leaf's std within 10 % of the reference's."""
    rparams, _ = _layer0("mixtral_8x7b", dtype)
    _, pcfg = _cfgs("mixtral_8x7b", dtype=dtype)
    mine = PL.init_moe(torch.Generator().manual_seed(0), pcfg,
                       {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype], "cpu")
    assert set(mine) == set(rparams)
    for k, v in rparams.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert str(mine[k].dtype)[6:] == str(v.dtype), k
        assert float(mine[k].float().std()) == pytest.approx(
            float(np.std(np.asarray(v, np.float32))), rel=0.1), k
