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
over k choices or over E x C slots).

The kernel route's four plain versions (``repro_torch.kernels.moe_dispatch``)
against the plain route at granite-like (72 experts, top-10), mixtral-like
(8, top-2) and saturated (16, top-4 at capacity factor 0.1: most pairs
drop) routing, in float32 and bf16: the routing's choices, places, drops
and gates bitwise those of ``moe_queue``, the slot table the inverse of the
pair -> slot map, and the layer on that route (``_moe_kernels`` on CPU
tensors) within one rounding of both dispatch modes, with the same aux
losses to float32 rounding and the same counters."""
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
from repro_torch.kernels import moe_dispatch as MD
from repro_torch.models import layers as PL
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer

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


# (E, k, capacity factor): granite-like, mixtral-like, and saturated (most pairs drop)
ROUTINGS = [(72, 10, 1.25), (8, 2, 1.25), (16, 4, 0.1)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _routing_cfg(e, k, cf, dtype="float32"):
    cfg = get_config("mixtral_8x7b").reduced().with_(dtype=dtype)
    return cfg.with_(moe=dataclasses.replace(cfg.moe, num_experts=e, top_k=k,
                                             capacity_factor=cf))


def _logits(e, seed=7):
    return torch.from_numpy(np.random.RandomState(seed).randn(B, S, e).astype(np.float32) * 2)


@pytest.mark.parametrize("e,k,cf", ROUTINGS)
def test_route_ref_matches_moe_queue(e, k, cf):
    """The kernel route's routing (top-k on the logits, places counted per
    expert over the row's earlier tokens) gives the choices, places, drops
    and gates of ``moe_queue`` bitwise."""
    cfg = _routing_cfg(e, k, cf)
    logits = _logits(e)
    gates = torch.softmax(logits, dim=-1)
    q = PL.moe_queue(cfg, logits, gates, torch.topk(gates, k, dim=-1).indices)
    r = MD.route_ref(logits, top_k=k, cap=q["cap"])
    assert torch.equal(r["gate_idx"], q["gate_idx"])
    assert torch.equal(r["pos"].long(), q["pos"])
    assert torch.equal(r["slot"] >= 0, q["within_cap"])
    assert torch.equal(r["gate_vals"], q["gate_vals"])
    if cf < 1:
        assert float(q["within_cap"].float().mean()) < 0.5


@pytest.mark.parametrize("e,k,cf", ROUTINGS)
def test_slot_table_inverts_the_pair_map(e, k, cf):
    """Slot ``e B C + b C + place`` of the (E, B C) table holds the row b S +
    s of the one pair that took it, every other slot -1; each row's kept
    counts are its kept pairs by expert; the logsumexp and gate sums are
    the softmax's."""
    cap = PL._capacity(_routing_cfg(e, k, cf), S, k, e)
    logits = _logits(e, seed=8)
    r = MD.route_ref(logits, top_k=k, cap=cap)
    kept = r["slot"] >= 0
    rows = torch.arange(B * S, dtype=torch.int32).reshape(B, S, 1).expand(B, S, k)
    table = r["table"].reshape(-1)
    assert r["table"].shape == (e, B * cap)
    assert torch.equal(table[r["slot"][kept].long()], rows[kept])
    assert int((table >= 0).sum()) == int(kept.sum())
    want = torch.full_like(table, -1)
    want[r["slot"][kept].long()] = rows[kept]
    assert torch.equal(table, want)
    at = r["gate_idx"] * (B * cap) + torch.arange(B)[:, None, None] * cap + r["pos"]
    assert torch.equal(r["slot"][kept].long(), at[kept])
    by_expert = torch.zeros(B, e, dtype=torch.int32)
    by_expert.scatter_add_(1, r["gate_idx"].reshape(B, -1), kept.reshape(B, -1).to(torch.int32))
    assert torch.equal(r["kept"], by_expert)
    assert torch.equal(r["lse"], torch.logsumexp(logits, -1))
    torch.testing.assert_close(r["gate_sum"], torch.softmax(logits, -1).sum(1))


def _kernel_route_case(e, k, cf, dtype, seed=9):
    cfg = _routing_cfg(e, k, cf, dtype)
    params = PL.init_moe(torch.Generator().manual_seed(seed), cfg, DTYPES[dtype], "cpu")
    x = torch.from_numpy(_x(seed=seed)).to(DTYPES[dtype])
    return cfg, params, x


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("e,k,cf", ROUTINGS)
def test_kernel_route_matches_both_plain_modes(e, k, cf, dtype):
    """``_moe_kernels`` on CPU tensors (the kernels' plain versions) within
    one rounding of both dispatch modes (float32 rtol = atol = 1e-5; bf16
    one unit in the last place of the output, plus the plain modes' bf16
    rounding of the gates: 2^-8 of the largest output), the aux losses
    within float32 rounding (rtol = atol = 1e-6). ``moe(use_kernels=True)``
    on a CPU tensor is the plain route of ``cfg.moe_dispatch``, bitwise."""
    cfg, params, x = _kernel_route_case(e, k, cf, dtype)
    with torch.no_grad():
        got, got_aux = PL._moe_kernels(params, cfg, x)
        for dispatch in ("einsum", "gather"):
            c = cfg.with_(moe_dispatch=dispatch)
            want, want_aux = PL.moe(params, c, x)
            tol = F32 if dtype == "float32" else dict(
                rtol=2.0 ** -7, atol=2.0 ** -8 * want.float().abs().max().item())
            torch.testing.assert_close(got.float(), want.float(), **tol)
            for key in ("moe_lb", "moe_z"):
                torch.testing.assert_close(got_aux[key], want_aux[key], **AUX)
            on_cpu, _ = PL.moe(params, c, x, use_kernels=True)
            assert torch.equal(on_cpu, want)


@pytest.mark.parametrize("e,k,cf", ROUTINGS)
def test_kernel_route_rows_route_and_drop_independently(e, k, cf):
    """Capacity is per row: a row routed alone has the choices, places,
    drops, gates and kept counts bitwise of its part of the batch, and its
    block of each expert's slots holds the same tokens; its output is its
    part of the batch's within float32 rounding (the expert products' CPU
    GEMMs may block M = B C differently, on the plain route too)."""
    cfg, params, x = _kernel_route_case(e, k, cf, "float32")
    cap = PL._capacity(cfg, S, k, e)
    logits = x @ params["router"]
    full = MD.route_ref(logits, top_k=k, cap=cap)
    table = full["table"].reshape(e, B, cap)
    with torch.no_grad():
        out, _ = PL._moe_kernels(params, cfg, x)
        for i in range(B):
            one = MD.route_ref(logits[i:i + 1], top_k=k, cap=cap)
            for key in ("gate_idx", "pos", "gate_vals", "kept"):
                assert torch.equal(one[key][0], full[key][i]), key
            assert torch.equal(one["slot"][0] >= 0, full["slot"][i] >= 0)
            assert torch.equal(torch.where(one["table"] >= 0, one["table"] + i * S, -1),
                               table[:, i])
            torch.testing.assert_close(PL._moe_kernels(params, cfg, x[i:i + 1])[0][0], out[i],
                                       **F32)


def test_kernel_route_keeps_the_spans_and_counters():
    """The kernel route counts the plain route's expert slots and routed
    pairs and opens the same spans (``shared`` before ``combine``, which
    adds it)."""
    cfg, _, x = _kernel_route_case(72, 10, 1.25, "float32")
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, shared_ff=24))
    params = PL.init_moe(torch.Generator().manual_seed(3), cfg, torch.float32, "cpu")
    snaps, names = [], []
    with torch.no_grad():
        for kernels in (True, False):
            tracer = Tracer(MetricsRegistry())
            with tracer.span("layer.moe"):
                if kernels:
                    PL._moe_kernels(params, cfg, x, tracer)
                else:
                    PL.moe(params, cfg, x, tracer)
            snaps.append({k: v for k, v in tracer.registry.snapshot().items()
                          if k.startswith("moe_")})
            names.append(set(tracer.span_names()))
    assert snaps[0] == snaps[1] == {"moe_expert_slots_total": B * 72 * int(1.25 * S * 10 / 72),
                                    "moe_routed_pairs_total": B * S * 10}
    assert names[0] == names[1] == {"layer.moe"} | {
        f"layer.moe.{p}" for p in ("route", "dispatch", "experts", "combine", "shared")}


def test_kernel_route_raises_under_autograd():
    """No backward: where autograd would record it, the kernel route raises."""
    cfg, params, x = _kernel_route_case(8, 2, 1.25, "float32")
    params["w_up"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        PL._moe_kernels(params, cfg, x)
    with torch.no_grad():
        PL._moe_kernels(params, cfg, x)
