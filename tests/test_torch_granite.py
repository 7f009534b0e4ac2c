"""granite-4.0-h-small in the port (``configs/granite_4p0_h_small.py``) on
the CPU, against the benchmark's plain reference of it
(``chipbench/reference/granite.py``, plain float32 PyTorch; the JAX package
has no such model) and against each mechanism's formula.

- A tiny granite-shaped float32 config (10 layers: the attention in slot 5,
  SSD mixers elsewhere; every layer a MoE of 8 experts, top 3, with a
  shared expert; NoPE, a softmax scale, all three muP multipliers and the
  gate-first norm on; S 32): the port's plain-route eps, and its logits,
  against the reference on the port's own seeded weights, the same dict
  handed to both. Tolerance rtol = atol = 2e-5: float32 with other
  summation orders (the port's chunked scan and one-hot dispatch products
  against the reference's per-step decay products and per-expert loops),
  over ten layers whose residual branches are scaled by 0.22 and whose
  input is scaled by 12.
- Each mechanism alone against its formula: NoPE (unrotated q and k; the
  output moves with a permutation of the rows, which RoPE's does not), the
  softmax scale, the shared expert (the routed experts' output plus an
  MLP), each multiplier and the gate order. Tolerances: bitwise where the
  same operations run; rtol = atol = 1e-5 in float32 where their order
  differs.
- The benchmark's weights tree of the published config
  (``chipbench.weights._layout`` with the granite module) is the port's
  ``init_params`` tree, key for key and shape for shape; the published
  config's parameters (32,241,949,184) and useful FLOPs per token and NFE
  at S 256 (17.06 G with the shared expert) are pinned.
- The tiny config through the harness's one-shot cell on the CPU
  (``chipbench.run.run_cell``: the harness's weights, ``sample_tokens``,
  the reference's solve), correct at the tiny cells' limits.
- At default fields the port computes what it did before the fields
  existed: the reduced mamba2-2.7b, mixtral-8x7b, jamba-1.5-large and
  gemma-2b eps forwards on both routes (eps, logits, aux losses) hash to
  the values the code gave before this config was added (sha256 of the
  float32 bytes, as this CPU build of torch computes them).
"""
import dataclasses
import hashlib
import json
import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.configs.base import config_from_dict
from repro_torch.kernels import ssm_pointwise as SP
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from chipbench import flops as FL  # noqa: E402
from chipbench import weights as W  # noqa: E402
from chipbench.reference import granite as G  # noqa: E402
from chipbench.reference import model as RM  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
F32 = dict(rtol=1e-5, atol=1e-5)

TINY = {
    "name": "tiny-granite", "arch_type": "hybrid", "n_layers": 10, "d_model": 64,
    "n_heads": 4, "n_kv_heads": 2, "head_dim": 32, "d_ff": 32, "vocab_size": 128,
    "act": "silu", "glu": True, "norm_eps": 1e-5, "tie_embeddings": True,
    "attn_every": 10, "moe_every": 0,
    "moe": {"num_experts": 8, "top_k": 3, "capacity_factor": 1.25, "shared_ff": 48},
    "ssm": {"state_dim": 16, "head_dim": 16, "expand": 2, "conv_width": 4, "chunk_size": 16,
            "gate_first": True},
    "moe_dispatch": "einsum", "pos_embedding": "none", "attn_scale": 0.0625,
    "embedding_multiplier": 12.0, "residual_multiplier": 0.22, "logits_scaling": 16.0,
    "dtype": "float32", "objective": "diffusion", "time_emb_dim": 32,
}
FULL = json.loads((ROOT / "chipbench" / "configs" / "granite-4.0-h-small.json").read_text())


def _tiny(**kw):
    cfg = config_from_dict(TINY).with_(**kw)
    return cfg, T.init_params(cfg, 0, "cpu")


def _inputs(cfg, b=2, s=32, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, s, cfg.d_model), generator=g), torch.tensor([0.9, 0.3])[:b]


def _m(cfg) -> dict:
    """The config as the reference reads it (the config file's ``model``)."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def test_tiny_config_is_granite_shaped():
    cfg, params = _tiny()
    kinds = [T._layer_kind(cfg, i) for i in range(cfg.n_layers)]
    assert kinds == [("attn" if i == 5 else "ssm", "moe") for i in range(10)]
    assert set(params["blocks"][0]["moe"]["shared"]) == {"w_up", "w_gate", "w_down"}
    assert "lm_head" not in params


def test_port_matches_reference_eps_and_logits():
    """The plain route's eps and logits against the reference on one
    weight dict. The reference's logits come from its own network with the
    eps head swapped for the tied head (the port's ``forward`` logits read
    the final norm's output through that head, divided by 16)."""
    cfg, params = _tiny()
    x, t = _inputs(cfg)
    with torch.no_grad():
        got = T.forward(params, cfg, embeds=x, t_cond=t, logits=True)
        with RM.exact_float32():
            net = G.Net(params, _m(cfg))
            vl = torch.full((2,), x.shape[1])
            want_eps = net(x, t, vl)
            head = G.Net(dict(params, eps_head=params["embed"].T), _m(cfg))
            want_logits = head(x, t, vl) / cfg.logits_scaling
    torch.testing.assert_close(got["eps"], want_eps, **TOL)
    torch.testing.assert_close(got["logits"], want_logits, **TOL)
    assert float(got["eps"].std()) > 0.1        # not a near-zero output agreeing by accident


def test_reference_logits_divide_by_logits_scaling():
    cfg, params = _tiny()
    x0 = _inputs(cfg)[0] * 25.0
    net = G.Net(params, _m(cfg))
    plain = RM.Net(params, _m(cfg))
    assert torch.equal(net.logits(x0), plain.logits(x0) / 16.0)


def _attn_case(pos_embedding, scale=0.0625, seed=4):
    cfg, params = _tiny(pos_embedding=pos_embedding, attn_scale=scale)
    p = params["blocks"][5]["attn"]
    x = torch.randn((2, 12, cfg.d_model), generator=torch.Generator().manual_seed(seed))
    pos = torch.arange(12)[None].expand(2, 12)
    return cfg, p, x, pos


def _attn_formula(cfg, p, x, scale):
    b, s, _ = x.shape
    hd, nh, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(b, s, nh, hd)
    k = (x @ p["wk"]).reshape(b, s, nkv, hd).repeat_interleave(nh // nkv, 2)
    v = (x @ p["wv"]).reshape(b, s, nkv, hd).repeat_interleave(nh // nkv, 2)
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, -1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, -1) @ p["wo"]


@pytest.mark.parametrize("use_kernels", [False, True])
def test_nope_attention_is_unrotated_and_moves_with_the_rows(use_kernels):
    cfg, p, x, pos = _attn_case("none")
    out, _ = L.attention(p, cfg, x, pos, causal=False, use_kernels=use_kernels)
    torch.testing.assert_close(out, _attn_formula(cfg, p, x, cfg.attn_scale), **F32)
    perm = torch.randperm(12, generator=torch.Generator().manual_seed(1))
    moved, _ = L.attention(p, cfg, x[:, perm], pos, causal=False, use_kernels=use_kernels)
    torch.testing.assert_close(moved, out[:, perm], **F32)
    rope_cfg = cfg.with_(pos_embedding="rope")
    r_out, _ = L.attention(p, rope_cfg, x, pos, causal=False, use_kernels=use_kernels)
    r_moved, _ = L.attention(p, rope_cfg, x[:, perm], pos, causal=False,
                             use_kernels=use_kernels)
    assert not torch.allclose(r_moved, r_out[:, perm], rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError, match="rope or none"):
        L.attention(p, cfg.with_(pos_embedding="alibi"), x, pos, causal=False)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_softmax_scale_replaces_one_over_sqrt_head_dim(use_kernels):
    cfg, p, x, pos = _attn_case("none", scale=0.3)
    out, _ = L.attention(p, cfg, x, pos, causal=False, use_kernels=use_kernels)
    torch.testing.assert_close(out, _attn_formula(cfg, p, x, 0.3), **F32)
    default, _ = L.attention(p, cfg.with_(attn_scale=0.0), x, pos, causal=False,
                             use_kernels=use_kernels)
    torch.testing.assert_close(default, _attn_formula(cfg, p, x, 1 / math.sqrt(32)), **F32)
    same, _ = L.attention(p, cfg.with_(attn_scale=1 / math.sqrt(32)), x, pos, causal=False,
                          use_kernels=use_kernels)
    torch.testing.assert_close(same, default, **F32)


def test_shared_expert_adds_an_mlp_to_the_routed_experts():
    cfg, params = _tiny()
    p = params["blocks"][0]["moe"]
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(7))
    got, aux = L.moe(p, cfg, x)
    routed_cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, shared_ff=0))
    routed, routed_aux = L.moe({k: v for k, v in p.items() if k != "shared"}, routed_cfg, x)
    sh = p["shared"]
    mlp = (F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"])) @ sh["w_down"]
    assert torch.equal(got, routed + L.mlp(sh, cfg, x))
    torch.testing.assert_close(got, routed + mlp, **F32)
    assert aux.keys() == routed_aux.keys()
    assert all(torch.equal(aux[k], routed_aux[k]) for k in aux)


def test_moe_spans_and_counters():
    cfg, params = _tiny()
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(8))
    tracer = Tracer(MetricsRegistry())
    for dispatch in ("einsum", "gather"):
        with tracer.span("layer.moe"):
            out, _ = L.moe(params["blocks"][0]["moe"], cfg.with_(moe_dispatch=dispatch), x,
                           tracer)
        plain, _ = L.moe(params["blocks"][0]["moe"], cfg.with_(moe_dispatch=dispatch), x)
        assert torch.equal(out, plain)
    assert set(tracer.span_names()) == {"layer.moe"} | {
        f"layer.moe.{p}" for p in ("route", "dispatch", "experts", "combine", "shared")}
    snap = tracer.registry.snapshot()
    cap = int(1.25 * 32 * 3 / 8)
    assert snap["moe_expert_slots_total"] == 2 * (2 * 8 * cap)
    assert snap["moe_routed_pairs_total"] == 2 * (2 * 32 * 3)
    assert "moe_expert_slots_total" not in Tracer(MetricsRegistry()).registry


def test_embedding_multiplier_scales_the_input_stream():
    cfg, params = _tiny()
    x, t = _inputs(cfg)
    with torch.no_grad():
        got = T.forward(params, cfg, embeds=x, t_cond=t)
        want = T.forward(params, cfg.with_(embedding_multiplier=1.0), embeds=x * 12.0, t_cond=t)
    assert torch.equal(got["eps"], want["eps"])


def test_residual_multiplier_scales_each_branch():
    """Each branch ends in its output projection (wo, out_proj, the experts'
    and the shared expert's w_down), so multiplying those by 0.22 at
    multiplier 1 gives the multiplier's forward."""
    cfg, params = _tiny()
    x, t = _inputs(cfg)
    scaled = {**params, "blocks": []}
    for layer in params["blocks"]:
        layer = {k: dict(v) if isinstance(v, dict) else v for k, v in layer.items()}
        mixer = layer["attn"] if "attn" in layer else layer["ssm"]
        key = "wo" if "attn" in layer else "out_proj"
        mixer[key] = mixer[key] * 0.22
        layer["moe"]["w_down"] = layer["moe"]["w_down"] * 0.22
        layer["moe"]["shared"] = dict(layer["moe"]["shared"],
                                      w_down=layer["moe"]["shared"]["w_down"] * 0.22)
        scaled["blocks"].append(layer)
    with torch.no_grad():
        got = T.forward(params, cfg, embeds=x, t_cond=t)
        want = T.forward(scaled, cfg.with_(residual_multiplier=1.0), embeds=x, t_cond=t)
    torch.testing.assert_close(got["eps"], want["eps"], **F32)
    h, out = torch.randn(3, 5), torch.randn(3, 5)
    torch.testing.assert_close(T._residual(cfg, h, out), h + 0.22 * out, rtol=1e-6, atol=1e-6)
    assert torch.equal(T._residual(cfg.with_(residual_multiplier=1.0), h, out), h + out)


def test_logits_scaling_divides_the_logits():
    cfg, params = _tiny()
    x, t = _inputs(cfg)
    with torch.no_grad():
        got = T.forward(params, cfg, embeds=x, t_cond=t)["logits"]
        want = T.forward(params, cfg.with_(logits_scaling=1.0), embeds=x, t_cond=t)["logits"]
    assert torch.equal(got, want / 16.0)     # a power of two: exact


def test_rounding_anchor_ce_reads_the_scaled_logits():
    """The diffusion loss's cross-entropy through the tied head takes the
    logits divided by ``logits_scaling``, as ``forward``'s logits are."""
    from repro_torch.core import VPSDE
    from repro_torch.diffusion import lm as LM
    from repro_torch.training.steps import cross_entropy
    cfg, params = _tiny()
    sde = VPSDE()
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(2))
    t = torch.tensor([0.5, 0.2])
    eps = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        _, got = LM.diffusion_loss(params, cfg, sde, tokens, t=t, eps=eps)
        x0 = LM.token_embeddings(params, tokens)
        mu, sig = sde.mu(t)[:, None, None], sde.sigma(t)[:, None, None]
        xt = mu * x0 + sig * eps
        eps_pred = T.forward(params, cfg, embeds=xt, t_cond=t, logits=False)["eps"]
        x0_hat = (xt - sig * eps_pred) / torch.clamp(mu, min=1e-4)
        logits = (x0_hat / LM.X0_SCALE) @ params["embed"].T / 16.0
    torch.testing.assert_close(got["ce"], cross_entropy(logits, tokens, cfg), **F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_first_norm_is_the_published_order(dtype):
    g = torch.Generator().manual_seed(9)
    r = lambda *s: torch.randn(s, generator=g)
    y, xh, z = r(2, 6, 4, 16).to(dtype), r(2, 6, 4, 16).to(dtype), r(2, 6, 64).to(dtype)
    D, scale = r(4), (r(64) * 0.1).to(dtype)
    v = (y.float() + D[None, None, :, None] * xh.float()).reshape(2, 6, 64)
    gated = v * F.silu(z.float())
    first = gated * torch.rsqrt(gated.square().mean(-1, keepdim=True) + 1e-5) * (1 + scale.float())
    then = v * torch.rsqrt(v.square().mean(-1, keepdim=True) + 1e-5) * (1 + scale.float()) \
        * F.silu(z.float())
    got_first = SP.gated_norm_ref(y, xh, z, D, scale, 1e-5, gate_first=True)
    got_then = SP.gated_norm_ref(y, xh, z, D, scale, 1e-5)
    assert got_first.dtype == dtype
    assert torch.equal(got_first, first.to(dtype)) and torch.equal(got_then, then.to(dtype))
    assert torch.equal(SP.gated_norm(y, xh, z, D, scale, eps=1e-5, gate_first=True), got_first)
    assert not torch.allclose(got_first.float(), got_then.float(), rtol=1e-2, atol=1e-2)


def _shapes(tree, spec=False):
    """Each leaf's shape as a list: a tensor's or ``torch.Size`` (the port's
    tree), or a leaf spec's ``[shape, dtype, scale]`` (``spec``: the
    harness's layout)."""
    if isinstance(tree, dict):
        return {k: _shapes(v, spec) for k, v in tree.items()}
    if isinstance(tree, list) and not (spec and isinstance(tree[0], tuple)):
        return [_shapes(v, spec) for v in tree]
    return list(tree[0] if spec else getattr(tree, "shape", tree))


def test_harness_layout_is_the_ports_tree():
    """The published config's tree (the port's, from a fake init) and the
    tiny one's (a real init), key for key, in the port's order, and shape
    for shape."""
    from repro_torch.launch.dryrun import param_shapes
    for m in (FULL["model"], TINY):
        tree, _ = W._layout(m, G)
        cfg = config_from_dict(m)
        port = param_shapes(cfg) if m is FULL["model"] else T.init_params(cfg, 0, "cpu")
        assert json.dumps(_shapes(tree, spec=True)) == json.dumps(_shapes(port))


def test_published_config_counts():
    m = FULL["model"]
    assert W.n_params(m, G) == 32_241_949_184
    assert FL.per_token_forward(m, 256, G) == 17_060_573_696.0
    assert FL.sample_flops(m, 256, 10, G) * 16 == pytest.approx(702.174e12, rel=1e-5)
    cfg = config_from_dict(m)
    assert cfg == get_config("granite_4p0_h_small").with_(objective="diffusion")
    assert FULL["reduced"] == [] and FULL["arch"] == "granite"
    for key in ("hidden_size", "num_hidden_layers", "mamba_n_heads", "num_local_experts",
                "num_experts_per_tok", "shared_intermediate_size", "vocab_size"):
        assert key in FULL
    assert (FULL["hidden_size"], FULL["num_hidden_layers"], FULL["vocab_size"]) == (
        cfg.d_model, cfg.n_layers, cfg.vocab_size)
    kinds = [T._layer_kind(cfg, i)[0] for i in range(cfg.n_layers)]
    assert kinds == ["attn" if t == "attention" else "ssm" for t in FULL["layer_types"]]


def test_tiny_cell_through_the_harness(tmp_path):
    """The tiny config as a one-shot cell of the harness, on the CPU: the
    harness's weights, ``sample_tokens`` on the plain versions, and the
    reference's solve, at the tiny cells' limits."""
    from chipbench import run as R
    from chipbench.tests import _tiny
    base = _tiny.write(tmp_path)
    (base / "configs" / "tiny-granite.json").write_text(json.dumps(
        {"name": "tiny-granite", "source": "test", "arch": "granite", "reduced": [],
         "model": TINY}))
    (base / "cells" / "tiny-granite.oneshot.json").write_text(json.dumps(
        {"config": "tiny-granite", "mix": "tiny_oneshot",
         "check": {"limits": {"gap_sd": 0.01, "x0_rel": 1e-3}}}))
    res = R.run_cell("tiny-granite.oneshot", 2 ** 31 + 11, 1.0, False, device="cpu",
                     base=base, root=base)
    assert res["correct"], res["check"]
    assert res["check"]["x0_rel"]["value"] < 1e-4


# sha256 of the reduced eps forwards (both routes: eps, logits, aux) before
# the port's own fields were added, as this CPU build of torch computes them
DEFAULT_FORWARDS = {
    "mamba2_2p7b": "bd6f30fd657a1d22559442123cb16e01610d69e467191724b2e0f551c789679d",
    "mixtral_8x7b": "d26855b82fdb81ad73aaaa93223ba228d7a43456fb0fdab900bad5706e609d09",
    "jamba_1p5_large": "d1403909f23a57abc7979b8d624a6a9c6a068758247171683d08a2e33b12878d",
    "gemma_2b": "0596abd405e296e8629eb141721b64ad407311f5f95d49b0f9ddd4c6229cbfa5",
}


@pytest.mark.parametrize("arch", sorted(DEFAULT_FORWARDS))
def test_default_fields_leave_forwards_bitwise(arch):
    cfg = get_config(arch).reduced().with_(objective="diffusion")
    params = T.init_params(cfg, 0, "cpu")
    x = torch.randn((2, 24, cfg.d_model), generator=torch.Generator().manual_seed(5))
    t = torch.tensor([0.9, 0.2])
    h = hashlib.sha256()
    with torch.no_grad():
        for use_kernels in (False, True):
            out = T.forward(params, cfg, embeds=x, t_cond=t, use_kernels=use_kernels)
            for key in ("eps", "logits"):
                h.update(out[key].contiguous().numpy().tobytes())
            for key in sorted(out["aux"]):
                h.update(out["aux"][key].numpy().tobytes())
    assert h.hexdigest() == DEFAULT_FORWARDS[arch]
