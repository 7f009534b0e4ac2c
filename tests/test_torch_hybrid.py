"""The moe and hybrid archs in the port against the JAX package: the layer
pattern of the published configs, the eps forward (eps, logits and the MoE
aux losses) of reduced mixtral-8x7b, grok-1 and jamba-1.5-large (8 layers:
7 Mamba2 mixers and one attention layer, MoE on odd slots) on both routes,
the block/slot layout of their parameters and checkpoints, a served
mixtral request, and the launcher on all three.

Tolerances: eps, logits and aux at float32 rtol = atol = 1e-5 (summation
order); the served x0 at rtol = atol = 1e-4 (6 solver steps of that);
tokens equal; within the port a stacked row is bitwise its solo solve.
Prefill-then-decode and the cache layouts of mixtral and jamba are held
in ``tests/test_torch_ar.py`` with the other archs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.core import VPSDE as RVPSDE
from repro.core import make_plan as ref_make_plan
from repro.core import stack_plans as ref_stack
from repro.diffusion import lm as RLM
from repro.models import transformer as RT
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import VPSDE, get_timesteps, make_plan, stack_plans
from repro_torch.diffusion import lm as PLM
from repro_torch.launch.serve import main
from repro_torch.models import transformer as PT
from repro_torch.models.convert import layers_per_block, params_from_numpy, params_to_numpy
from repro_torch.serving.engine import DiffusionServeEngine, Request
from test_torch_configs import as_reference

F32 = dict(rtol=1e-5, atol=1e-5)
NEW = ["mixtral_8x7b", "grok_1_314b", "jamba_1p5_large"]


def _models(arch, **kw):
    rcfg = ref_get_config(arch).reduced().with_(objective="diffusion", **kw)
    pcfg = get_config(arch).reduced().with_(objective="diffusion", **kw)
    rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, pcfg, rp, params_from_numpy(jax.tree.map(np.asarray, rp), pcfg, "cpu")


@pytest.mark.parametrize("arch", NEW)
def test_configs_match_reference(arch):
    assert arch in ARCH_IDS
    for full in (True, False):
        r, p = ref_get_config(arch), get_config(arch)
        if not full:
            r, p = r.reduced(), p.reduced()
        assert as_reference(p) == dataclasses.asdict(r)


@pytest.mark.parametrize("arch", ["jamba_1p5_large", "mixtral_8x7b", "grok_1_314b",
                                  "mamba2_2p7b", "gemma_2b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_layer_kinds_match_reference(arch, reduced):
    """Every layer's (mixer, mlp) kind of the published config (jamba: all 72
    layers) is the reference's kind of its slot; is_attn_layer and
    is_moe_layer agree with the reference's."""
    rcfg, pcfg = ref_get_config(arch), get_config(arch)
    if reduced:
        rcfg, pcfg = rcfg.reduced(), pcfg.reduced()
    bs = RT.block_size(rcfg)
    assert PT.block_size(pcfg) == bs and PT.n_blocks(pcfg) == RT.n_blocks(rcfg)
    kinds = [PT._layer_kind(pcfg, i) for i in range(pcfg.n_layers)]
    assert kinds == [RT._layer_kind(rcfg, i % bs) for i in range(rcfg.n_layers)]
    for i in range(pcfg.n_layers):
        assert pcfg.is_attn_layer(i) == rcfg.is_attn_layer(i)
        assert pcfg.is_moe_layer(i) == rcfg.is_moe_layer(i)
    if arch == "jamba_1p5_large" and not reduced:
        assert len(kinds) == 72 and bs == 8
        assert sum(m == "attn" for m, _ in kinds) == 9          # 1:7 attention:mamba
        assert [i for i, (m, _) in enumerate(kinds[:8]) if m == "attn"] == [4]
        assert sum(f == "moe" for _, f in kinds) == 36          # every odd layer
    if arch == "mixtral_8x7b":
        assert set(kinds) == {("attn", "moe")}


@pytest.mark.parametrize("arch,use_kernels,dispatch", [
    ("mixtral_8x7b", False, "einsum"), ("mixtral_8x7b", True, "einsum"),
    ("mixtral_8x7b", False, "gather"), ("grok_1_314b", False, "einsum"),
    ("jamba_1p5_large", False, "einsum"), ("jamba_1p5_large", True, "einsum"),
    ("jamba_1p5_large", True, "gather")])
def test_forward_matches_reference(arch, use_kernels, dispatch):
    """eps, logits and the summed aux losses of the eps forward against the
    reference's with ``use_pallas`` set alike (on the CPU the kernel route
    runs K2's and K3's plain versions; the reference its Pallas kernels in
    interpret mode). S = 40 is not a multiple of jamba's chunk 16."""
    rcfg, pcfg, rp, pp = _models(arch, moe_dispatch=dispatch)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 40, pcfg.d_model).astype(np.float32)
    t = np.array([0.8, 0.3], np.float32)
    want = RT.forward(rp, rcfg, embeds=jnp.asarray(x), t_cond=jnp.asarray(t),
                      use_pallas=use_kernels)
    with torch.no_grad():
        got = PT.forward(pp, pcfg, embeds=torch.from_numpy(x), t_cond=torch.from_numpy(t),
                         use_kernels=use_kernels)
    np.testing.assert_allclose(got["eps"].numpy(), np.asarray(want["eps"]), **F32)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), **F32)
    assert set(got["aux"]) == set(want["aux"]) == {"moe_lb", "moe_z"}
    for k, v in want["aux"].items():
        np.testing.assert_allclose(got["aux"][k].item(), float(v), **F32)


def test_grok_kernel_route_refuses_softcap():
    """K2 has no softcap; the reference's ``use_pallas`` drops it (ROADMAP
    Queue 3), the port raises."""
    _, pcfg, _, pp = _models("grok_1_314b")
    x, t = torch.zeros(1, 8, pcfg.d_model), torch.tensor(0.5)
    with pytest.raises(ValueError, match="softcap"):
        PLM.make_eps_fn(pp, pcfg, use_kernels=True)(x, t)


def test_dense_forward_has_no_aux():
    _, pcfg, _, pp = _models("gemma_2b")
    out = PT.forward(pp, pcfg, embeds=torch.zeros(1, 4, pcfg.d_model), t_cond=torch.tensor(0.5))
    assert out["aux"] == {}


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_restacks_exactly(arch, dtype):
    """params_to_numpy(params_from_numpy(tree)) is the reference's tree,
    leaf for leaf and byte for byte; layer i is slot i % bs of block i // bs."""
    rcfg, pcfg, rp, pp = _models(arch, dtype=dtype)
    tree = jax.tree.map(np.asarray, rp)
    bs = RT.block_size(rcfg)
    assert layers_per_block(pp["blocks"]) == bs and len(pp["blocks"]) == pcfg.n_layers
    assert sorted(tree["blocks"]) == [f"slot{j}" for j in range(bs)]
    for i, layer in enumerate(pp["blocks"]):
        slot = tree["blocks"][f"slot{i % bs}"]
        assert set(layer) == set(slot)
        w = slot["norm1"][i // bs].astype(np.float32)
        np.testing.assert_array_equal(layer["norm1"].float().numpy(), w)
    back = params_to_numpy(pp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", ["jamba_1p5_large", "mixtral_8x7b"])
def test_init_params_structure_matches_reference(arch):
    """init_params gives every layer its kind's leaves with the reference's
    shapes and dtypes (jamba: ssm layers with norm2 and mlp or moe)."""
    _, pcfg, _, pp = _models(arch)
    mine = PT.init_params(pcfg, 0, "cpu")
    assert len(mine["blocks"]) == len(pp["blocks"])
    for a, b in zip(mine["blocks"], pp["blocks"]):
        assert jax.tree.map(lambda t: (tuple(t.shape), t.dtype), a) == \
            jax.tree.map(lambda t: (tuple(t.shape), t.dtype), b)
    if arch == "jamba_1p5_large":
        assert set(mine["blocks"][0]) == {"norm1", "ssm", "norm2", "mlp"}
        assert set(mine["blocks"][1]) == {"norm1", "ssm", "norm2", "moe"}
        assert set(mine["blocks"][4]) == {"norm1", "attn", "norm2", "mlp"}


def test_unported_archs_raise():
    """Every arch_type of the reference is ported; an unknown one raises in
    init, cache and forward rather than run as dense."""
    cfg = get_config("gemma_2b").reduced().with_(arch_type="retnet")
    with pytest.raises(ValueError, match="unknown arch_type 'retnet'"):
        PT.init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="unknown arch_type"):
        PT.init_cache(cfg, 1, 8, device="cpu")
    pp = PT.init_params(get_config("gemma_2b").reduced(), 0, "cpu")
    with pytest.raises(ValueError, match="unknown arch_type"):
        PT.forward(pp, cfg, tokens=torch.zeros(1, 4, dtype=torch.long))


@pytest.fixture(scope="module")
def mixtral():
    return _models("mixtral_8x7b")


def test_served_mixtral_stream_matches_reference(mixtral):
    """The one-shot stream of a deterministic stacked plan from the
    reference's prior: x0 allclose to the reference's, tokens equal."""
    rcfg, pcfg, rp, pp = mixtral
    ts = get_timesteps(VPSDE(), 6, "quadratic")
    rplan = ref_stack([ref_make_plan("tab3", RVPSDE(), ts)] * 2)
    keys = RLM.request_keys([7, 8])
    x_T = RLM.init_sample_state(rcfg, rplan, keys, seq_len=12, prior_std=1.0).x
    toks_r, x0_r = RLM.sample_tokens_stream(rp, rcfg, rplan, keys, seq_len=12, prior_std=1.0)
    toks_p, x0_p = PLM.sample_tokens_stream(
        pp, pcfg, stack_plans([make_plan("tab3", VPSDE(), ts)] * 2), None, seq_len=12,
        prior_std=1.0, x_T=torch.from_numpy(np.array(x_T)))
    np.testing.assert_allclose(x0_p.numpy(), np.asarray(x0_r), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(toks_p.numpy(), np.asarray(toks_r))


def test_served_mixtral_rows_bitwise_solo(mixtral):
    """Through DiffusionServeEngine (buckets 8 and 16, a join): every row is
    bitwise its request served alone; MoE capacity is per row over the
    bucket's S, the padded tail included, as in the reference."""
    _, pcfg, _, pp = mixtral
    reqs = [Request(uid=0, solver="tab3", nfe=6, seq_len=16, seed=1),
            Request(uid=1, solver="ddim", nfe=3, seq_len=12, seed=2),
            Request(uid=2, solver="dpm2m", nfe=5, seq_len=14, seed=3),
            Request(uid=3, solver="ddim", nfe=4, seq_len=7, seed=4)]
    eng = DiffusionServeEngine(pp, pcfg, seq_len_buckets=(8, 16), max_group=4, device="cpu")
    for q in reqs[:3]:
        eng.submit(q)
    results = eng.tick()
    eng.submit(reqs[3])
    while eng.busy:
        results += eng.tick()
    got = {r.uid: r.tokens for r in results}
    assert sorted(got) == [0, 1, 2, 3]
    for q in reqs:
        solo = DiffusionServeEngine(pp, pcfg, seq_len_buckets=(8, 16), device="cpu")
        want = solo.serve([q])[0].tokens
        assert want.shape == (q.seq_len,)
        np.testing.assert_array_equal(got[q.uid], want)


@pytest.mark.parametrize("arch", NEW)
def test_launcher_serves_new_archs(capsys, arch):
    """``python -m repro_torch.launch.serve --arch <arch> --reduced --device
    cpu`` in the diffusion mode (the AR mode is in
    ``tests/test_torch_launch.py``): the printed tokens are the engine's."""
    main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "2", "--nfe", "4",
          "--seq-len", "8", "--solver", "tab2"])
    out = capsys.readouterr().out
    assert "served 2 requests" in out
    cfg = get_config(arch).reduced().with_(objective="diffusion")
    res = DiffusionServeEngine(PT.init_params(cfg, 0, "cpu"), cfg, device="cpu").serve(
        [Request(uid=i, seq_len=8, nfe=4, solver="tab2", seed=i) for i in range(2)])
    for r in res:
        assert f"tokens[:10]={r.tokens[:10]}" in out
