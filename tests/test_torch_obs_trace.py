"""The port's span tracer (``repro_torch.obs.trace``) and the one-shot
path's spans: ``sample_tokens`` > ``sample.step`` > ``eps`` > the layers'
spans > the SSM mixer's and the MoE's parts, and ``decode``.

What is held: dotted paths and nesting; ``NULL_TRACER`` records nothing and
enters no ``torch.profiler`` range; ``annotate=True`` puts each span in a
CPU profile under its path; a traced call computes bitwise what an
untraced one does; each span runs as often as the solve says (steps, NFE,
NFE x layers); and the work of a phase lies inside its span in the profile.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as P
from repro_torch.configs import get_config
from repro_torch.diffusion import lm as PLM
from repro_torch.models.transformer import init_params
from repro_torch.obs import trace as OT
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer

BATCH, SEQ, N_STEPS = 2, 16, 4
ROOT = "sample_tokens"
STEP = f"{ROOT}.sample.step"
EPS = f"{STEP}.eps"
SSM_PARTS = ("in_proj", "pre", "scan", "post", "out_proj")
# the MoE layer's spans (a shared expert adds "shared"; mixtral has none)
MOE_PARTS = ("route", "dispatch", "experts", "combine")


def _setup(arch="mamba2_2p7b", solver="tab3", fused=True):
    cfg = get_config(arch).reduced().with_(objective="diffusion", dtype="float32")
    params = init_params(cfg, 0, "cpu")
    sde = P.VPSDE()
    plan = P.make_plan(solver, sde, P.get_timesteps(sde, N_STEPS, "quadratic"),
                       **({"fused": True} if fused else {}))
    return cfg, params, plan, sde


def _run(cfg, params, plan, sde, *, use_kernels=False, **kw):
    gens = tuple(torch.Generator().manual_seed(s) for s in (11, 12))
    with torch.no_grad():
        return PLM.sample_tokens(params, cfg, plan, gens, batch=BATCH, seq_len=SEQ,
                                 prior_std=sde.prior_std(), use_kernels=use_kernels, **kw)


def _profile(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns(), e.end_ns(), e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()]


def _count(reg, path):
    h = reg.get(f"trace_{path}_seconds")
    return 0 if h is None else h.count


# ------------------------------------------------------------------ the tracer
def test_spans_nest_into_dotted_paths():
    reg = MetricsRegistry()
    tr = Tracer(reg)
    with tr.span("a"):
        with tr.span("b.c"):
            with tr.span("d"):
                pass
        with tr.span("b.c"):
            pass
    with tr.span("a"):
        pass
    assert tr.span_names() == ["a", "a.b.c", "a.b.c.d"]
    assert (_count(reg, "a"), _count(reg, "a.b.c"), _count(reg, "a.b.c.d")) == (2, 2, 1)
    assert tr._current() == ""


def test_span_path_unwinds_after_an_exception():
    tr = Tracer(MetricsRegistry())
    with pytest.raises(RuntimeError):
        with tr.span("outer"):
            with tr.span("inner"):
                raise RuntimeError("boom")
    assert tr._current() == ""
    assert tr.span_names() == ["outer", "outer.inner"]


def test_null_tracer_records_nothing_and_enters_no_profiler_range(monkeypatch):
    def refuse(_name):
        raise AssertionError("NULL_TRACER entered a record_function range")
    monkeypatch.setattr(OT, "_record_function", refuse)
    assert NULL_TRACER.span("x") is NULL_TRACER.span("y")      # one shared no-op
    with NULL_TRACER.span("a"):
        with NULL_TRACER.span("b"):
            pass
    cfg, params, plan, sde = _setup()
    _run(cfg, params, plan, sde)
    assert NULL_TRACER.span_names() == []
    assert list(NULL_TRACER.registry) == []


def test_untraced_call_leaves_no_range_in_a_profile():
    cfg, params, plan, sde = _setup()
    evs = _profile(lambda: _run(cfg, params, plan, sde))
    assert [n for n, _, _, ann in evs if ann] == []


def test_annotated_spans_are_profiler_ranges_by_path():
    reg = MetricsRegistry()
    tr = Tracer(reg, annotate=True)

    def body():
        with tr.span("outer"):
            with tr.span("inner"):
                torch.ones(4).sum()
    evs = _profile(body)
    ranges = {n: (s, e) for n, s, e, ann in evs if ann}
    assert set(ranges) == {"outer", "outer.inner"}
    (os_, oe), (is_, ie) = ranges["outer"], ranges["outer.inner"]
    assert os_ <= is_ <= ie <= oe
    assert _count(reg, "outer.inner") == 1


# ---------------------------------------------------------- the one-shot path
@pytest.mark.parametrize("use_kernels", [False, True])
def test_traced_sample_is_bitwise_the_untraced_one(use_kernels):
    cfg, params, plan, sde = _setup()
    toks, x0 = _run(cfg, params, plan, sde, use_kernels=use_kernels)
    tr = Tracer(MetricsRegistry(), annotate=True)
    toks_t, x0_t = _run(cfg, params, plan, sde, use_kernels=use_kernels, tracer=tr)
    assert torch.equal(toks, toks_t)
    assert torch.equal(x0, x0_t)
    assert tr.span_names()                      # it did trace


def _expected_tree(layer_spans):
    return sorted([ROOT, STEP, EPS, f"{ROOT}.decode"]
                  + [f"{EPS}.{s}" for s in layer_spans])


@pytest.mark.parametrize("arch,layer_spans", [
    ("mamba2_2p7b", ["layer.norm", "layer.ssm"] + [f"layer.ssm.{p}" for p in SSM_PARTS]),
    ("gemma_2b", ["layer.norm", "layer.attn", "layer.mlp"]),
    ("mixtral_8x7b", ["layer.norm", "layer.attn", "layer.moe"]
     + [f"layer.moe.{p}" for p in MOE_PARTS]),
])
def test_span_tree_of_the_one_shot_path(arch, layer_spans):
    cfg, params, plan, sde = _setup(arch)
    tr = Tracer(MetricsRegistry())
    _run(cfg, params, plan, sde, tracer=tr)
    assert tr.span_names() == _expected_tree(layer_spans)


@pytest.mark.parametrize("solver,fused", [("tab3", True), ("rho_heun", False)])
def test_span_counts_follow_steps_nfe_and_layers(solver, fused):
    cfg, params, plan, sde = _setup(solver=solver, fused=fused)
    reg = MetricsRegistry()
    _run(cfg, params, plan, sde, tracer=Tracer(reg))
    steps, nfe = plan.n_steps, plan.n_steps * P.solver_stages(solver)
    assert _count(reg, ROOT) == 1
    assert _count(reg, f"{ROOT}.decode") == 1
    assert _count(reg, STEP) == steps
    assert _count(reg, EPS) == nfe
    assert _count(reg, f"{EPS}.layer.ssm") == nfe * cfg.n_layers
    assert _count(reg, f"{EPS}.layer.norm") == nfe * cfg.n_layers
    for part in SSM_PARTS:
        assert _count(reg, f"{EPS}.layer.ssm.{part}") == nfe * cfg.n_layers


def _inside(evs, op, suffix):
    """For each ``op`` event, whether it lies in a range whose path ends
    with ``suffix``."""
    ranges = [(s, e) for n, s, e, ann in evs if ann and n.endswith(suffix)]
    return [any(s <= a and b <= e for s, e in ranges)
            for n, a, b, ann in evs if not ann and n == op]


def test_work_lies_inside_its_span_in_a_cpu_profile():
    cfg, params, plan, sde = _setup()
    tr = Tracer(MetricsRegistry(), annotate=True)
    evs = _profile(lambda: _run(cfg, params, plan, sde, tracer=tr))
    # the plain scan's cumulative sum runs in the scan alone
    scan = _inside(evs, "aten::cumsum", ".layer.ssm.scan")
    assert len(scan) == plan.n_steps * cfg.n_layers and all(scan)
    # the LM head's product and the argmax run in decode
    assert all(_inside(evs, "aten::argmax", f"{ROOT}.decode"))
    assert sum(_inside(evs, "aten::matmul", f"{ROOT}.decode")) == 1
    # the in-projection and the out-projection lie in their own spans
    assert any(_inside(evs, "aten::matmul", ".layer.ssm.in_proj"))
    assert any(_inside(evs, "aten::matmul", ".layer.ssm.out_proj"))


def test_decode_cache_update_traces_under_the_same_spans():
    """The SSM decode update (one token against the cache) runs under the
    same five spans; a traced update equals an untraced one."""
    from repro_torch.models import ssm as S
    cfg, params, _, _ = _setup()
    bp = params["blocks"][0]["ssm"]
    x = torch.randn((BATCH, 1, cfg.d_model), generator=torch.Generator().manual_seed(3))
    d_inner, n_heads = S.ssm_dims(cfg)
    cache = {"conv": torch.zeros((BATCH, cfg.ssm.conv_width - 1, d_inner + 2 * cfg.ssm.state_dim)),
             "state": torch.randn((BATCH, n_heads, cfg.ssm.head_dim, cfg.ssm.state_dim))}
    reg = MetricsRegistry()
    out, new = S.ssm_forward(bp, cfg, x, cache=cache)
    out_t, new_t = S.ssm_forward(bp, cfg, x, cache=cache, tracer=Tracer(reg))
    assert torch.equal(out, out_t) and torch.equal(new["state"], new_t["state"])
    assert [_count(reg, p) for p in SSM_PARTS] == [1] * len(SSM_PARTS)
    assert np.isfinite(out.numpy()).all()
