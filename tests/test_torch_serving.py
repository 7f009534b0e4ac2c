"""Serving: the port's one-shot stream against the JAX package's, and the
port engine's invariants on the CPU (reduced gemma-2b, float32).

Across frameworks: the same deterministic plan from the same prior (the
reference's draw, injected) through the same weights; x0 is held to
rtol = atol = 1e-4 (float32 eps-net and solver round-off accumulated over
6 steps) and the decoded tokens must be equal. Within the port: every
served row is bitwise its solo solve, whatever it was batched, joined or
compacted with; a warm replay builds no executor; submitted = completed +
evicted + cancelled."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.gemma_2b import get_config as ref_config
from repro.core import VPSDE as RVPSDE
from repro.core import make_plan as ref_make_plan
from repro.core import stack_plans as ref_stack
from repro.diffusion import lm as RLM
from repro.models.transformer import init_params as ref_init
from repro_torch.configs import get_config
from repro_torch.core import RetirePolicy, VPSDE, get_timesteps, make_plan, stack_plans
from repro_torch.diffusion import lm as PLM
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import DiffusionServeEngine, Request

X0_TOL = dict(rtol=1e-4, atol=1e-4)
CFG = get_config("gemma_2b").reduced().with_(objective="diffusion")


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, 0, "cpu")


@pytest.mark.parametrize("name", ["tab3", "dpm2m", "sndeis2"])
def test_stream_matches_reference(name):
    rcfg = ref_config().reduced().with_(objective="diffusion")
    rp = ref_init(rcfg, jax.random.PRNGKey(0))
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), CFG, "cpu")
    ts = get_timesteps(VPSDE(), 6, "quadratic")
    rplan = ref_stack([ref_make_plan(name, RVPSDE(), ts)])
    keys = RLM.request_keys([7])
    x_T = RLM.init_sample_state(rcfg, rplan, keys, seq_len=12, prior_std=1.0).x
    toks_r, x0_r = RLM.sample_tokens_stream(rp, rcfg, rplan, keys, seq_len=12,
                                            prior_std=1.0)
    toks_p, x0_p = PLM.sample_tokens_stream(
        pp, CFG, stack_plans([make_plan(name, VPSDE(), ts)]), None, seq_len=12,
        prior_std=1.0, x_T=torch.from_numpy(np.array(x_T)))
    np.testing.assert_allclose(x0_p.numpy(), np.asarray(x0_r), **X0_TOL)
    np.testing.assert_array_equal(toks_p.numpy(), np.asarray(toks_r))


# (tick, request), in tick order: ragged NFEs, mixed families, two
# buckets. ddim and seeds2 carry no error pair (they never exit early), so
# with or without a RetirePolicy request 1 retires at tick 2 and request 6
# joins its group at tick 3, and request 10 retires at tick 1 and its group
# compacts at tick 2.
_TRAFFIC = [
    (0, Request(uid=0, solver="ddim", nfe=5, seq_len=16, seed=1)),
    (0, Request(uid=1, solver="ddim", nfe=3, seq_len=12, seed=2)),
    (0, Request(uid=2, solver="dpm2m", nfe=4, seq_len=7, seed=3)),
    (0, Request(uid=3, solver="seeds2", nfe=4, seq_len=16, seed=4)),
    (0, Request(uid=10, solver="seeds2", nfe=2, seq_len=14, seed=11)),
    (0, Request(uid=11, solver="tab2", nfe=5, seq_len=16, seed=12)),
    (1, Request(uid=4, solver="rho_heun", nfe=6, seq_len=8, seed=5)),
    (1, Request(uid=5, solver="sndeis2", nfe=5, seq_len=16, seed=6)),
    (3, Request(uid=6, solver="ddim", nfe=2, seq_len=9, seed=7)),
    (4, Request(uid=7, solver="seeds2", nfe=3, seq_len=10, seed=8)),
    (4, Request(uid=8, solver="em", nfe=3, seq_len=16, seed=9)),
    (6, Request(uid=9, solver="tab2", nfe=3, seq_len=16, seed=10)),
]


def _engine(params, **kw):
    return DiffusionServeEngine(params, CFG, seq_len_buckets=(8, 16), max_group=4,
                                device="cpu", **kw)


def _run(eng, traffic):
    out, i, t = {}, 0, 0
    while i < len(traffic) or eng.busy:
        while i < len(traffic) and traffic[i][0] <= t:
            eng.submit(traffic[i][1])
            i += 1
        for r in eng.tick():
            out[r.uid] = r
        t += 1
    return out


@pytest.mark.parametrize("retire", [None, RetirePolicy(tol=1.0, min_k=2)])
def test_engine_rows_bitwise_vs_solo_and_warm_replay(params, retire):
    eng = _engine(params, retire=retire)
    got = _run(eng, _TRAFFIC)
    assert sorted(got) == sorted(q.uid for _, q in _TRAFFIC)
    assert eng.joined_requests >= 1 and eng.metrics.get("serve_compactions_total").value >= 1
    assert eng.wasted_row_steps == 0
    for _, q in _TRAFFIC:
        solo = _engine(params, retire=retire).serve([q])[0]
        r = got[q.uid]
        assert r.tokens.shape == (q.seq_len,)
        np.testing.assert_array_equal(r.tokens, solo.tokens)
        assert (r.nfe, r.early_exit, r.final_err) == (solo.nfe, solo.early_exit, solo.final_err)
    misses = eng.metrics.get("serve_compile_cache_misses_total").value
    warm = _run(eng, _TRAFFIC)
    assert eng.metrics.get("serve_compile_cache_misses_total").value == misses
    for uid, r in got.items():
        np.testing.assert_array_equal(warm[uid].tokens, r.tokens)


def test_retire_policy_exits_sndeis_rows_early(params):
    """The reference fuzz suite's policy retires score-normalized rows
    before their budget; the saved evals are counted."""
    eng = _engine(params, retire=RetirePolicy(tol=1.0, min_k=2))
    res = eng.serve([Request(uid=i, solver="sndeis2", nfe=8, seq_len=16, seed=i)
                     for i in range(3)])
    early = [r for r in res if r.early_exit]
    assert early and all(r.nfe < 8 and r.final_err is not None for r in early)
    snap = eng.metrics.snapshot()
    assert snap["serve_saved_nfe_total"] == sum(8 - r.nfe for r in early)


def test_conservation_with_cancel_and_deadlines(params):
    eng = _engine(params, enforce_deadlines=True)
    eng.submit(Request(uid=0, solver="tab2", nfe=4, seq_len=8, seed=0))
    eng.submit(Request(uid=1, solver="tab2", nfe=4, seq_len=8, seed=1))
    eng.submit(Request(uid=2, solver="tab2", nfe=4, seq_len=8, seed=2, deadline_s=0.0))
    eng.submit(Request(uid=3, solver="ddim", nfe=4, seq_len=8, seed=3))
    assert eng.cancel(3) and not eng.cancel(99)
    res = eng.tick()
    assert eng.cancel(1)
    while eng.busy:
        res += eng.tick()
    by = {r.uid: r for r in res}
    assert by[2].deadline_exceeded and by[3].cancelled and by[1].cancelled
    assert by[0].tokens.shape == (8,) and not by[0].cancelled
    s = eng.metrics.snapshot()
    assert s["serve_submitted_total"] == 4
    assert s["serve_submitted_total"] == (s["serve_completed_total"]
                                          + s["serve_deadline_evicted_total"]
                                          + s["serve_cancelled_total"])


def test_engine_defaults_to_cuda_and_validates(params):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DiffusionServeEngine(params, CFG)
    eng = _engine(params)
    with pytest.raises(ValueError, match="eta"):
        eng.submit(Request(uid=0, solver="ddim_eta"))
    with pytest.raises(ValueError, match="seq_len"):
        eng.submit(Request(uid=0, seq_len=0))
    assert not eng.busy
    assert eng._plan("tab3", 6, None).fused and eng._plan("tab3", 6, None).ts.dtype == torch.float32
