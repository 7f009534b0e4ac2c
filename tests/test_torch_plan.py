"""The port's SolverPlans and splice primitives against the JAX package's.

Every leaf of every ``make_plan`` name (with the embedded error pairs) is
held to the reference at 1e-12: both are float64 numpy builders. The splice
primitives (pad/stack/take/join/inert) only copy, pad with zeros or repeat
edges, so they are held bitwise -- to the reference on the same members,
and to themselves through round-trips, mirroring the exemplar cases of
``tests/test_plan_properties.py``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import plan as RP
from repro.core import solvers as RSolvers
from repro.core import VPSDE as RVPSDE
from repro_torch.core import plan as PP
from repro_torch.core import VPSDE, get_timesteps

TOL = dict(rtol=1e-12, atol=1e-12)
SDE, RSDE = VPSDE(), RVPSDE()
_EXEMPLAR_SEEDS = [0, 1, 2, 3, 4, 5, 6, 7, 11, 13, 17, 23]
_FAMILIES = [
    ("ab_w1", ["ddim", "euler", "naive_ei"], 2),
    ("ab_w2", ["tab1", "ipndm1", "dpm2m"], 2),
    ("ab_w3", ["tab2", "ipndm2", "dpm3m"], 2),
    ("ab_w4", ["tab3", "ipndm3"], 3),
    ("stoch", ["em", "ddim_eta", "seeds1"], 2),
    ("rk2", ["rho_heun", "rho_midpoint", "dpm2", "scire2"], 2),
    ("rk3", ["rho_kutta3", "scire3"], 2),
    ("pndm", ["pndm"], 5),
    ("sn_w3", ["sndeis2"], 2),
]


def _kw(name):
    return {"eta": 0.7} if name == "ddim_eta" else {}


def _both(name, n_steps, **kw):
    ts = get_timesteps(SDE, n_steps, "quadratic")
    return (PP.make_plan(name, SDE, ts, **_kw(name), **kw),
            RP.make_plan(name, RSDE, ts, **_kw(name), **kw))


def _assert_plan_equal(port, ref, exact=True):
    """Leaf-by-leaf: same keys, same static metadata, values bitwise (or
    within 1e-12 when ``exact`` is False)."""
    assert sorted(port.coeffs) == sorted(ref.coeffs)
    for f in ("method", "stochastic", "fused", "nfe", "stacked", "error_estimate"):
        assert getattr(port, f) == getattr(ref, f), f
    pairs = [(port.ts, ref.ts)] + [(port.coeffs[k], ref.coeffs[k]) for k in ref.coeffs]
    for a, b in pairs:
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **TOL)


def test_solver_names_match():
    assert PP.SOLVER_NAMES == RSolvers.SOLVER_NAMES


@pytest.mark.parametrize("name", RSolvers.SOLVER_NAMES)
def test_make_plan_matches_reference(name):
    """Every leaf, with the embedded error pair requested, and the grid
    sizing helper."""
    port, ref = _both(name, 12 if name == "pndm" else 7, error_estimate=True)
    _assert_plan_equal(port, ref, exact=False)
    assert port.history_len == ref.history_len
    assert PP.solver_stages(name) == RP.solver_stages(name)


def _scenario(seed):
    rng = np.random.RandomState(seed)
    _, names, lo = _FAMILIES[rng.randint(len(_FAMILIES))]
    k = rng.randint(2, 5)
    picks = [(names[rng.randint(len(names))], int(rng.randint(lo, lo + 6)))
             for _ in range(k)]
    return rng, names, lo, picks


def _stack_both(picks, n_max):
    port = PP.stack_plans([PP.pad_plan(_both(nm, n)[0], n_max) for nm, n in picks])
    ref = RP.stack_plans([RP.pad_plan(_both(nm, n)[1], n_max) for nm, n in picks])
    return port, ref


@pytest.mark.parametrize("seed", _EXEMPLAR_SEEDS)
def test_splices_match_reference_bitwise(seed):
    """pad -> stack -> take -> join -> inert on the same members gives the
    reference's leaves bitwise, and the port's splices round-trip."""
    rng, names, lo, picks = _scenario(seed)
    n_max = max(n for _, n in picks)
    port, ref = _stack_both(picks, n_max)
    _assert_plan_equal(port, ref)
    assert port.batch == len(picks) and port.n_steps == n_max

    rows = [int(i) for i in rng.permutation(len(picks))[:rng.randint(1, len(picks) + 1)]]
    _assert_plan_equal(PP.take_rows(port, rows), RP.take_rows(ref, rows))

    joiners = [(names[rng.randint(len(names))], int(rng.randint(lo, n_max + 1)))
               for _ in range(rng.randint(1, 3))]
    joined = PP.join_rows(port, [_both(nm, n)[0] for nm, n in joiners])
    _assert_plan_equal(joined, RP.join_rows(ref, [_both(nm, n)[1] for nm, n in joiners]))
    R = port.batch
    _assert_plan_equal(PP.take_rows(joined, list(range(R))), ref)   # round-trip
    native = PP.stack_plans([PP.pad_plan(_both(nm, n)[0], n_max)
                             for nm, n in picks + joiners])
    assert joined.signature == native.signature

    member, member_ref = _both(*picks[0])
    filler = PP.inert_row(member)
    _assert_plan_equal(filler, RP.inert_row(member_ref))
    assert filler.signature == member.signature and filler.nfe == 0
    assert member.family == PP.pad_plan(member, member.n_steps + 2).family


def test_novel_coeff_key_roundtrips_all_splices():
    """Keys no registry names are classified by shape: per-step zero-padded,
    per-knot edge-replicated, static untouched, through pad -> stack ->
    join -> take and inert_row."""
    rng = np.random.RandomState(3)
    n, pad = 5, 2

    def novel(p, static_len=None):
        extra = {"zeta_novel": torch.from_numpy(rng.randn(p.n_steps, 2)),
                 "knotv_novel": torch.from_numpy(rng.randn(p.n_steps + 1)),
                 "tableau_novel": torch.from_numpy(rng.randn(static_len or n + 3))}
        return dataclasses.replace(p, coeffs={**p.coeffs, **extra})

    p = novel(_both("tab2", n)[0])
    padded = PP.pad_plan(p, n + pad)
    z = padded.coeffs["zeta_novel"]
    assert torch.equal(z[:n], p.coeffs["zeta_novel"]) and not z[n:].any()
    kv = padded.coeffs["knotv_novel"]
    assert torch.equal(kv[:n + 1], p.coeffs["knotv_novel"])
    assert torch.equal(kv[n + 1:], kv[n].expand(pad))
    assert torch.equal(padded.coeffs["tableau_novel"], p.coeffs["tableau_novel"])
    stacked = PP.stack_plans([padded, PP.pad_plan(novel(_both("tab2", n)[0]), n + pad)])
    joiner = novel(_both("tab2", 4)[0], static_len=n + 3)
    joined = PP.join_rows(stacked, [joiner])
    back = PP.take_rows(joined, [0, 1])
    for k in stacked.coeffs:
        assert torch.equal(back.coeffs[k], stacked.coeffs[k])
    row = PP.take_rows(joined, [2])
    want = PP.stack_plans([PP.pad_plan(joiner, n + pad)])
    for k in want.coeffs:
        assert torch.equal(row.coeffs[k], want.coeffs[k])
    filler = PP.inert_row(p)
    assert not filler.coeffs["zeta_novel"].any()
    assert torch.equal(filler.coeffs["tableau_novel"], p.coeffs["tableau_novel"])


def test_splices_reject_what_the_reference_rejects():
    p6, _ = _both("ddim", 6)
    p8, _ = _both("ddim", 8)
    t3, _ = _both("tab3", 6)
    stacked = PP.stack_plans([p6, p6])
    with pytest.raises(ValueError, match="stacked"):
        PP.join_rows(p6, [p6])
    with pytest.raises(ValueError, match="horizon"):
        PP.join_rows(stacked, [p8])
    with pytest.raises(ValueError, match="family"):
        PP.join_rows(stacked, [t3])
    with pytest.raises(ValueError, match="signatures"):
        PP.stack_plans([p6, t3])
    with pytest.raises(ValueError, match="down"):
        PP.pad_plan(p8, 6)
    with pytest.raises(ValueError, match="non-empty"):
        PP.take_rows(stacked, [])


def test_cached_make_plan_and_device_cast():
    ts = get_timesteps(SDE, 6, "quadratic")
    a = PP.cached_make_plan("tab2", SDE, ts, error_estimate=True)
    assert PP.cached_make_plan("tab2", SDE, ts, error_estimate=True) is a
    f32 = a.to("cpu", torch.float32)
    assert f32.ts.dtype == torch.float32 and f32.coeffs["C"].dtype == torch.float32
    assert f32.astype(torch.float32) is f32
    assert a.coeffs["C"].dtype == torch.float64      # the cached plan is untouched
    np.testing.assert_array_equal(f32.coeffs["C"].numpy(),
                                  np.asarray(jax.numpy.asarray(a.coeffs["C"].numpy(),
                                                               np.float32)))
