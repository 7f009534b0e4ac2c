"""Whether what the timed path produced is correct: the plain reference
(:mod:`chipbench.reference`) recomputes a sample of the window's outputs
from the same seeds and weights, after the window, and each number named
in the cell file's ``check.limits`` is held to its limit.

Numbers, over the sampled outputs' tokens, each judged by the float32
reference's logits at its position (its gap: how far the token's logit
lies below the reference's best there, in units of that position's logit
standard deviation; 0 where the token is the reference's argmax):
- ``gap_sd``: the widest gap;
- ``gap_mean``: the mean gap over all sampled tokens;
- ``mismatch``: the share of sampled tokens that are not the reference's
  argmax;
- ``x0_rel`` (one-shot only): the relative L2 distance of the program's
  solved embeddings x0 from the reference's, over the sampled call.

A served cell's sample, drawn from the seed among the requests finished
after the window opened (drained ones included): the longest (length, then
NFE), one of each solver present, then others until ``sample_tokens``
served tokens; a one-shot cell's: one call of the window, drawn from the
seed. The control (:func:`control_served`, :func:`control_oneshot`) is the
reference computed with float8 products in the program's place, judged the
same way; "bf16" gives a witness of the program's own precision.

The reference network is the ``Net`` of the configuration's reference
module (``arch``: :func:`chipbench.spec.arch_module`, default
:mod:`chipbench.reference.model`); the solve and the decode's judgement are
the same for every architecture.
"""
from __future__ import annotations

import numpy as np
import torch

from . import spec as S
from .reference import model as R
from .reference import quadrature as Q


def served_sample(records, w0: float, seed: int, want_tokens: int) -> list:
    done = [r for r in records if r.ok and r.done >= w0]
    if not done:
        return []
    rng = np.random.default_rng([int(seed) % 2 ** 63, 5])
    order = [done[i] for i in rng.permutation(len(done))]
    pick = [max(order, key=lambda r: (r.spec.seq_len, r.spec.nfe))]
    for solver in sorted({r.spec.solver for r in order}):
        if solver != pick[0].spec.solver:
            pick.append(next(r for r in order if r.spec.solver == solver))
    for r in order:
        if sum(p.spec.seq_len for p in pick) >= want_tokens:
            break
        if r not in pick:
            pick.append(r)
    return pick


def gaps(ref_logits, tokens):
    """Each token's gap below the reference's best, in logit SDs."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, tokens[..., None])[..., 0]
    return ((best - got) / ref_logits.std(-1)).reshape(-1)


def summarize(gap_list) -> dict:
    g = torch.cat(gap_list) if gap_list else torch.full((1,), float("inf"))
    return {"gap_sd": float(g.max()), "gap_mean": float(g.mean()),
            "mismatch": float((g > 0).float().mean()), "tokens_checked": int(g.numel())}


def reference_served(weights, model: dict, spec, prec: str = "fp32", arch=None):
    """A served request solved alone by the reference at its bucket's
    length (the program's per-row semantics), from its seed: returns the
    net and the request's x0 cut to its length."""
    device = weights["embed"].device
    net = (arch or S.arch_module()).Net(weights, model, prec=prec)
    plan = Q.make_plan(spec.solver, spec.nfe)
    g_prior, g_solve = R.request_generators(spec.seed, device)
    x = R.prior(g_prior, spec.seq_len, spec.bucket, model["d_model"], device)[None]
    vl = torch.tensor([spec.seq_len], device=device)
    return net, R.solve(net, plan, x, vl, [g_solve])[0, :spec.seq_len]


def check_served(weights, model: dict, sample, arch=None) -> dict:
    """The sampled requests' served tokens against the reference."""
    out = []
    with torch.no_grad(), R.exact_float32():
        for rec in sample:
            net, x0 = reference_served(weights, model, rec.spec, arch=arch)
            out.append(gaps(net.logits(x0), torch.as_tensor(rec.tokens, device=x0.device)))
    return dict(summarize(out), rows_checked=len(out))


def reference_oneshot(weights, model: dict, mix: dict, seeds, prec: str = "fp32", arch=None):
    """The one-shot call with generator seeds ``seeds`` (prior, solve),
    solved by the reference: the net and x0 (B, S, d)."""
    device = weights["embed"].device
    g = torch.Generator(device=device).manual_seed(int(seeds[0]))
    b, s, d = int(mix["batch"]), int(mix["seq_len"]), model["d_model"]
    x = torch.randn((b, s, d), generator=g, device=device, dtype=torch.float32) * Q.PRIOR_STD
    plan = Q.make_plan(mix["solver"], int(mix["nfe"]))
    if plan["stochastic"]:
        raise ValueError("the one-shot reference takes deterministic plans")
    net = (arch or S.arch_module()).Net(weights, model, prec=prec)
    return net, R.solve(net, plan, x, torch.full((b,), s, device=device))


def oneshot_sample(samples, seed: int):
    rng = np.random.default_rng([int(seed) % 2 ** 63, 6])
    return samples[int(rng.integers(0, len(samples)))]


def check_oneshot(weights, model: dict, mix: dict, sample, arch=None) -> dict:
    """One sampled call's tokens and x0 against the reference."""
    with torch.no_grad(), R.exact_float32():
        net, x0 = reference_oneshot(weights, model, mix, sample["seeds"], arch=arch)
        g = gaps(net.logits(x0), torch.as_tensor(sample["tokens"], device=x0.device))
        rel = float((sample["x0"].float() - x0).norm() / x0.norm())
    return dict(summarize([g]), x0_rel=rel, rows_checked=int(mix["batch"]))


def control_served(weights, model: dict, specs, prec: str = "fp8", arch=None) -> dict:
    """The reference in ``prec`` put in the program's place on the sampled
    requests ``specs``: its tokens judged against the float32 reference."""
    out = []
    with torch.no_grad(), R.exact_float32():
        for spec in specs:
            net, ref = reference_served(weights, model, spec, arch=arch)
            low_net, low = reference_served(weights, model, spec, prec=prec, arch=arch)
            out.append(gaps(net.logits(ref), low_net.logits(low).argmax(-1)))
    return dict(summarize(out), rows_checked=len(out))


def control_oneshot(weights, model: dict, mix: dict, seeds, prec: str = "fp8",
                    arch=None) -> dict:
    with torch.no_grad(), R.exact_float32():
        net, ref = reference_oneshot(weights, model, mix, seeds, arch=arch)
        low_net, low = reference_oneshot(weights, model, mix, seeds, prec=prec, arch=arch)
        g = gaps(net.logits(ref), low_net.logits(low).argmax(-1))
        return dict(summarize([g]), x0_rel=float((low - ref).norm() / ref.norm()))


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(every limited number within its limit, [(name, value, limit)])."""
    rows = [(k, numbers[k], limits[k]) for k in limits if k in numbers]
    ok = len(rows) == len(limits) and all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
