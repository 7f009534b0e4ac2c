"""Continuous diffusion language modeling: the paper's sampler over a
transformer eps-network in token-embedding space.

The counterpart of ``repro.diffusion.lm``. Tokens are embedded into
R^{d_model} (:func:`token_embeddings`); a forward SDE noises the
embeddings, and the backbone (bidirectional, time-conditioned) is trained
as eps_theta with the paper's Eq. 9 loss plus a rounding-anchor
cross-entropy through the LM head (:func:`diffusion_loss`). Generation runs
any DEIS solver in embedding space -- each NFE is one full-sequence
backbone forward -- then rounds to tokens through the LM head.

Random numbers. Each request owns two ``torch.Generator``s derived from its
seed alone (:func:`request_generators`): one draws its prior, one its solve
noise. Stacked rows draw row by row, each from its own generators, so a
request's sample does not depend on the batch it landed in (the
counterpart of the reference's ``request_keys``; the numbers differ from
JAX's threefry draws).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core import sampler as SAMPLER
from ..core.plan import SolverPlan
from ..models import transformer as T
from ..obs.trace import NULL_TRACER
from ..sharding import tensor_parallel as TP

X0_SCALE = 25.0    # x0 = embed * X0_SCALE so data std ~ 0.5


def token_embeddings(params, tokens, embed=None):
    """x0 of the diffusion: the tokens' embeddings in float32, times
    ``X0_SCALE`` (``embed``: the placed table, on a mesh)."""
    table = TP.place(params["embed"]) if embed is None else embed
    return TP.embedding(table, tokens).to(torch.float32) * X0_SCALE


def draw_t_eps(sde, tokens, d_model: int, gen, device, t=None, eps=None, rows=None):
    """The diffusion loss's draws from ``gen``, each unless given: ``t``
    (B,) ~ U(t0, T), then ``eps`` (B, S, d_model) ~ N(0, I), float32.

    ``rows``: ``(lo, hi, B)`` when ``tokens`` are rows ``[lo, hi)`` of a
    B-row batch split over a mesh's data axes. Every rank then draws the
    whole batch's ``t`` and ``eps`` from the same generator (or takes the
    given whole-batch draws) and keeps its rows, so a data-parallel step
    sees the unsharded step's draws."""
    n = tokens.shape[0] if rows is None else rows[2]
    if t is None:
        t = torch.rand((n,), generator=gen, device=device,
                       dtype=torch.float32) * (sde.T - sde.t0) + sde.t0
    if eps is None:
        eps = torch.randn((n, *tokens.shape[1:], d_model), generator=gen, device=device,
                          dtype=torch.float32)
    if rows is not None:
        t, eps = t[rows[0]:rows[1]], eps[rows[0]:rows[1]]
    return t, eps


def diffusion_loss(params, cfg: ModelConfig, sde, tokens, gen=None, *, prefix=None,
                   frames=None, ce_weight: float = 0.1, remat: bool = False, t=None,
                   eps=None, rows=None):
    """Paper Eq. 9 (eps matching, uniform weight) + ``ce_weight`` x the
    rounding-anchor cross-entropy + the MoE aux losses. Returns ``(loss,
    {"loss", "mse", "ce"})``.

    ``t`` (B,) ~ U(t0, T) and ``eps`` ~ N(0, I) of x0's shape are drawn
    from the ``torch.Generator`` ``gen`` (t first), on the parameters'
    device, unless given: ``t=`` and ``eps=`` take draws from elsewhere (the
    tests hand in the reference's). ``prefix`` (vlm) goes in front of x_t
    and its positions are sliced off the eps; ``frames`` (encdec) feed the
    encoder. ``remat``: each layer under ``torch.utils.checkpoint``.

    On a mesh (DTensor parameters) ``tokens``, ``prefix`` and ``frames``
    are this rank's rows ``rows`` of the batch (:func:`draw_t_eps`), the
    means are over the whole batch (``batch_mean``: every rank holds the
    global loss)."""
    from ..training.steps import cross_entropy   # steps imports this module
    ax = TP.axes_of(params["embed"])
    t, eps = draw_t_eps(sde, tokens, cfg.d_model, gen, params["embed"].device, t, eps,
                        rows)
    embed = TP.place(params["embed"])
    x0 = token_embeddings(params, tokens, embed)
    mu = sde.mu(t)[:, None, None]
    sig = sde.sigma(t)[:, None, None]
    xt = mu * x0 + sig * eps

    vlm = cfg.arch_type == "vlm" and prefix is not None
    xin = torch.cat([prefix.to(xt.dtype), xt], dim=1) if vlm else xt
    out = T.forward(params, cfg, embeds=xin, t_cond=t, mode="train", causal=False,
                    frames=frames, logits=False, remat=remat)
    eps_pred = out["eps"].to(torch.float32)
    if vlm:
        eps_pred = eps_pred[:, prefix.shape[1]:]
    mse = TP.batch_mean(torch.mean(torch.square(eps_pred - eps)), ax)

    # rounding anchor: decode x0_hat back to tokens through the LM head
    x0_hat = (xt - sig * eps_pred) / torch.clamp(mu, min=1e-4)
    head = T.lm_head(params, cfg, embed)
    logits, split = TP.linear(x0_hat / X0_SCALE, TP.cast(head, torch.float32))
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    ce = TP.batch_mean(cross_entropy(logits, tokens, cfg,
                                     split=TP.split_of(head) if split else None), ax)

    aux = sum(out["aux"].values()) if out["aux"] else 0.0
    loss = mse + ce_weight * ce + aux
    return loss, {"loss": loss, "mse": mse, "ce": ce}


def make_eps_fn(params, cfg: ModelConfig, *, prefix=None, frames=None,
                valid_len=None, use_kernels: bool = False, tracer=NULL_TRACER):
    """eps_theta(x, t) closure for the DEIS solvers; x: (B, S, D), t scalar
    or (B,). Computes the eps head only (no vocabulary logits).

    ``prefix``: (B, P, D) image-patch embeddings of a vlm arch, put in
    front of x at every evaluation (``valid_len`` grows by P, the prefix
    being all valid) and sliced off the eps. ``frames``: (B, F, D) encoder
    inputs of an encdec arch, passed to every forward (the encoder runs at
    every evaluation, as in the reference). ``valid_len``: optional (B,)
    int per-row true length for bucket-padded batches, threaded to
    attention so a row's trajectory does not depend on the bucket's tail
    padding. ``use_kernels``: self-attention through kernel K2 (which
    refuses ``valid_len``) and the Mamba2 scan through K3. ``tracer``: each
    evaluation is an ``eps`` span, the layers' spans nested in it
    (:func:`repro_torch.models.transformer.forward`)."""
    vlm = cfg.arch_type == "vlm" and prefix is not None
    p = prefix.shape[1] if vlm else 0

    def eps_fn(x, t):
        with tracer.span("eps"):
            t_b = t.to(torch.float32).expand(x.shape[0])
            xin = torch.cat([prefix.to(x.dtype), x], dim=1) if vlm else x
            vl = valid_len + p if (vlm and valid_len is not None) else valid_len
            out = T.forward(params, cfg, embeds=xin, t_cond=t_b, causal=False,
                            frames=frames, valid_len=vl, logits=False,
                            use_kernels=use_kernels, tracer=tracer)
            return out["eps"][:, p:].to(x.dtype)
    return eps_fn


def decode_tokens(params, cfg: ModelConfig, x0):
    """Round solved embeddings ``x0`` to tokens through the LM head:
    ``argmax((x0 / X0_SCALE) @ head)`` in float32 (first maximum wins, as
    ``jnp.argmax``; ``cfg.logits_scaling``, a positive divisor, moves no
    argmax)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x0 / X0_SCALE) @ head.to(torch.float32)
    return torch.argmax(logits, dim=-1)


def sample_tokens(params, cfg: ModelConfig, plan: SolverPlan, gens, *,
                  batch: int, seq_len: int, prior_std: float, prefix=None,
                  frames=None, use_kernels: bool = False, hooks=None, x_T=None,
                  noise=None, tracer=NULL_TRACER):
    """Generate a batch of token sequences with one (unstacked) DEIS plan in
    one call, on the parameters' device. Returns ``(tokens, x0)``.

    The counterpart of ``repro.diffusion.lm.sample_tokens``; the reference's
    ``use_pallas`` is ``use_kernels`` here (the port launches no Pallas):
    attention runs through kernel K2, the Mamba2 scan through K3, a MoE on
    the card through its dispatch kernels, and a ``fused`` ``ab`` plan
    through K1. ``gens`` is a ``(prior, solve)`` pair
    of ``torch.Generator``s on that device (the counterpart of splitting the
    reference's key): the prior ``N(0, prior_std^2)`` of shape
    ``(batch, seq_len, d_model)`` is drawn from the first, a stochastic
    plan's noise from the second. ``x_T`` replaces the prior draw and
    ``noise`` (indexable by step) the solve noise, so a test can hand both
    frameworks the same numbers; ``gens`` may then be None. ``prefix``
    (vlm) and ``frames`` (encdec) condition every evaluation
    (:func:`make_eps_fn`); the prior and x0 cover the ``seq_len`` text
    positions only.

    ``tracer`` (a :class:`repro_torch.obs.trace.Tracer`) times the call as
    a ``sample_tokens`` span holding the sampler's ``sample.step`` spans
    and a ``decode`` span (``docs/observability.md`` gives the tree); with
    ``annotate=True`` each span is also a ``torch.profiler`` range. The
    default, ``NULL_TRACER``, records nothing, and what is computed is the
    same either way."""
    with tracer.span("sample_tokens"):
        device = params["embed"].device
        plan = plan.to(device)
        g_prior, g_solve = gens if gens is not None else (None, None)
        if x_T is None:
            x_T = torch.randn((batch, seq_len, cfg.d_model), generator=g_prior,
                              device=device, dtype=torch.float32) * prior_std
        eps_fn = make_eps_fn(params, cfg, prefix=prefix, frames=frames,
                             use_kernels=use_kernels, tracer=tracer)
        x0 = SAMPLER.sample(plan, eps_fn, x_T, g_solve, hooks=hooks, noise=noise,
                            tracer=tracer)
        with tracer.span("decode"):
            tokens = decode_tokens(params, cfg, x0)
        return tokens, x0


def request_generators(seeds, device) -> list:
    """Per-request ``(prior, solve)`` generator pairs on ``device``, each
    seeded from the request's own seed through numpy's SeedSequence."""
    out = []
    for s in seeds:
        a, b = np.random.SeedSequence(int(s)).generate_state(2)
        out.append((torch.Generator(device=device).manual_seed(int(a)),
                    torch.Generator(device=device).manual_seed(int(b))))
    return out


def init_sample_state(cfg: ModelConfig, plan: SolverPlan, gens, *,
                      seq_len: int, prior_std: float, valid_lens=None,
                      x_T=None):
    """Build the stacked ``SamplerState`` for a group of requests.

    ``plan`` is stacked and lies on the device to solve on; ``gens`` are the
    rows' ``(prior, solve)`` generator pairs (None with ``x_T`` given and a
    deterministic plan). Row ``i``'s prior is drawn
    from its own prior generator at its TRUE length (``valid_lens[i]``,
    default ``seq_len``), zero-padded to ``seq_len`` and scaled by
    ``prior_std``, so the prior does not depend on the group or the bucket.
    ``x_T`` replaces the draw (the tests inject the reference's prior)."""
    device = plan.ts.device
    if x_T is None:
        rows = []
        for i, (g_prior, _) in enumerate(gens):
            lv = seq_len if valid_lens is None else int(valid_lens[i])
            r = torch.randn((lv, cfg.d_model), generator=g_prior,
                            device=device, dtype=torch.float32)
            rows.append(F.pad(r, (0, 0, 0, seq_len - lv)))
        x_T = torch.stack(rows) * prior_std
    key = None if gens is None else [g_solve for _, g_solve in gens]
    return SAMPLER.init_state(plan, x_T, key)


def sample_tokens_stream(params, cfg: ModelConfig, plan: SolverPlan, gens, *,
                         seq_len: int, prior_std: float, hooks=None,
                         x_T=None, noise=None):
    """One-shot solve of a stacked per-request group on the parameters'
    device. Returns ``(tokens, x0)``.

    This is the reference the serving engine reproduces: running the same
    stacked plan step by step, interleaved with other groups, joined or
    compacted, yields the same per-request samples."""
    plan = plan.to(params["embed"].device)
    eps_fn = make_eps_fn(params, cfg)
    state = init_sample_state(cfg, plan, gens, seq_len=seq_len,
                              prior_std=prior_std, x_T=x_T)
    x0 = SAMPLER.sample(plan, eps_fn, state.x, state.key, hooks=hooks,
                        noise=noise)
    return decode_tokens(params, cfg, x0), x0
