"""Train, prefill and decode steps (the counterpart of
``repro.training.steps``).

``train_step``: one optimizer step on the configured objective
('diffusion' = the paper's eps matching, :func:`repro_torch.diffusion.lm.
diffusion_loss`; 'ar' = causal LM, :func:`ar_loss`), with autograd through
the plain route (the reference trains with ``use_pallas=False``: no kernel
has a backward). ``prefill_step``: full-sequence forward returning the
logits and the cache. ``decode_step``: ONE new token against the cache.

The reference's ``unroll`` (of its ``lax.scan`` over blocks) and
``block_constraint`` (a sharding constraint inside the scan) have no
counterpart: the port loops over its layers in Python on one device.
The prefill and decode steps run under the caller's ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.sde import SDE, VPSDE
from ..diffusion import lm as DLM
from ..models import transformer as T
from .optimizer import AdamW, value_and_grad


def cross_entropy(logits, targets, cfg: ModelConfig):
    """Mean token cross-entropy in float32. ``cfg.ce_mode``: "gather"
    (log_softmax, then the targets' entries) or "onehot" (logsumexp minus
    a one-hot contraction over the vocabulary; the same value)."""
    logits = logits.to(torch.float32)
    targets = targets.long()
    if cfg.ce_mode == "onehot":
        lse = torch.logsumexp(logits, dim=-1)
        onehot = F.one_hot(targets, logits.shape[-1]).to(torch.float32)
        picked = torch.sum(logits * onehot, dim=-1)
        return torch.mean(lse - picked)
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, targets[..., None]))


def ar_loss(params, cfg: ModelConfig, tokens, *, prefix=None, frames=None,
            remat: bool = False):
    """Next-token cross-entropy (a vlm's prefix positions dropped from the
    logits) plus the MoE aux losses. Returns ``(loss, {"loss", "ppl"})``,
    ``"loss"`` being the cross-entropy alone."""
    out = T.forward(params, cfg, tokens=tokens, mode="train", causal=True,
                    prefix=prefix, frames=frames, remat=remat)
    logits = out["logits"]
    if cfg.arch_type == "vlm" and prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    loss = cross_entropy(logits[:, :-1], tokens[:, 1:], cfg)
    aux = sum(out["aux"].values()) if out["aux"] else 0.0
    return loss + aux, {"loss": loss, "ppl": torch.exp(loss)}


def make_loss_fn(cfg: ModelConfig, sde: Optional[SDE] = None, remat=False):
    """``loss_fn(params, batch, gen=None, *, t=None, eps=None) -> (loss,
    metrics)`` on ``cfg.objective``; ``batch`` holds ``tokens`` and, where
    the arch takes them, ``prefix`` or ``frames``. ``gen`` draws the
    diffusion loss's ``t`` and ``eps`` unless they are given (an ar loss
    draws nothing and refuses them).

    remat: False | "block" or True (each layer under
    ``torch.utils.checkpoint``) | "loss" (the whole loss under one
    checkpoint; ``t`` and ``eps`` are drawn before it, so the backward's
    recomputation sees the same draws). All three give the same loss and
    grads."""
    sde = sde or VPSDE()
    block_remat = remat == "block" or remat is True

    def loss_fn(params, batch, gen=None, *, t=None, eps=None):
        kw = {k: batch[k] for k in ("prefix", "frames") if k in batch}
        if cfg.objective != "diffusion":
            if t is not None or eps is not None:
                raise ValueError("the ar objective draws no t or eps")
            return ar_loss(params, cfg, batch["tokens"], remat=block_remat, **kw)
        return DLM.diffusion_loss(params, cfg, sde, batch["tokens"], gen,
                                  remat=block_remat, t=t, eps=eps, **kw)

    if remat != "loss":
        return loss_fn

    def loss_fn_remat(params, batch, gen=None, *, t=None, eps=None):
        draws = {}
        if cfg.objective == "diffusion":
            t, eps = DLM.draw_t_eps(sde, batch["tokens"], cfg.d_model, gen,
                                    params["embed"].device, t, eps)
            draws = {"t": t, "eps": eps}
        return checkpoint(lambda p, bt: loss_fn(p, bt, **draws), params, batch,
                          use_reentrant=False)
    return loss_fn_remat


def make_train_step(cfg: ModelConfig, opt: AdamW, sde: Optional[SDE] = None,
                    remat=False):
    """``train_step(params, opt_state, batch, gen=None, *, t=None, eps=None)
    -> (params, opt_state, metrics)``: the loss's grads by autograd, then
    ``opt.update`` (in place: the returned trees are the ones passed in).
    metrics: the loss's (``loss``, ``ppl`` or ``mse`` / ``ce``), plus
    ``grad_norm`` and ``lr``, as 0-d tensors on the parameters' device."""
    loss_fn = make_loss_fn(cfg, sde, remat=remat)

    def train_step(params, opt_state, batch, gen=None, *, t=None, eps=None):
        (_, metrics), grads = value_and_grad(loss_fn, params, batch, gen, t=t, eps=eps,
                                             has_aux=True)
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, **opt_metrics)

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> (last-position logits (B, vocab),
    cache)`` over ``batch["tokens"]`` (B, S), causal, with
    ``batch["prefix"]`` (vlm) and ``batch["frames"]`` (encdec) passed on
    where present."""
    def prefill_step(params, batch):
        kw = {k: batch[k] for k in ("prefix", "frames") if k in batch}
        out = T.forward(params, cfg, tokens=batch["tokens"], mode="prefill",
                        causal=True, **kw)
        return out["logits"][:, -1], out["cache"]
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, cache, token (B, 1), cache_index: int) ->
    (logits (B, vocab), cache)``; attention caches are written in place.
    ``cache_index`` counts a vlm prefix; an encdec cache carries the cross
    k and v from prefill."""
    def decode_step(params, cache, token, cache_index):
        out = T.forward(params, cfg, tokens=token, mode="decode", causal=True,
                        cache=cache, cache_index=cache_index)
        return out["logits"][:, -1], out["cache"]
    return decode_step
