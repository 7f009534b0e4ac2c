"""Train, prefill and decode steps (the counterpart of
``repro.training.steps``).

``train_step``: one optimizer step on the configured objective
('diffusion' = the paper's eps matching, :func:`repro_torch.diffusion.lm.
diffusion_loss`; 'ar' = causal LM, :func:`ar_loss`), with autograd through
the plain route (the reference trains with ``use_pallas=False``: no kernel
has a backward). ``prefill_step``: full-sequence forward returning the
logits and the cache. ``decode_step``: ONE new token against the cache.

The reference's ``unroll`` (of its ``lax.scan`` over blocks) has no
counterpart: the port loops over its layers in Python. The prefill and
decode steps run under the caller's ``torch.no_grad()``.

On a mesh (DTensor parameters and a batch placed by
``data.pipeline.device_put_sharded``) the same functions run the sharded
train step: each rank computes on its rows of the batch and its shards of
the parameters (``sharding.tensor_parallel``), the losses are means over
the whole batch, and the grads come back as DTensors placed like the
parameters. A weight stored split over 'data' (fsdp) is gathered for its
layer, dropped after it and gathered again in the backward: the ZeRO-3
profile, which the reference asks for with a ``block_constraint`` of each
layer's model-only specs. ``make_train_step`` accepts that constraint
(and refuses any other); the port needs it nowhere else.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.sde import SDE, VPSDE
from ..diffusion import lm as DLM
from ..models import transformer as T
from ..sharding import tensor_parallel as TP
from .optimizer import AdamW, value_and_grad


def cross_entropy(logits, targets, cfg: ModelConfig, split=None):
    """Mean token cross-entropy in float32. ``cfg.ce_mode``: "gather"
    (log_softmax, then the targets' entries) or "onehot" (logsumexp minus
    a one-hot contraction over the vocabulary; the same value).

    ``split`` (a ``tensor_parallel.Split``): the logits are this rank's
    block of the vocabulary over 'model'. "gather" then gathers them
    whole; "onehot" keeps them split and sums its two contractions over
    'model' (the max, the exponentials' sum and the picked logit)."""
    logits = logits.to(torch.float32)
    targets = targets.long()
    if split is not None:
        if cfg.ce_mode != "onehot":
            logits = TP.gather_model(logits, -1, split.ax)
        else:
            return _onehot_split(logits, targets, split.ax)
    if cfg.ce_mode == "onehot":
        lse = torch.logsumexp(logits, dim=-1)
        onehot = F.one_hot(targets, logits.shape[-1]).to(torch.float32)
        picked = torch.sum(logits * onehot, dim=-1)
        return torch.mean(lse - picked)
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, targets[..., None]))


def _onehot_split(logits, targets, ax):
    """The "onehot" cross-entropy of logits split over 'model' on the
    vocabulary (this rank's block of V / model entries)."""
    m = TP.all_reduce_max(logits.amax(-1, keepdim=True), ax)
    lse = torch.log(TP.reduce_from_model(torch.exp(logits - m).sum(-1), ax)) + m[..., 0]
    v = logits.shape[-1]
    local = targets - ax.model_rank * v
    hit = (local >= 0) & (local < v)
    onehot = F.one_hot(torch.where(hit, local, 0), v).to(torch.float32) * hit[..., None]
    picked = TP.reduce_from_model(torch.sum(logits * onehot, dim=-1), ax)
    return torch.mean(lse - picked)


def ar_loss(params, cfg: ModelConfig, tokens, *, prefix=None, frames=None,
            remat: bool = False):
    """Next-token cross-entropy (a vlm's prefix positions dropped from the
    logits) plus the MoE aux losses. Returns ``(loss, {"loss", "ppl"})``,
    ``"loss"`` being the cross-entropy alone. On a mesh, the mean over the
    whole batch."""
    out = T.forward(params, cfg, tokens=tokens, mode="train", causal=True,
                    prefix=prefix, frames=frames, remat=remat)
    logits = out["logits"]
    if cfg.arch_type == "vlm" and prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    loss = TP.batch_mean(cross_entropy(logits[:, :-1], tokens[:, 1:], cfg,
                                       split=out.get("logits_split")),
                         TP.axes_of(params["embed"]))
    aux = sum(out["aux"].values()) if out["aux"] else 0.0
    return loss + aux, {"loss": loss, "ppl": torch.exp(loss)}


def _local_batch(cfg: ModelConfig, batch: dict):
    """``(this rank's rows of each entry, rows)``: a batch on a mesh (DTensors)
    becomes its local rows, ``rows`` being ``(lo, hi, B)`` (None for a plain
    batch). ``cfg.act_shard_axes`` must name mesh axes the rows are split
    over (the MoE batch pin)."""
    if not TP.is_sharded(batch["tokens"]):
        return batch, None
    out, rows = {}, None
    for k, v in batch.items():
        out[k], r = TP.local_rows(v)
        if rows is not None and r != rows:
            raise ValueError(f"batch entry {k} holds rows {r}, tokens {rows}")
        rows = r
    pinned = tuple(cfg.act_shard_axes or ())
    split = TP.rows_split_over(batch["tokens"])
    if not set(pinned) <= set(split):
        raise ValueError(f"act_shard_axes {pinned} pins the MoE batch to mesh axes the "
                         f"batch of {rows[2]} rows is not split over (it is over {split})")
    return out, rows


def make_loss_fn(cfg: ModelConfig, sde: Optional[SDE] = None, remat=False):
    """``loss_fn(params, batch, gen=None, *, t=None, eps=None) -> (loss,
    metrics)`` on ``cfg.objective``; ``batch`` holds ``tokens`` and, where
    the arch takes them, ``prefix`` or ``frames``. ``gen`` draws the
    diffusion loss's ``t`` and ``eps`` unless they are given (an ar loss
    draws nothing and refuses them); given, they are the whole batch's.

    remat: False | "block" or True (each layer under
    ``torch.utils.checkpoint``) | "loss" (the whole loss under one
    checkpoint; ``t`` and ``eps`` are drawn before it, so the backward's
    recomputation sees the same draws). All three give the same loss and
    grads."""
    sde = sde or VPSDE()
    block_remat = remat == "block" or remat is True

    def local_loss(params, batch, gen, t, eps, rows):
        kw = {k: batch[k] for k in ("prefix", "frames") if k in batch}
        if cfg.objective != "diffusion":
            return ar_loss(params, cfg, batch["tokens"], remat=block_remat, **kw)
        return DLM.diffusion_loss(params, cfg, sde, batch["tokens"], gen,
                                  remat=block_remat, t=t, eps=eps, rows=rows, **kw)

    def loss_fn(params, batch, gen=None, *, t=None, eps=None):
        batch, rows = _local_batch(cfg, batch)
        if cfg.objective != "diffusion" and (t is not None or eps is not None):
            raise ValueError("the ar objective draws no t or eps")
        if remat != "loss":
            return local_loss(params, batch, gen, t, eps, rows)
        if cfg.objective == "diffusion":
            t, eps = DLM.draw_t_eps(sde, batch["tokens"], cfg.d_model, gen,
                                    params["embed"].device, t, eps, rows)
        return checkpoint(lambda p, bt: local_loss(p, bt, None, t, eps, None), params,
                          batch, use_reentrant=False)
    return loss_fn


def make_train_step(cfg: ModelConfig, opt: AdamW, sde: Optional[SDE] = None,
                    remat=False, block_constraint=None):
    """``train_step(params, opt_state, batch, gen=None, *, t=None, eps=None)
    -> (params, opt_state, metrics)``: the loss's grads by autograd, then
    ``opt.update`` (in place: the returned trees are the ones passed in).
    metrics: the loss's (``loss``, ``ppl`` or ``mse`` / ``ce``), plus
    ``grad_norm`` and ``lr``, as 0-d tensors on the parameters' device
    (the whole batch's, the same on every rank of a mesh).

    ``block_constraint``: the reference's, checked against the parameters
    at each step (``tensor_parallel.check_block_constraint``): only its
    ZeRO-3 one, each layer's model-only specs, is taken, and that is how
    the port computes every layer on a mesh anyway. The ZeRO-3 saved-tensor
    hooks (``regather_saved``) are on only when some placement gathers."""
    loss_fn = make_loss_fn(cfg, sde, remat=remat)

    def train_step(params, opt_state, batch, gen=None, *, t=None, eps=None):
        if block_constraint is not None:
            TP.check_block_constraint(params["blocks"], block_constraint)
        saves = TP.regather_saved() if TP.gathers(params) else contextlib.nullcontext()
        with saves:
            (_, metrics), grads = value_and_grad(loss_fn, params, batch, gen, t=t,
                                                 eps=eps, has_aux=True)
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
