"""Autoregressive prefill and decode steps (the counterpart of
``repro.training.steps.make_prefill_step`` / ``make_decode_step``).

Each step is a plain function over the port's params and cache; the caller
runs it under ``torch.no_grad()``. The train step belongs to the training
slice and is not ported yet.
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from ..models import transformer as T


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
