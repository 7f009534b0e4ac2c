"""Data pipeline: a deterministic synthetic corpus and the frontends' stubs
(the counterpart of ``repro.data.pipeline``, pure numpy, so its batches are
bitwise the reference's).

  * ``MarkovTextSource`` -- an order-1 Markov chain over the vocab with a
    banded transition kernel: learnable bigram statistics, so training loss
    visibly decreases; seeded and step-indexed.
  * ``frames`` / ``prefix`` stubs for the audio and image frontends.

``device_put_sharded`` places a host batch on a mesh (each rank keeps its
rows); on one device the callers move a batch with ``torch.from_numpy``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..configs.base import ModelConfig


@dataclasses.dataclass
class MarkovTextSource:
    vocab_size: int
    seed: int = 0
    band: int = 16

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self._starts = rng.randint(0, self.vocab_size, size=4096)

    def batch(self, step: int, batch: int, seq: int) -> np.ndarray:
        """Deterministic (step-indexed) batch of int32 token ids (batch, seq)."""
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % 2 ** 31)
        v = self.vocab_size
        tok = np.empty((batch, seq), np.int64)
        tok[:, 0] = self._starts[rng.randint(0, len(self._starts), batch)]
        steps = rng.randint(1, self.band, size=(batch, seq - 1))
        sign = rng.choice([-1, 1], size=(batch, seq - 1))
        jump = rng.random((batch, seq - 1)) < 0.05
        rand_tok = rng.randint(0, v, size=(batch, seq - 1))
        for i in range(1, seq):
            nxt = (tok[:, i - 1] + sign[:, i - 1] * steps[:, i - 1]) % v
            tok[:, i] = np.where(jump[:, i - 1], rand_tok[:, i - 1], nxt)
        return tok.astype(np.int32)


def make_batch(cfg: ModelConfig, source: MarkovTextSource, step: int,
               batch: int, seq: int, np_dtype=np.float32) -> dict:
    """Full input batch for the arch: ``tokens``, plus ``frames`` (encdec)
    or ``prefix`` (vlm) drawn N(0, 1) from the step's seed."""
    out = {"tokens": source.batch(step, batch, seq)}
    rng = np.random.RandomState(step + 17)
    if cfg.arch_type == "encdec":
        out["frames"] = rng.randn(batch, cfg.encoder_seq, cfg.d_model).astype(np_dtype)
    if cfg.arch_type == "vlm":
        out["prefix"] = rng.randn(batch, cfg.prefix_tokens, cfg.d_model).astype(np_dtype)
    return out


def host_iterator(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                  start_step: int = 0) -> Iterator[dict]:
    src = MarkovTextSource(cfg.vocab_size, seed)
    step = start_step
    while True:
        yield make_batch(cfg, src, step, batch, seq)
        step += 1


def device_put_sharded(batch: dict, sharding, device) -> dict:
    """Place a host batch (numpy arrays, the same on every rank) on a mesh:
    each array becomes a DTensor on ``device`` that holds this rank's rows
    over the data axes and is whole over 'model', as ``sharding`` (one
    ``rules.NamedSharding``, or a dict of them: ``rules.to_shardings(
    rules.batch_specs(batch, mesh), mesh)``) lays it out."""
    from ..sharding.rules import device_put
    if not isinstance(sharding, dict):
        sharding = {k: sharding for k in batch}
    return {k: device_put(torch.from_numpy(np.asarray(v)).to(device), sharding[k])
            for k, v in batch.items()}
