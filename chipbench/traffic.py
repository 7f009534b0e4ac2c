"""The one traffic generator: every mix is a data file it reads.

A served mix (``kind: served``) gives the solvers with their shares, the
NFE values, the range of lengths and the buckets. Its requests come in
blocks of ``block`` (default 120): a block holds each solver at its exact
share, each NFE equally often and lengths spread evenly over the range,
paired once from the mix's own ``deck_seed``, so every block is the same
multiset of work. The run's ``--seed`` only orders each block and gives
each request its noise seed, so two seeds serve the same work in another
order.

Arrivals (the cell's ``arrival``): ``closed``, ``clients`` callers, each
sending its next request when its last returns, taking requests from the
stream in turn.

A one-shot mix (``kind: oneshot``) gives the solver, NFE, batch and length
of each call; every call is the same work.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Spec:
    """One request: solver, NFE, length, its bucket and its noise seed."""
    solver: str
    nfe: int
    seq_len: int
    bucket: int
    seed: int


def bucket_of(mix: dict, seq_len: int) -> int:
    for edge in mix["buckets"]:
        if seq_len <= edge:
            return edge
    return seq_len


def block(mix: dict) -> list[tuple[str, int, int]]:
    """The fixed block of (solver, nfe, seq_len) triples."""
    size = int(mix.get("block", 120))
    rng = np.random.default_rng(int(mix["deck_seed"]))
    shares = mix["solvers"]
    raw = {s: w * size / sum(shares.values()) for s, w in shares.items()}
    counts = {s: int(v) for s, v in raw.items()}
    for s in sorted(raw, key=lambda s: raw[s] - counts[s], reverse=True)[:size - sum(counts.values())]:
        counts[s] += 1
    solvers = [s for s in shares for _ in range(counts[s])]
    nfes = [mix["nfe"][i % len(mix["nfe"])] for i in range(size)]
    lo, hi = mix["seq_len"]
    lens = [int(lo + (hi - lo) * (i + 0.5) / size) for i in range(size)]
    rng.shuffle(nfes)
    rng.shuffle(lens)
    return list(zip(solvers, nfes, lens))


def stream(mix: dict, seed: int, stream_id: int = 0):
    """Requests without end: blocks of the mix, each in an order drawn from
    ``(seed, stream_id)``, with per-request noise seeds from the same."""
    base = block(mix)
    rng = np.random.default_rng([int(seed) % 2 ** 63, stream_id])
    while True:
        for i in rng.permutation(len(base)):
            s, nfe, length = base[i]
            yield Spec(s, int(nfe), int(length), bucket_of(mix, length),
                       int(rng.integers(0, 2 ** 62)))
