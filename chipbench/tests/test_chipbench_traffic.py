"""The traffic generator: the same seed gives the same requests; seeds give
the same work in another order. And what a served window counts."""
import collections
import itertools
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from chipbench import drive, run, spec, traffic  # noqa: E402

MIX = spec.load_cell("mixtral-8x7b-pp2.serve_closed")["mix_data"]


def _deck(n, seed, stream_id=0):
    return list(itertools.islice(traffic.stream(MIX, seed, stream_id), n))


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, 2 ** 40 + 3])
def test_deck_is_deterministic(seed):
    assert _deck(300, seed, 2) == _deck(300, seed, 2)


def test_blocks_hold_the_same_work_for_every_seed():
    size = MIX.get("block", 120)
    keys = lambda d: collections.Counter((s.solver, s.nfe, s.seq_len) for s in d)
    a, b = _deck(2 * size, 1), _deck(2 * size, 2)
    assert keys(a) == keys(b)
    assert [s.solver for s in a] != [s.solver for s in b]
    shares = collections.Counter(s.solver for s in a[:size])
    assert shares == {s: round(w * size) for s, w in MIX["solvers"].items()}
    assert all(s.bucket == (128 if s.seq_len <= 128 else 256) for s in a)


def test_served_window_counts_what_ended_in_it():
    """Tokens of requests done inside [w0, w0 + window] over the window;
    every request that ended after the opening is attempted, a failed one
    counted as failed."""
    spec_of = lambda n: traffic.Spec("ddim", 6, n, 128, 1)
    recs = [drive.Rec(spec_of(100), 0, 0.0, done=1.0, tokens=np.zeros(100)),    # before
            drive.Rec(spec_of(64), 1, 1.0, done=3.0, tokens=np.zeros(64)),      # in
            drive.Rec(spec_of(80), 2, 2.0, done=11.5, tokens=np.zeros(80)),     # in
            drive.Rec(spec_of(90), 3, 5.0, done=12.5, tokens=np.zeros(90)),     # drained
            drive.Rec(spec_of(70), 4, 6.0, done=9.0, error="boom")]             # failed
    win = drive.Window(records=recs, w0=2.0, window_s=10.0)
    out, attempted, failed = run._end_to_end("closed", win, MIX, 5.0)
    assert out["served_tokens_per_s"] == ((64 + 80) / 10.0, "tokens/s")
    assert (attempted, failed) == (4, 1)
