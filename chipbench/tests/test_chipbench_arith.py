"""The FLOP and byte arithmetic against hand counts at small shapes."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from chipbench import bounds, flops  # noqa: E402


def test_bound_takes_the_longer_term():
    assert bounds.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert bounds.bound_s(0.0, 989e12) == pytest.approx(1.0)
    assert bounds.bound_s(3.35e9, 989e12) == pytest.approx(1.0)


def test_k1_bytes_by_hand():
    # x, 3 history slices and x' of (2, 4, 8) float32, 2 rows of 4 scalars
    assert bounds.k1_bytes(2, 4, 8, 3) == 5 * 64 * 4 + 2 * 4 * 4
    # with noise and the error pair: one more plane, s and E columns, err out
    assert bounds.k1_bytes(1, 2, 2, 1, noise=True, err=True) == 4 * 4 * 4 + 4 * 4 + 4


def test_k3_work_by_hand():
    b, s, h, p, n, L = 1, 4, 1, 2, 2, 4
    nbytes, ops = bounds.k3_work(b, s, h, p, n, L)
    assert nbytes == 2 * (8 * 2 + 8 * 2) + 4 * 4 + 4 * 4
    tri = 10
    assert ops == 2 * tri * n + (2 * tri * p + 4 * L * n * p)


def test_flops_dense_attention_by_hand():
    m = {"arch_type": "moe", "n_layers": 1, "d_model": 4, "n_heads": 2, "n_kv_heads": 1,
         "head_dim": 2, "d_ff": 8, "vocab_size": 10, "sliding_window": 0,
         "moe": {"num_experts": 4, "top_k": 2}}
    proj = 2 * 4 * (2 * 4 + 2 * 2)          # q, o (4 wide) and k, v (2 wide)
    attn = 4 * 3 * 2 * 2                     # S 3, two heads of 2
    moe = 2 * 4 * 4 + 2 * 3 * 2 * 4 * 8      # router, two experts' three products
    assert flops.per_token_forward(m, 3) == proj + attn + moe + 2 * 4 * 4
    m["sliding_window"] = 2
    assert flops.per_token_forward(m, 3) == proj + 4 * 2 * 2 * 2 + moe + 2 * 4 * 4


def test_flops_ssm_and_sample_by_hand():
    m = {"arch_type": "ssm", "n_layers": 2, "d_model": 4, "vocab_size": 10, "time_emb_dim": 2,
         "ssm": {"expand": 2, "head_dim": 4, "state_dim": 2, "conv_width": 4, "chunk_size": 4}}
    d_in, heads = 8, 2
    _, scan = bounds.k3_work(1, 4, heads, 4, 2, 4)
    layer = 2 * 4 * (2 * d_in + 2 * 2 + heads) + 2 * 4 * (d_in + 4) + scan / 4 + 2 * d_in * 4
    assert flops.per_token_forward(m, 4) == pytest.approx(2 * layer + 2 * 4 * 4)
    per_nfe = 4 * flops.per_token_forward(m, 4) + 2 * (2 * 4 + 4 * 4)
    assert flops.sample_flops(m, 4, 3) == pytest.approx(3 * per_nfe + 4 * 2 * 4 * 10)
