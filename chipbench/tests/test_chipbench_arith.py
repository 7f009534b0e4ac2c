"""The FLOP and byte arithmetic against hand counts at small shapes."""
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from chipbench import bounds, flops  # noqa: E402
from chipbench import weights as W  # noqa: E402
from chipbench.tests import _tiny  # noqa: E402


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


def test_flops_hybrid_by_hand():
    """tiny-hybrid: layers ssm+mlp, ssm+moe, attn+mlp, ssm+moe at S 32."""
    m = _tiny.CONFIGS["tiny-hybrid"]["model"]
    _, scan = bounds.k3_work(1, 32, 8, 16, 16, 16)          # d_inner 128: 8 heads of 16
    ssm = 2 * 64 * (2 * 128 + 2 * 16 + 8) + 2 * 4 * (128 + 2 * 16) + scan / 32 + 2 * 128 * 64
    attn = 2 * 64 * (2 * 128 + 2 * 64) + 4 * 32 * 4 * 32    # q, o 128 wide, k, v 64; S 32
    mlp = 3 * 2 * 64 * 96
    moe = 2 * 64 * 4 + 2 * 3 * 2 * 64 * 96                  # router, two experts
    want = (ssm + mlp) + (ssm + moe) + (attn + mlp) + (ssm + moe) + 2 * 64 * 64
    assert flops.per_token_forward(m, 32) == pytest.approx(want, rel=1e-15)


# chipbench/flops.py and chipbench/weights.py at commit 82ed6f2, before the
# layers were counted by kind: (n_params, per_token_forward(S), S, NFE,
# sample_flops(S, NFE)), which mfu.batch and the weights' log read
PINNED = {
    "mamba2-2.7b": (2716367360, 5413216256.0, 256, 10, 13923891281920.0),
    "mixtral-8x7b-pp2": (23517081600, 12718178304.0, 256, 10, 32626001838080.0),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_counts_of_the_harness_configs_are_pinned(name):
    root = Path(__file__).resolve().parents[1]
    m = json.loads((root / "configs" / f"{name}.json").read_text())["model"]
    params, per_token, s, nfe, sample = PINNED[name]
    assert W.n_params(m) == params
    assert flops.per_token_forward(m, s) == per_token
    assert flops.sample_flops(m, s, nfe) == sample
