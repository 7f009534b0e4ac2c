"""Useful operations of a diffusion sample: what the model's equations need
for the real (unpadded) tokens, whatever the program pads or re-reads.

A frozen copy of the port's ``launch/dryrun.py::model_flops`` idea (2 x
N_active per token per forward, the MoE's experts at top_k / E, the
embedding lookup free), with the terms it leaves out added: attention's
scores and PV product (4 S n_heads head_dim per token per layer,
bidirectional, S capped by the window), the SSD scan's (from the K3 count
of :func:`chipbench.bounds.k3_work`), the depthwise convolution, the time
embedding once per row and NFE, and the decode's vocabulary product once
per token at the end.
"""
from __future__ import annotations

from .bounds import k3_work


def per_token_forward(m: dict, seq_len: int) -> float:
    """Operations of one eps-network forward per real token of a row of
    ``seq_len`` tokens (config dict ``m``: the port's ModelConfig fields)."""
    d = m["d_model"]
    n = 0.0
    for _ in range(m["n_layers"]):
        if m["arch_type"] == "ssm":
            s = m["ssm"]
            d_in = s["expand"] * d
            heads = d_in // s["head_dim"]
            conv_ch = d_in + 2 * s["state_dim"]
            n += 2 * d * (2 * d_in + 2 * s["state_dim"] + heads)      # in-projection
            n += 2 * s["conv_width"] * conv_ch                          # convolution
            _, scan = k3_work(1, seq_len, heads, s["head_dim"], s["state_dim"],
                              s["chunk_size"])
            n += scan / seq_len                                          # SSD scan
            n += 2 * d_in * d                                            # out-projection
            continue
        hd = m.get("head_dim") or d // m["n_heads"]
        qd, kvd = m["n_heads"] * hd, m["n_kv_heads"] * hd
        n += 2 * d * (2 * qd + 2 * kvd)                                 # q, k, v, o
        ctx = min(seq_len, m["sliding_window"]) if m.get("sliding_window") else seq_len
        n += 4 * ctx * m["n_heads"] * hd                                # scores, PV
        if m.get("moe"):
            e = m["moe"]
            n += 2 * d * e["num_experts"] + e["top_k"] * 3 * 2 * d * m["d_ff"]
        else:
            n += (3 if m.get("glu", True) else 2) * 2 * d * m["d_ff"]
    return n + 2 * d * d                                                # eps head


def sample_flops(m: dict, seq_len: int, nfe: int) -> float:
    """One row's solve of ``nfe`` forwards, its time embedding per forward
    and its decode to tokens."""
    d, te = m["d_model"], m.get("time_emb_dim", 256)
    per_nfe = seq_len * per_token_forward(m, seq_len) + 2 * (te * d + d * d)
    return nfe * per_nfe + seq_len * 2 * d * m["vocab_size"]
