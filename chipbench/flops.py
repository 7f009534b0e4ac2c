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

from . import spec
from .bounds import k3_work
from .layers import layer_kinds


def kind_flops(m: dict, kinds: tuple, seq_len: int) -> float:
    """Operations per real token of one layer of kinds (mixer, ffn) in a row
    of ``seq_len`` tokens: the SSM mixer's or attention's, then nothing, a
    dense GLU/MLP, or the router and the top-k experts."""
    mixer, ffn = kinds
    d = m["d_model"]
    if mixer == "ssm":
        s = m["ssm"]
        d_in = s["expand"] * d
        heads = d_in // s["head_dim"]
        conv_ch = d_in + 2 * s["state_dim"]
        n = 2 * d * (2 * d_in + 2 * s["state_dim"] + heads)            # in-projection
        n += 2 * s["conv_width"] * conv_ch                               # convolution
        _, scan = k3_work(1, seq_len, heads, s["head_dim"], s["state_dim"], s["chunk_size"])
        n += scan / seq_len                                              # SSD scan
        n += 2 * d_in * d                                                # out-projection
    else:
        hd = m.get("head_dim") or d // m["n_heads"]
        qd, kvd = m["n_heads"] * hd, m["n_kv_heads"] * hd
        n = 2 * d * (2 * qd + 2 * kvd)                                  # q, k, v, o
        ctx = min(seq_len, m["sliding_window"]) if m.get("sliding_window") else seq_len
        n += 4 * ctx * m["n_heads"] * hd                                # scores, PV
    if ffn == "moe":
        e = m["moe"]
        n += 2 * d * e["num_experts"] + e["top_k"] * 3 * 2 * d * m["d_ff"]
    elif ffn == "dense":
        n += (3 if m.get("glu", True) else 2) * 2 * d * m["d_ff"]
    return n


def per_token_forward(m: dict, seq_len: int, arch=None) -> float:
    """Operations of one eps-network forward per real token of a row of
    ``seq_len`` tokens (config dict ``m``: the port's ModelConfig fields),
    summed over the layers by their kinds; a layer's count comes from
    ``arch.layer_flops(m, i, seq_len)`` where the reference module ``arch``
    (:func:`chipbench.spec.arch_module`; default ``model``) defines it."""
    arch = arch or spec.arch_module()
    own = getattr(arch, "layer_flops", None)
    d = m["d_model"]
    n = 0.0
    for i, kinds in enumerate(layer_kinds(m)):
        n += own(m, i, seq_len) if own else kind_flops(m, kinds, seq_len)
    return n + 2 * d * d                                                # eps head


def sample_flops(m: dict, seq_len: int, nfe: int, arch=None) -> float:
    """One row's solve of ``nfe`` forwards, its time embedding per forward
    and its decode to tokens."""
    d, te = m["d_model"], m.get("time_emb_dim", 256)
    per_nfe = seq_len * per_token_forward(m, seq_len, arch) + 2 * (te * d + d * d)
    return nfe * per_nfe + seq_len * 2 * d * m["vocab_size"]
