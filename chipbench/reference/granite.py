"""The plain reference of granite-4.0-h-small (GraniteMoeHybrid,
https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json)
as the DEIS repo's diffusion LM: float32 PyTorch with TF32 off, or float8 /
bf16 as :mod:`chipbench.reference.model` computes its control and witness.

Written from the model's equations; imports nothing of the program and
nothing of JAX. What :class:`Net` adds to :class:`model.Net`, layer by
layer (``model.Net`` gives the rest: the RMS norm, the router, the routed
experts, the SSD scan, the time embedding, the solve):

- the input stream ``h = x * embedding_multiplier``, then the time
  embedding added at every position;
- each branch adds ``residual_multiplier * out`` (mixer and MoE alike);
- attention: GQA with no position embedding (``pos_embedding`` "none",
  NoPE) and the softmax scale ``attn_scale`` (the config's
  ``attention_multiplier``) in place of 1/sqrt(head_dim);
- every feed-forward a MoE plus a shared expert ``(silu(x Wg) * (x Wu)) Wd``
  of width ``moe.shared_ff``, added to the routed experts' output;
- the Mamba-2 mixer's gated norm gate-first where ``ssm.gate_first``:
  ``rms(y_skip * silu(z)) * (1 + scale)`` (the published
  ``RMSNormGated(norm_before_gate=False)``);
- the vocabulary logits divided by ``logits_scaling``.

Departures from the published model, each also the program's:
- the objective is this repo's diffusion LM: bidirectional attention, a
  time embedding added at every position, an eps head ``rms(h) W_eps``,
  tokens by argmax through the tied embedding (the published model is a
  causal LM);
- the router keeps a per-row capacity of ``int(1.25 S k / E)`` slots an
  expert, filled token-major then by choice, and drops the pairs past it
  (44 slots at S 256, top-10 of 72); the published router is dropless;
- every RMS norm scales by ``(1 + scale)`` with ``scale`` zero-initialised
  (the published weight is the factor itself, initialised to one);
- the weights are random, from the benchmark's seed.

``layer_leaves`` and ``layer_flops`` add the shared expert to the harness's
layout (``chipbench.weights``) and FLOP count (``chipbench.flops``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import flops as FL
from .. import weights as W
from ..layers import layer_kinds
from . import model as M

F32 = M.F32


def layer_leaves(m: dict, i: int, kinds: tuple, rnd, const) -> dict:
    """The base layer's leaves and, in a MoE layer, the shared expert's
    ``moe.shared`` {w_up (d, f), w_down (f, d), w_gate (d, f)} at width
    ``f = moe.shared_ff``, drawn in that order after the routed experts (the
    port's ``init_moe``)."""
    layer = W.layer_leaves(m, i, kinds, rnd, const)
    f = m["moe"].get("shared_ff", 0) if m.get("moe") else 0
    if kinds[1] == "moe" and f:
        d = m["d_model"]
        s = 1.0 / math.sqrt(d)
        layer["moe"]["shared"] = {"w_up": rnd((d, f), s),
                                  "w_down": rnd((f, d), s / math.sqrt(2 * m["n_layers"])),
                                  "w_gate": rnd((d, f), s)}
    return layer


def layer_flops(m: dict, i: int, seq_len: int) -> float:
    """Layer ``i``'s useful operations per token: the base count and, in a
    MoE layer, the shared expert's three products."""
    kinds = layer_kinds(m)[i]
    n = FL.kind_flops(m, kinds, seq_len)
    if kinds[1] == "moe":
        n += 3 * 2 * m["d_model"] * m["moe"].get("shared_ff", 0)
    return n


class Net(M.Net):
    """:class:`model.Net` with granite's mechanisms (the module's list)."""

    def attention(self, p, x, valid_len):
        """GQA without a position embedding, softmax scale ``attn_scale``
        (0: 1/sqrt(head_dim)), keys past a row's length masked out."""
        m = self.m
        if m.get("pos_embedding", "rope") != "none":
            return super().attention(p, x, valid_len)
        b, s, _ = x.shape
        hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
        nh, nkv = m["n_heads"], m["n_kv_heads"]
        q = self.mm(x, p["wq"]).reshape(b, s, nh, hd)
        k = self.mm(x, p["wk"]).reshape(b, s, nkv, hd).repeat_interleave(nh // nkv, dim=2)
        v = self.mm(x, p["wv"]).reshape(b, s, nkv, hd).repeat_interleave(nh // nkv, dim=2)
        scale = m.get("attn_scale", 0.0) or 1.0 / math.sqrt(hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        qp = torch.arange(s, device=x.device)[:, None]
        kp = torch.arange(s, device=x.device)[None, :]
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device)
        if m.get("sliding_window", 0):
            mask = mask & (kp > qp - m["sliding_window"])
        mask = mask[None] & (kp[None] < valid_len[:, None, None])          # (B, S, S)
        logits = logits.masked_fill(~mask[:, None], -1e30)
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)
        return self.mm(out.reshape(b, s, nh * hd), p["wo"])

    def moe(self, p, x):
        """The routed experts (with their capacity) plus the shared expert."""
        out = super().moe(p, x)
        if "shared" in p:
            sh = p["shared"]
            out = out + self.mm(F.silu(self.mm(x, sh["w_gate"])) * self.mm(x, sh["w_up"]),
                                sh["w_down"])
        return out

    def ssm(self, p, x):
        """The Mamba-2 mixer, its gated norm gate-first where the config says
        so (else :meth:`model.Net.ssm`)."""
        m, sc = self.m, self.m["ssm"]
        if not sc.get("gate_first", False):
            return super().ssm(p, x)
        b, s, _ = x.shape
        d_inner = sc["expand"] * m["d_model"]
        n, hp = sc["state_dim"], sc["head_dim"]
        nh = d_inner // hp
        z, xbc, dt = torch.split(self.mm(x, p["in_proj"]), [d_inner, d_inner + 2 * n, nh], dim=-1)
        dt = F.softplus(dt + p["dt_bias"].to(F32))
        a_log = dt * -torch.exp(p["A_log"].to(F32))                        # log a, (B, S, H)
        kw = p["conv_w"].shape[0]
        xp = F.pad(xbc, (0, 0, kw - 1, 0))
        cw = p["conv_w"].to(F32)
        conv = sum(xp[:, i:i + s] * cw[i] for i in range(kw)) + p["conv_b"].to(F32)
        xs, B, C = torch.split(F.silu(conv), [d_inner, n, n], dim=-1)
        xh = xs.reshape(b, s, nh, hp)
        y = self.scan(xh, a_log, B, C, sc.get("chunk_size", 256))
        y = (y + p["D"].to(F32)[None, None, :, None] * xh).reshape(b, s, d_inner)
        y = y * F.silu(z)
        y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + self.eps) * (1.0 + p["norm_scale"].to(F32))
        return self.mm(y, p["out_proj"])

    def __call__(self, x, t, valid_len):
        """eps(x, t) with the embedding and residual multipliers; the residual
        stream stored in ``prec`` below float32, as :meth:`model.Net.__call__`
        stores it."""
        keep = lambda u: M._round(u, self.prec)
        em = self.m.get("embedding_multiplier", 1.0)
        rm = self.m.get("residual_multiplier", 1.0)
        h = keep(keep(x.to(F32) * em) + self.time_embedding(t)[:, None])
        for layer in self.w["blocks"]:
            hn = self.rms(h, layer["norm1"])
            if "ssm" in layer:
                h = keep(h + rm * self.ssm(layer["ssm"], hn))
            else:
                h = keep(h + rm * self.attention(layer["attn"], hn, valid_len))
            if "moe" in layer:
                h = keep(h + rm * self.moe(layer["moe"], self.rms(h, layer["norm2"])))
            elif "mlp" in layer:
                h = keep(h + rm * self.mlp(layer["mlp"], self.rms(h, layer["norm2"])))
        return self.mm(self.rms(h, self.w["final_norm"]), self.w["eps_head"])

    def logits(self, x0):
        """The vocabulary logits divided by ``logits_scaling``."""
        return super().logits(x0) / self.m.get("logits_scaling", 1.0)
