"""The plain reference: the diffusion LM's eps-network, the DEIS solve and
the decode, in float32 PyTorch with TF32 off (or, as the control, computed
in float8: the products' operands and the stored residual stream; in bf16
the same way as a witness of the program's own precision).

Written from the model's equations, not from the program: imports nothing
of the program, nothing of the JAX package. It reads the benchmark's own
weights (the dict the benchmark made, which the program was handed too)
and casts each layer's weights to float32 as the layer runs, so a model
whose float32 weights do not fit the card (mixtral at 16 layers: 95 GB)
still runs, layer by layer.

Architecture, per layer (the diffusion LM of the DEIS repo: bidirectional,
time-conditioned): ``h += mixer(rms(h))``, then ``h += moe(rms(h))`` where
the model has experts. rms(x) = x / sqrt(mean(x^2) + eps) * (1 + scale).
Attention: GQA with RoPE on split halves (the config's theta), keys past a row's
true length masked out, a sliding window ``kp > qp - window``, softmax in
float32. MoE: float32 router, softmax, top-k renormalised, a per-row
capacity ``int(capacity_factor * S * k / E)`` (S the row's padded length)
filled token-major then by choice; a pair past capacity is dropped; each
expert is ``(silu(x Wg) * (x Wu)) Wd``. Mamba2 (SSD) mixer: in-projection
to [z, xBC, dt], a depthwise causal convolution of width 4 with silu,
dt = softplus(dt + dt_bias), a = exp(-dt exp(A_log)), the scan
h_t = a_t h_{t-1} + x_t B_t^T, y_t = C_t h_t + D x_t, a gated RMS norm
y * rsqrt(mean(y^2) + eps) * (1 + scale) * silu(z), the out-projection.
The time embedding ``[cos(1000 t f), sin(1000 t f)]`` goes through
``silu(. W1 + b1) W2 + b2`` and is added at every position; the eps head
is ``rms(h) W_eps``; tokens are ``argmax((x0 / 25) W_lm)``.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import quadrature as Q

X0_SCALE = 25.0
F32 = torch.float32
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """TF32 off for the products (restored on exit)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def _round(t, prec: str):
    """``t`` rounded to ``prec`` and back in float32: "fp8" (e4m3, one scale
    per tensor putting its largest magnitude at the format's top), "bf16",
    or "fp32" (unchanged)."""
    if prec == "fp8":
        scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (t / scale).to(FP8).to(F32) * scale
    if prec == "bf16":
        return t.to(torch.bfloat16).to(F32)
    return t


class Net:
    """The eps-network over the benchmark's weights ``w`` (the port's layout:
    ``embed``, ``blocks`` [per layer: ``norm1``, ``attn`` {wq, wk, wv, wo} or
    ``ssm`` {in_proj, conv_w, conv_b, A_log, dt_bias, D, norm_scale,
    out_proj}, ``norm2``, ``moe`` {router, w_gate, w_up, w_down}],
    ``final_norm``, ``lm_head`` (absent when tied to ``embed``), ``time_mlp``
    {w1, b1, w2, b2},
    ``eps_head``) and the model sizes ``m`` (the config file's ``model``).
    ``prec``: "fp32" (the reference), "fp8" (the control: computed in
    float8, every weight product's operands and the stored residual stream
    rounded to e4m3) or "bf16" (a witness of the program's own precision,
    the same roundings to bf16); the router, the scores, the scan and the
    products' accumulation stay float32 in all three."""

    def __init__(self, w: dict, m: dict, prec: str = "fp32"):
        self.w, self.m, self.prec = w, m, prec
        self.eps = m.get("norm_eps", 1e-6)

    def mm(self, x, wt):
        return _round(x, self.prec) @ _round(wt.to(F32), self.prec)

    def rms(self, x, scale):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * (1.0 + scale.to(F32))

    def time_embedding(self, t):
        dim = self.m.get("time_emb_dim", 256)
        half = dim // 2
        freqs = torch.exp(-math.log(10_000.0) * torch.arange(half, dtype=F32, device=t.device) / half)
        arg = t[:, None].to(F32) * freqs[None] * 1000.0
        te = torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)
        tm = self.w["time_mlp"]
        te = F.silu(self.mm(te, tm["w1"]) + tm["b1"].to(F32))
        return self.mm(te, tm["w2"]) + tm["b2"].to(F32)

    def attention(self, p, x, valid_len):
        m = self.m
        b, s, _ = x.shape
        hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
        nh, nkv = m["n_heads"], m["n_kv_heads"]
        q = self.mm(x, p["wq"]).reshape(b, s, nh, hd)
        k = self.mm(x, p["wk"]).reshape(b, s, nkv, hd)
        v = self.mm(x, p["wv"]).reshape(b, s, nkv, hd)
        half = hd // 2
        pos = torch.arange(s, device=x.device, dtype=F32)
        inv = 1.0 / (m.get("rope_theta", 10000.0) ** (torch.arange(half, device=x.device, dtype=F32) / half))
        ang = pos[:, None] * inv[None]
        cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]

        def rope(u):
            u1, u2 = u[..., :half], u[..., half:]
            return torch.cat([u1 * cos - u2 * sin, u2 * cos + u1 * sin], dim=-1)
        q, k = rope(q), rope(k)
        rep = nh // nkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
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
        m = self.m["moe"]
        b, s, d = x.shape
        n_e, top = m["num_experts"], m["top_k"]
        gates = torch.softmax(x @ p["router"].to(F32), dim=-1)              # (B, S, E)
        g_val, g_idx = torch.topk(gates, top, dim=-1)
        g_val = g_val / g_val.sum(-1, keepdim=True)
        cap = min(max(1, int(m.get("capacity_factor", 1.25) * s * top / n_e)), s)
        onehot = F.one_hot(g_idx, n_e).reshape(b, s * top, n_e)          # token-major, then choice
        place = ((onehot.cumsum(1) - onehot) * onehot).sum(-1).reshape(b, s, top)
        keep = place < cap
        out = torch.zeros_like(x)
        flat = x.reshape(b * s, d)
        for e in range(n_e):
            sel = (g_idx == e) & keep                                       # (B, S, k)
            rows = sel.any(-1).reshape(-1).nonzero().squeeze(1)
            if rows.numel() == 0:
                continue
            xe = flat[rows]
            ye = self.mm(F.silu(self.mm(xe, p["w_gate"][e])) * self.mm(xe, p["w_up"][e]),
                         p["w_down"][e])
            wgt = (g_val * sel).sum(-1).reshape(-1)[rows]
            out.view(b * s, d).index_add_(0, rows, ye * wgt[:, None])
        return out

    def mlp(self, p, x):
        """A GLU feed-forward ``(act(x Wg) * (x Wu)) Wd`` (act silu, or
        tanh-approximated gelu), or ``act(x Wu) Wd`` without a gate."""
        act = (lambda u: F.gelu(u, approximate="tanh")) if self.m.get("act") == "gelu" else F.silu
        up = self.mm(x, p["w_up"])
        up = act(self.mm(x, p["w_gate"])) * up if "w_gate" in p else act(up)
        return self.mm(up, p["w_down"])

    def ssm(self, p, x):
        m, sc = self.m, self.m["ssm"]
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
        y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + self.eps) * (1.0 + p["norm_scale"].to(F32))
        return self.mm(y * F.silu(z), p["out_proj"])

    @staticmethod
    def scan(x, a_log, B, C, chunk):
        """h_t = a_t h_{t-1} + x_t B_t^T, y_t = C_t h_t, a chunk at a time:
        inside a chunk y_t = sum_{u<=t} (C_t . B_u) prod_{u<r<=t} a_r x_u,
        across chunks the state carried."""
        b, s, nh, hp = x.shape
        n = B.shape[-1]
        state = torch.zeros((b, nh, hp, n), dtype=F32, device=x.device)
        ys = []
        for c0 in range(0, s, chunk):
            xc, Bc, Cc = x[:, c0:c0 + chunk], B[:, c0:c0 + chunk], C[:, c0:c0 + chunk]
            L = xc.shape[1]
            cum = torch.cumsum(a_log[:, c0:c0 + chunk], dim=1)               # (B, L, H)
            tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
            seg = cum[:, :, None, :] - cum[:, None, :, :]                    # (B, t, u, H)
            decay = torch.exp(seg.masked_fill(~tri[None, :, :, None], float("-inf")))
            w = torch.einsum("btn,bun->btu", Cc, Bc)[..., None] * decay
            y = torch.einsum("btuh,buhp->bthp", w, xc)
            y = y + torch.einsum("btn,bth,bhpn->bthp", Cc, torch.exp(cum), state)
            to_end = torch.exp(cum[:, -1:] - cum)                            # (B, L, H)
            state = state * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
                "buh,bun,buhp->bhpn", to_end, Bc, xc)
            ys.append(y)
        return torch.cat(ys, dim=1)

    def __call__(self, x, t, valid_len):
        """eps(x, t): x (B, S, d) float32, t (B,), valid_len (B,). Below
        float32 the residual stream is stored in ``prec`` too, as the
        program stores it in its dtype: the input, and after every layer's
        residual additions."""
        keep = lambda u: _round(u, self.prec)
        h = keep(keep(x.to(F32)) + self.time_embedding(t)[:, None])
        for layer in self.w["blocks"]:
            hn = self.rms(h, layer["norm1"])
            if "ssm" in layer:
                h = keep(h + self.ssm(layer["ssm"], hn))
            else:
                h = keep(h + self.attention(layer["attn"], hn, valid_len))
            if "moe" in layer:
                h = keep(h + self.moe(layer["moe"], self.rms(h, layer["norm2"])))
            elif "mlp" in layer:
                h = keep(h + self.mlp(layer["mlp"], self.rms(h, layer["norm2"])))
        return self.mm(self.rms(h, self.w["final_norm"]), self.w["eps_head"])

    def logits(self, x0):
        """Vocabulary logits of solved embeddings, float32 (through the
        embedding's transpose where the model ties them)."""
        head = self.w["lm_head"] if "lm_head" in self.w else self.w["embed"].T
        return self.mm(x0 / X0_SCALE, head)


# ------------------------------------------------------------------- solve
def request_generators(seed: int, device):
    """A request's (prior, solve) generators from its seed alone: the two
    words of numpy's SeedSequence(seed), each seeding a torch.Generator on
    the device (the served engine's documented derivation)."""
    a, b = np.random.SeedSequence(int(seed)).generate_state(2)
    return (torch.Generator(device=device).manual_seed(int(a)),
            torch.Generator(device=device).manual_seed(int(b)))


def prior(gen, length: int, padded: int, d: int, device):
    """N(0, 1) of ``length`` rows drawn from ``gen``, zero rows after up to
    ``padded``, times the prior std."""
    x = torch.randn((length, d), generator=gen, device=device, dtype=F32)
    return F.pad(x, (0, 0, 0, padded - length)) * Q.PRIOR_STD


def solve(net: Net, plan: dict, x, valid_len, noise_gens=None):
    """Run ``plan`` from x (R, S, d) at ts[0] to ts[-1]; a stochastic plan
    draws each row's noise (S, d) per step from its own generator in
    ``noise_gens``. Float32 state; float64 tables rounded to float32."""
    dev = x.device
    t32 = lambda a: torch.as_tensor(np.asarray(a), dtype=F32, device=dev)
    rows = x.shape[0]
    n = Q.n_steps(plan)
    if plan["method"] == "rk":
        for k in range(n):
            y = x / float(plan["mu"][k])
            ks = []
            for i in range(len(plan["b"])):
                yi = y + float(plan["h"][k]) * sum(float(plan["A"][k, i, j]) * ks[j] for j in range(i)) \
                    if i else y
                xi = float(plan["stage_mu"][k, i]) * yi
                ks.append(net(xi, t32([plan["stage_t"][k, i]] * rows), valid_len))
            y = y + float(plan["h"][k]) * sum(float(bj) * kj for bj, kj in zip(plan["b"], ks))
            x = float(plan["mu"][k + 1]) * y
        return x
    hist = [torch.zeros_like(x) for _ in range(Q.history_len(plan))]
    for k in range(n):
        eps = net(x, t32([plan["ts"][k]] * rows), valid_len)
        hist = [eps] + hist[:-1]
        wts = plan["C"][k] * (plan["nu"][k] if "nu" in plan else 1.0)
        x_new = float(plan["psi"][k]) * x
        for j, h in enumerate(hist):
            x_new = x_new + float(np.float32(wts[j])) * h
        if plan["stochastic"]:
            z = torch.stack([torch.randn(tuple(x.shape[1:]), generator=g, device=dev, dtype=F32)
                             for g in noise_gens])
            x_new = x_new + float(plan["s"][k]) * z
        x = x_new
    return x
