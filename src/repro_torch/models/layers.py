"""Backbone building blocks: norms, RoPE, attention (GQA/MQA, sliding
window, per-row key masking, logit softcap, no position embedding and a
softmax scale of the config's, the KV cache and its sliding-window ring,
cross-attention; kernel K2 on request), GLU MLPs, the top-k capacity MoE
(GShard one-hot or slot-table dispatch, with its aux losses; a shared
expert beside the routed ones; hand-written kernels around the experts'
products on request) and the diffusion time embedding.

The counterpart of ``repro.models.layers``.
Plain functions over parameter dicts with the reference's layouts: weights
``(d_in, d_out)`` applied as ``x @ w``, q/k/v as ``(B, S, H, D)``, experts
``(E, d_in, d_out)``. Every matmul accumulates in float32 and rounds once
to the input dtype (cuBLAS and the CPU kernels both do so for bfloat16);
the attention logits and softmax stay in float32.

Under a mesh (the sharded train step) the parameters come placed
(:func:`repro_torch.sharding.tensor_parallel.place`): attention's q/k/v are
split over 'model' on their output (whole heads where the head count
divides, else gathered), ``wo`` on its input; the MLP's and the experts'
``w_up`` / ``w_gate`` on d_ff and ``w_down`` on its input; each pair meets
in one all-reduce over 'model' (Megatron's pairing).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import moe_dispatch as MD
from ..kernels import ops
from ..obs.trace import NULL_TRACER
from ..sharding import tensor_parallel as TP


def matmul(x, w):
    """``x @ w``: float32 accumulation, one rounding to ``x.dtype``."""
    return x @ w


def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm in float32 scaled by ``(1 + scale)``, cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.to(torch.float32))).to(x.dtype)


def sinusoidal_embedding(t, dim: int, max_period: float = 10_000.0):
    """Timestep embedding for diffusion conditioning (t scalar or (B,)):
    ``[cos(1000 t f), sin(1000 t f)]`` over geometric frequencies f."""
    t = torch.atleast_1d(t)
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].to(torch.float32) * freqs[None, :] * 1000.0
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# --------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, positions, theta: float):
    """positions: (..., S) int -> cos/sin of shape (..., S, head_dim//2)."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D). Rotates the split halves (x1, x2), not interleaved
    pairs, in float32."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention
def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def attention_scores(q, k, v, mask, softcap: float = 0.0, scale=None):
    """q: (B,Sq,H,D), k/v: (B,Sk,H,D) (already GQA-expanded); mask
    broadcastable to (B, H, Sq, Sk), True = attend. Float32 logits times
    ``scale`` (None: divided by sqrt(D)) and softmax; the probabilities are
    cast to v's dtype before the PV product."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32))
    logits = logits / math.sqrt(d) if scale is None else logits * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def make_attention_mask(q_pos, kv_pos, causal: bool, window: int = 0,
                        kv_valid=None):
    """Boolean mask (B?, 1, Sq, Sk) from position tensors."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                      dtype=torch.bool, device=qp.device)
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    if kv_valid is not None:
        mask = mask & kv_valid[..., None, :]
    return mask[..., None, :, :] if mask.ndim == 2 else mask[:, None]


def init_attention(gen, cfg: ModelConfig, dtype, device):
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = 1.0 / math.sqrt(d)
    n = lambda shape: torch.randn(shape, generator=gen, device=device)
    return {
        "wq": (n((d, qd)) * s).to(dtype),
        "wk": (n((d, kvd)) * s).to(dtype),
        "wv": (n((d, kvd)) * s).to(dtype),
        "wo": (n((qd, d)) * s / math.sqrt(2 * cfg.n_layers)).to(dtype),
    }


def _kv_cache_write(buf, new, index: int):
    """Write ``new`` (B, s, KV, D) into ``buf`` (B, S_cache, KV, D) in place at
    sequence position ``index``, clamped so the slice fits (the reference's
    ``dynamic_update_slice``)."""
    i = min(max(int(index), 0), buf.shape[1] - new.shape[1])
    buf[:, i:i + new.shape[1]] = new.to(buf.dtype)
    return buf


def _decode_mask(cfg: ModelConfig, positions, s_cache: int, cache_index: int,
                 device):
    """Mask (B, 1, s, S_cache) of a decode step against the whole cache. A
    sliding-window cache of exactly ``window`` slots is a ring: slot ``j``
    holds position ``cache_index - (cache_index - j) % window`` (valid when
    >= 0). Otherwise the cache is positional: causal, plus the window."""
    slot = torch.arange(s_cache, device=device)
    q = positions[..., :, None][:, None]                   # (B, 1, s, 1)
    if cfg.sliding_window and s_cache == cfg.sliding_window:
        kv_pos = cache_index - torch.remainder(cache_index - slot, s_cache)
        return (kv_pos <= q) & (kv_pos >= 0)
    mask = slot <= q
    if cfg.sliding_window:
        mask = mask & (slot > q - cfg.sliding_window)
    return mask


def attention(params, cfg: ModelConfig, x, positions, *, causal=True,
              cache=None, cache_index=None, kv_override=None,
              return_kv: bool = False, valid_len=None, use_kernels=False):
    """Multi-head attention with GQA + RoPE + optional SWA and a KV cache.
    ``cfg.pos_embedding`` "none" leaves q and k unrotated (NoPE), and
    ``cfg.attn_scale``, when set, is the softmax scale on both routes.

    cache: None (a full sequence) or ``{"k", "v"}`` of shape (B, S_cache,
    KV, D): decode writes this step's post-RoPE k and v into it IN PLACE at
    ``cache_index`` (an int; ``cache_index % window`` for a sliding-window
    ring of ``window`` slots) and attends over the whole cache.
    return_kv: prefill -- return the post-RoPE k and v as the cache, in
    ring layout of ``window`` slots when ``sliding_window`` is set and the
    sequence is longer than the window.
    valid_len: optional (B,) int -- per-row true sequence length when rows
    are right-padded to a bucketed S; key positions >= valid_len are masked
    out so a row's content does not depend on the bucket it landed in.
    kv_override: ``(k, v)`` of shape (B, Sk, KV, D), already projected (on
    a mesh ``(k, v, k0)``, ``k0`` the first kv head they hold):
    cross-attention. q gets no RoPE, every query attends to every key, and
    no cache is read or written; it takes the plain route whatever
    ``use_kernels`` says, as the reference's ``use_pallas`` route excludes
    it.
    use_kernels: the scores run through kernel K2
    (:func:`repro_torch.kernels.ops.flash_attention`), which reads the KV
    heads in place. K2 has no padding operand, no softcap and no cache, so
    ``valid_len``, a ``cache`` or a config with ``logit_softcap`` raises
    rather than run the plain route or drop the softcap (the reference's
    ``use_pallas`` takes K2 only with ``valid_len`` and ``cache`` None).
    Returns ``(out, new_cache)``: the block's output (B, S, d_model) and
    the cache (None unless ``cache`` or ``return_kv``).

    On a mesh (placed weights) each rank runs its query heads
    (:func:`head_block`) and ``wo`` makes the output whole, on the plain
    route only. A cache then holds the kv heads this rank computes with:
    its block of them where the kv head count divides 'model', else all
    (``training.steps.cache_to_compute``).
    """
    if TP.split_of(params["wq"]) is not None and use_kernels:
        raise ValueError("attention on a mesh runs on the plain route: no kernel")
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    n_rep = cfg.n_heads // cfg.n_kv_heads
    q, q0 = head_block(x, params["wq"], cfg.n_heads, hd)
    q_split = q.shape[2] < cfg.n_heads
    if kv_override is not None:
        k, v, k0 = kv_override if len(kv_override) == 3 else (*kv_override, 0)
        k, v = _kv_for_heads(k, v, k0, q0, q.shape[2], n_rep)
        mask = torch.ones((1, 1, s, k.shape[1]), dtype=torch.bool, device=x.device)
        out = attention_scores(q, k, v, mask, cfg.logit_softcap, cfg.attn_scale or None)
        return TP.linear(out.reshape(b, s, -1), params["wo"], x_split=q_split)[0], None
    k, k0 = head_block(x, params["wk"], cfg.n_kv_heads, hd, q_split)
    v, _ = head_block(x, params["wv"], cfg.n_kv_heads, hd, q_split)
    if cfg.pos_embedding == "rope":
        cos, sin = rope_frequencies(hd, positions, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    elif cfg.pos_embedding != "none":
        raise ValueError(f"pos_embedding must be rope or none, got {cfg.pos_embedding!r}")

    new_cache = None
    if return_kv and cache is None:
        w = cfg.sliding_window
        if w and s > w:
            slots = torch.arange(s - w, s, device=x.device) % w
            ck = k.new_zeros((b, w) + k.shape[2:])
            cv = v.new_zeros((b, w) + v.shape[2:])
            ck[:, slots] = k[:, s - w:]
            cv[:, slots] = v[:, s - w:]
            new_cache = {"k": ck, "v": cv}
        else:
            new_cache = {"k": k, "v": v}
    if cache is not None:
        s_cache = cache["k"].shape[1]
        ring = bool(cfg.sliding_window) and s_cache == cfg.sliding_window
        write = cache_index % s_cache if ring else cache_index
        k = _kv_cache_write(cache["k"], k, write)
        v = _kv_cache_write(cache["v"], v, write)
        new_cache = {"k": k, "v": v}

    if use_kernels:
        if valid_len is not None or cache is not None:
            raise ValueError("kernel K2 has no per-row key length and no KV "
                             "cache; run valid_len or a cache with "
                             "use_kernels=False")
        if cfg.logit_softcap:
            raise ValueError("kernel K2 has no logit softcap; run "
                             f"{cfg.name} with use_kernels=False")
        out = ops.flash_attention(q, k, v, causal=causal, window=cfg.sliding_window,
                                  scale=cfg.attn_scale or None)
        return matmul(out.reshape(b, s, cfg.q_dim), params["wo"]), new_cache
    k, v = _kv_for_heads(k, v, k0, q0, q.shape[2], n_rep)
    if cache is not None:
        mask = _decode_mask(cfg, positions, k.shape[1], cache_index, x.device)
    else:
        kv_valid = None
        if valid_len is not None:
            kv_valid = torch.arange(s, device=x.device)[None, :] < valid_len[:, None]
        mask = make_attention_mask(positions, positions, causal,
                                   cfg.sliding_window, kv_valid=kv_valid)
    out = attention_scores(q, k, v, mask, cfg.logit_softcap, cfg.attn_scale or None)
    return TP.linear(out.reshape(b, s, -1), params["wo"], x_split=q_split)[0], new_cache


def heads_split(w, n_heads: int) -> bool:
    """Whether a placed projection gives each model rank whole heads of its
    own: split over 'model' on its output, the head count dividing."""
    split = TP.split_of(w)
    return split is not None and split.dim == w.ndim - 1 and n_heads % split.ax.model == 0


def head_block(x, w, n_heads: int, hd: int, q_split: bool = False):
    """``x @ w`` as heads: ``(heads (B, S, n, hd), first)``, the ``n`` whole
    heads this rank holds from head ``first`` on (all ``n_heads`` from 0
    for an unplaced weight). On a mesh a product split over 'model' keeps
    its block where the head count divides; any other split is gathered.
    ``q_split``: gathered kv heads feed this rank's query heads only, so
    their grads are summed over 'model'."""
    y, split = TP.linear(x, w)
    b, s = y.shape[:2]
    if heads_split(w, n_heads):
        n = n_heads // TP.split_of(w).ax.model
        return y.reshape(b, s, n, hd), TP.split_of(w).ax.model_rank * n
    return TP.whole(y, split, w, summed=q_split).reshape(b, s, n_heads, hd), 0


def _kv_for_heads(k, v, k0: int, q0: int, nq: int, n_rep: int):
    """k and v (B, S, nk, D) from kv head ``k0`` on, repeated for the ``nq``
    query heads from ``q0`` on (query head h reads kv head h // n_rep)."""
    if q0 % n_rep == 0 and q0 // n_rep == k0 and nq == k.shape[2] * n_rep:
        return _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    idx = torch.div(torch.arange(q0, q0 + nq, device=k.device), n_rep,
                    rounding_mode="floor") - k0
    return k[:, :, idx], v[:, :, idx]


# --------------------------------------------------------------------- MLPs
def init_mlp(gen, cfg: ModelConfig, dtype, device, d_ff: int = 0):
    """A GLU MLP's weights of width ``d_ff`` (0: ``cfg.d_ff``)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    s = 1.0 / math.sqrt(d)
    n = lambda shape: torch.randn(shape, generator=gen, device=device)
    p = {"w_up": (n((d, f)) * s).to(dtype),
         "w_down": (n((f, d)) * s / math.sqrt(2 * cfg.n_layers)).to(dtype)}
    if cfg.glu:
        p["w_gate"] = (n((d, f)) * s).to(dtype)
    return p


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation; so does the reference
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def mlp(params, cfg: ModelConfig, x):
    up, split = TP.linear(x, params["w_up"])
    if cfg.glu:
        up = _act(cfg.act)(TP.linear(x, params["w_gate"])[0]) * up
    else:
        up = _act(cfg.act)(up)
    return TP.linear(up, params["w_down"], x_split=split)[0]


# ---------------------------------------------------------------------- MoE
def init_moe(gen, cfg: ModelConfig, dtype, device):
    """Router (d, E) in float32; ``w_gate``/``w_up`` (E, d, f) and
    ``w_down`` (E, f, d) in ``dtype``, with the reference's scales; with
    ``cfg.moe.shared_ff``, a shared expert ``shared`` (an MLP of that
    width, :func:`init_mlp`), drawn after them."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    s = 1.0 / math.sqrt(d)
    n = lambda shape: torch.randn(shape, generator=gen, device=device)
    p = {
        "router": (n((d, e)) * s).to(torch.float32),
        "w_gate": (n((e, d, f)) * s).to(dtype),
        "w_up": (n((e, d, f)) * s).to(dtype),
        "w_down": (n((e, f, d)) * s / math.sqrt(2 * cfg.n_layers)).to(dtype),
    }
    if cfg.moe.shared_ff:
        p["shared"] = init_mlp(gen, cfg, dtype, device, cfg.moe.shared_ff)
    return p


def moe_route(params, cfg: ModelConfig, x) -> dict:
    """Top-k routing with per-row expert capacity (the first half of the
    reference's ``moe``). x: (B, S, d). The float32 router logits and
    their softmax pick each token's top-k experts; :func:`moe_queue` places
    them in the experts' queues."""
    logits = x.to(torch.float32) @ params["router"]
    gates = torch.softmax(logits, dim=-1)
    _, gate_idx = torch.topk(gates, cfg.moe.top_k, dim=-1)
    return moe_queue(cfg, logits, gates, gate_idx)


def _capacity(cfg: ModelConfig, s: int, k: int, e: int) -> int:
    """Each expert's slots per row: ``max(1, int(capacity_factor * S * k /
    E))`` capped at S."""
    return min(max(1, int(cfg.moe.capacity_factor * s * k / e)), s)


def moe_queue(cfg: ModelConfig, logits, gates, gate_idx) -> dict:
    """Queue places and drops of the chosen experts ``gate_idx`` (B, S, k).
    Returns a dict of

    ``cap``: ``max(1, int(capacity_factor * S * k / E))`` capped at S, per
    row over all S positions (a bucket's padded tail included);
    ``logits``/``gates``: (B, S, E) float32 router logits and softmax;
    ``gate_vals``/``gate_idx``: (B, S, k) the chosen experts' gates
    renormalised to sum 1, and the experts;
    ``pos``: (B, S, k) int64 place of each (token, choice) in its expert's
    queue, counted token-major then by choice (the reference's float32
    cumulative sum, exact in integers);
    ``within_cap``: (B, S, k) ``pos < cap``; the other pairs are dropped."""
    b, s, e = gates.shape
    k = gate_idx.shape[-1]
    cap = _capacity(cfg, s, k, e)
    gate_vals = gates.gather(-1, gate_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    choice = F.one_hot(gate_idx, e)                               # (B,S,k,E)
    flat = choice.reshape(b, s * k, e)
    pos = (flat.cumsum(1) - flat).reshape(b, s, k, e)
    pos = (pos * choice).sum(-1)
    return dict(cap=cap, logits=logits, gates=gates, gate_vals=gate_vals,
                gate_idx=gate_idx, pos=pos, within_cap=pos < cap)


def _expert_glu(params, xin, glu):
    """The experts' GLU on their slots laid out (E, N, d): one product per
    expert for up and gate, ``glu(h, g)`` (``silu(g) * h`` in float32: the
    reference's ``moe`` applies silu whatever ``cfg.act`` says), then the
    down product. Returns (E, N, d)."""
    h, split = TP.linear(xin, params["w_up"], op=torch.bmm)
    g, _ = TP.linear(xin, params["w_gate"], op=torch.bmm)      # split as w_up
    out, _ = TP.linear(glu(h, g), params["w_down"], x_split=split, op=torch.bmm)
    return out


def _experts(params, xin):
    """The experts on their slots: xin (B, E, C, d) -> (B, E * C, d), over
    all rows' slots at once (:func:`_expert_glu` on (E, B * C, d))."""
    b, e, c, d = xin.shape
    out = _expert_glu(params, xin.transpose(0, 1).reshape(e, b * c, d), MD.glu_ref)
    return out.reshape(e, b, c, d).transpose(0, 1).reshape(b, e * c, d)


def _dispatch_einsum(params, x, r, tracer=NULL_TRACER):
    """GShard one-hot dispatch: a (B, S, E, C) dispatch tensor gathers the
    slots by a product, and a combine tensor of the gate values scatters
    the experts' outputs back by another. Spans ``dispatch`` (both tensors
    and the gathering product), ``experts`` and ``combine``."""
    b, s, d = x.shape
    e, cap = r["gates"].shape[-1], r["cap"]
    with tracer.span("dispatch"):
        within = r["within_cap"]
        choice = F.one_hot(r["gate_idx"], e).to(torch.float32)           # (B,S,k,E)
        pos_onehot = F.one_hot(torch.where(within, r["pos"], 0), cap).to(torch.float32)
        disp_k = choice[..., None] * pos_onehot[..., None, :] * within[..., None, None]
        dispatch = disp_k.sum(2)                                          # (B,S,E,C)
        combine = torch.einsum("bsk,bskec->bsec", r["gate_vals"], disp_k)
        xin = torch.bmm(dispatch.to(x.dtype).reshape(b, s, e * cap).transpose(1, 2), x)
    with tracer.span("experts"):
        out_e = _experts(params, xin.reshape(b, e, cap, d))
    with tracer.span("combine"):
        out = torch.bmm(combine.to(x.dtype).reshape(b, s, e * cap), out_e)
    return out, dispatch.sum(-1).mean((0, 1))


def _dispatch_gather(params, x, r, tracer=NULL_TRACER):
    """Slot-table dispatch: each kept (token, choice) writes its token id
    into slot ``expert * C + pos`` of an (E * C + 1)-slot table (dropped
    pairs into the last, a dustbin cut off after), the experts read their
    slots by a gather, and each token gathers its k outputs back, weighted
    by its gates (a dropped pair reads slot 0 at weight 0). Spans
    ``dispatch`` (the table and the gather), ``experts`` and ``combine``."""
    b, s, d = x.shape
    e, cap = r["gates"].shape[-1], r["cap"]
    k = r["gate_idx"].shape[-1]
    with tracer.span("dispatch"):
        valid = r["within_cap"].reshape(b, s * k)
        flat_slot = (r["gate_idx"] * cap + r["pos"]).reshape(b, s * k)
        tok_ids = torch.arange(s, device=x.device)[None, :, None].expand(b, s, k).reshape(
            b, s * k)
        slot = torch.where(valid, flat_slot, e * cap)
        table = torch.zeros((b, e * cap + 1), dtype=torch.long, device=x.device)
        table = table.scatter(1, slot, torch.where(valid, tok_ids, 0))[:, :-1]
        occupied = torch.zeros((b, e * cap + 1), dtype=torch.bool, device=x.device)
        occupied = occupied.scatter(1, slot, valid)[:, :-1]
        xin = torch.gather(x, 1, table[..., None].expand(b, e * cap, d))
        xin = torch.where(occupied[..., None], xin, 0)
    with tracer.span("experts"):
        out_e = _experts(params, xin.reshape(b, e, cap, d))
    with tracer.span("combine"):
        gflat = torch.where(valid, flat_slot, 0)
        got = torch.gather(out_e, 1, gflat[..., None].expand(b, s * k, d)).reshape(b, s, k, d)
        w = (r["gate_vals"] * r["within_cap"]).to(got.dtype)
        out = torch.einsum("bsk,bskd->bsd", w, got)
    frac = (F.one_hot(r["gate_idx"], e) * r["within_cap"][..., None]).sum(2)
    return out, frac.to(torch.float32).mean((0, 1))


def _count(tracer, b: int, s: int, k: int, e: int, cap: int) -> None:
    """Into a tracer's registry (not ``NULL_TRACER``'s): the slots the
    experts compute (B E C) and the (token, choice) pairs routed (B S k)."""
    if tracer is not NULL_TRACER:
        tracer.registry.counter("moe_expert_slots_total", "expert slots computed (B E C)").inc(
            b * e * cap)
        tracer.registry.counter("moe_routed_pairs_total", "(token, choice) pairs routed "
                                "(B S k)").inc(b * s * k)


def _moe_kernels(params, cfg: ModelConfig, x, tracer=NULL_TRACER):
    """The kernel route of :func:`moe` (:mod:`~repro_torch.kernels.moe_dispatch`;
    on CPU tensors its plain versions): the router's product, then
    ``route`` (top-k, gates, queue places, the (E, B C) slot table),
    ``gather`` (the experts' rows straight into (E, B C, d)), the up and
    gate products, ``glu``, the down product, the shared expert, and
    ``combine`` (each token's k outputs by slot, weighted by its gates,
    plus the shared expert's output, one rounding). Spans ``route``,
    ``dispatch``, ``experts``, ``shared``, ``combine``. No backward: raises
    where autograd would record it."""
    mcfg = cfg.moe
    leaves = [x] + [v for v in params.values() if isinstance(v, torch.Tensor)] \
        + list(params.get("shared", {}).values())
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        raise RuntimeError("the MoE's kernel route has no backward: run it under "
                           "torch.no_grad(), or with use_kernels=False")
    b, s, _ = x.shape
    e, k = mcfg.num_experts, mcfg.top_k
    cap = _capacity(cfg, s, k, e)
    with tracer.span("route"):
        r = MD.route(x.to(torch.float32) @ params["router"], top_k=k, cap=cap)
    _count(tracer, b, s, k, e, cap)
    with tracer.span("dispatch"):
        xin = MD.gather(x, r["table"])
    with tracer.span("experts"):
        out_e = _expert_glu(params, xin, MD.glu)
    shared = None
    if mcfg.shared_ff:
        with tracer.span("shared"):
            shared = mlp(params["shared"], cfg, x)
    with tracer.span("combine"):
        out = MD.combine(out_e, r["slot"], r["gate_vals"], shared)
    me = r["gate_sum"].sum(0) / (b * s)
    frac_dispatched = r["kept"].sum(0).to(torch.float32) / (b * s)
    lb_loss = e * (me * frac_dispatched).sum() * mcfg.load_balance_loss
    z_loss = (r["lse"] ** 2).mean() * mcfg.router_z_loss
    return out, {"moe_lb": lb_loss, "moe_z": z_loss}


def moe(params, cfg: ModelConfig, x, tracer=NULL_TRACER, use_kernels: bool = False):
    """Top-k capacity-based MoE (GShard/Switch) over x (B, S, d). Two
    dispatch modes on the plain route, as the reference's
    (``cfg.moe_dispatch``): "einsum" (one-hot dispatch and combine products)
    and "gather" (a slot table, gathers in and out). Both drop the same
    (token, choice) pairs and agree to rounding. With ``cfg.moe.shared_ff``
    a shared expert (:func:`mlp` over ``params["shared"]``) sees every token
    and its output is added to the routed experts'. Returns ``(out,
    {"moe_lb", "moe_z"})``: the load-balance loss ``E * sum(mean gate *
    share dispatched)`` and the router z-loss ``mean(logsumexp(logits)^2)``,
    each times its coefficient (the shared expert takes no part in them).

    ``use_kernels`` with x on a CUDA device: the kernel route
    (:func:`_moe_kernels`, four hand-written kernels around the experts'
    products), whatever ``cfg.moe_dispatch`` says: both modes compute the
    same pairs, so the route has one algorithm. It has no backward (it
    raises where autograd would record it). On a CPU tensor, and without
    ``use_kernels``, the plain route of ``cfg.moe_dispatch``.

    ``tracer``: spans ``route``, then ``dispatch``, ``experts`` and
    ``combine`` (:func:`_dispatch_einsum`, :func:`_dispatch_gather`), then
    ``shared`` (on the kernel route before ``combine``, which adds it); a
    tracer other than ``NULL_TRACER`` also counts into its registry
    ``moe_expert_slots_total`` (B E C, the slots the experts compute) and
    ``moe_routed_pairs_total`` (B S k, the (token, choice) pairs routed),
    both known on the host.

    On a mesh the rows are this rank's block of the batch, so the batch dim
    is split over the batch axes (``cfg.act_shard_axes`` pins it there: the
    sharded loss refuses a batch that is not split over them), the experts
    are split over 'model' on d_ff, and both losses take their batch means
    over the whole batch (``batch_mean``)."""
    if use_kernels and x.is_cuda:
        return _moe_kernels(params, cfg, x, tracer)
    mcfg = cfg.moe
    ax = TP.axes_of(params["router"])
    with tracer.span("route"):
        r = moe_route(params, cfg, x)
    b, s, k = r["gate_idx"].shape
    _count(tracer, b, s, k, mcfg.num_experts, r["cap"])
    if cfg.moe_dispatch == "gather":
        out, frac_dispatched = _dispatch_gather(params, x, r, tracer)
    elif cfg.moe_dispatch == "einsum":
        out, frac_dispatched = _dispatch_einsum(params, x, r, tracer)
    else:
        raise ValueError(f"moe_dispatch must be einsum or gather, got {cfg.moe_dispatch!r}")
    if mcfg.shared_ff:
        with tracer.span("shared"):
            out = out + mlp(params["shared"], cfg, x)
    me = TP.batch_mean(r["gates"].mean((0, 1)), ax)
    frac_dispatched = TP.batch_mean(frac_dispatched, ax)
    lb_loss = mcfg.num_experts * (me * frac_dispatched).sum() * mcfg.load_balance_loss
    z_loss = TP.batch_mean((torch.logsumexp(r["logits"], -1) ** 2).mean(), ax) \
        * mcfg.router_z_loss
    return out, {"moe_lb": lb_loss, "moe_z": z_loss}
