"""Backbone assembly for every arch family: init + forward.

The counterpart of ``repro.models.transformer`` for ``arch_type`` "dense"
(attention + MLP layers), "moe" (attention + MoE layers), "ssm" (Mamba2
mixer layers, no MLP), "hybrid" (jamba: Mamba2 mixers with one attention
layer per block of ``attn_every``, MoE on odd slots), "encdec" (whisper: a
bidirectional encoder over ``frames``, the stubbed audio frontend's
embeddings, and a decoder whose layers cross-attend to its output) and
"vlm" (paligemma: image-patch ``prefix`` embeddings in front of the text).
The reference groups its layers into blocks of :func:`block_size` slots,
stacks each slot's parameters on a leading ``n_blocks`` axis and scans over
the blocks; here ``params["blocks"]`` (and the encoder's
``params["encoder"]``) is a list of per-layer dicts (layer ``i`` is the
reference's slot ``i % block_size`` of block ``i // block_size``, see
:func:`repro_torch.models.convert.params_from_numpy`) and a Python loop
walks it, each layer's kind given by its index (:func:`_layer_kind`).
``use_kernels`` sends the decoder's self-attention to kernel K2 and the
Mamba2 scan to kernel K3 (the reference's ``use_pallas``), and a MoE on the
card to its dispatch kernels (no backward; the reference leaves its MoE to
XLA). The encoder and
cross-attention take the plain route, as in the reference (its
``_run_encoder`` passes no ``use_pallas``, and its Pallas route excludes
``kv_override``).

Modes: "train" (full sequence), "prefill" (full sequence, returns the
cache) and "decode" (one token against the cache at ``cache_index``);
:func:`init_cache` allocates an empty cache. Caches mirror the params: a
list of per-layer dicts under ``"blocks"``, each of its layer's kind, and
for encdec a list of per-decoder-layer cross-attention ``{"k", "v"}``
under ``"cross"`` (computed once from the encoder's output; decode reads it
and runs no encoder).

Objectives: ``diffusion`` (bidirectional, time-conditioned denoiser -- the
paper's eps_theta; see :mod:`repro_torch.diffusion.lm`) and ``ar``.
:func:`forward` computes the ``eps`` head for diffusion callers and the
vocabulary logits only when asked: eager PyTorch would otherwise spend a
``(B, S, vocab)`` float32 product on every network evaluation that the
sampler never reads.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..obs.trace import NULL_TRACER
from ..sharding import tensor_parallel as TP
from . import layers as L
from . import ssm as S

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(cfg: ModelConfig):
    return _DTYPES[cfg.dtype]


ARCH_TYPES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def _check_arch(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ARCH_TYPES:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r}; the archs are "
                         f"{ARCH_TYPES}")


def block_size(cfg: ModelConfig) -> int:
    """Layers per block of the reference's stacked layout: ``attn_every``
    for hybrid, else 1."""
    if cfg.arch_type == "hybrid":
        return cfg.attn_every
    return 1


def n_blocks(cfg: ModelConfig) -> int:
    bs = block_size(cfg)
    if cfg.n_layers % bs:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of the "
                         f"block size {bs}")
    return cfg.n_layers // bs


def _layer_kind(cfg: ModelConfig, i: int) -> tuple[str, str]:
    """(mixer, mlp) kinds of layer ``i``, from its slot ``i % block_size``:
    mixer "attn" or "ssm"; mlp "dense", "moe" or "none" (pure ssm)."""
    slot = i % block_size(cfg)
    if cfg.arch_type == "ssm":
        mixer = "ssm"
    elif cfg.arch_type == "hybrid":
        mixer = "attn" if slot == (cfg.attn_every // 2) else "ssm"
    else:
        mixer = "attn"
    if cfg.moe is None:
        mlp = "dense"
    elif cfg.moe_every and cfg.moe_every > 1:
        mlp = "moe" if (slot % cfg.moe_every) == 1 else "dense"
    else:
        mlp = "moe"
    if cfg.arch_type == "ssm":
        mlp = "none"  # mamba2 blocks have no separate MLP
    return mixer, mlp


def _init_layer(gen, cfg: ModelConfig, i: int, dtype, device,
                cross: bool = False) -> dict:
    """Layer ``i``'s parameters: ``norm1`` and ``attn`` or ``ssm``; for a
    decoder layer of an encdec arch (``cross``) ``norm_x`` and the
    cross-attention's ``cross``; then ``norm2`` with ``mlp`` or ``moe``
    unless the layer is a pure ssm one."""
    mixer, mlpk = _layer_kind(cfg, i)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    layer = {"norm1": zeros(cfg.d_model)}
    if mixer == "attn":
        layer["attn"] = L.init_attention(gen, cfg, dtype, device)
    else:
        layer["ssm"] = S.init_ssm(gen, cfg, dtype, device)
    if cross:
        layer["norm_x"] = zeros(cfg.d_model)
        layer["cross"] = L.init_attention(gen, cfg, dtype, device)
    if mlpk != "none":
        layer["norm2"] = zeros(cfg.d_model)
        if mlpk == "dense":
            layer["mlp"] = L.init_mlp(gen, cfg, dtype, device)
        else:
            layer["moe"] = L.init_moe(gen, cfg, dtype, device)
    return layer


def init_params(cfg: ModelConfig, generator=0, device=None, place=None) -> dict:
    """Random parameters with the reference's shapes and scales
    (``repro.models.transformer.init_params`` and the layer initialisers).

    ``generator`` is an int seed or a ``torch.Generator`` on ``device``;
    ``device=None`` means CUDA. The values differ from the reference's
    (threefry and torch draw different numbers); use
    :func:`repro_torch.models.convert.params_from_numpy` to carry the
    reference's own weights over. An encdec arch adds ``encoder`` (a list
    of ``encoder_layers`` attention + MLP layers, without cross-attention)
    and ``enc_final_norm``.

    ``place(path, tree)``, when given, takes each piece as soon as it is
    made -- one layer (path ``("blocks", i)`` or ``("encoder", i)``) or
    one top-level entry (``("embed",)``, ``("time_mlp",)``, ...) -- and
    returns what the tree keeps of it (its shards on a mesh): the whole
    model is then never held at once. The draws are the same with or
    without it."""
    _check_arch(cfg)
    place = place or (lambda path, tree: tree)
    device = resolve_device(device)
    gen = generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(generator))
    dtype = _dtype(cfg)
    n = lambda shape: torch.randn(shape, generator=gen, device=device)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    d = cfg.d_model
    n_blocks(cfg)      # raises unless the layers fill whole blocks
    encdec = cfg.arch_type == "encdec"
    blocks = [place(("blocks", i), _init_layer(gen, cfg, i, dtype, device, cross=encdec))
              for i in range(cfg.n_layers)]
    p: dict[str, Any] = {
        "embed": place(("embed",), (n((cfg.vocab_size, d)) * 0.02).to(dtype)),
        "blocks": blocks,
        "final_norm": place(("final_norm",), zeros(d)),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = place(("lm_head",), (n((d, cfg.vocab_size)) * 0.02).to(dtype))
    if cfg.objective == "diffusion":
        te = cfg.time_emb_dim
        p["time_mlp"] = place(("time_mlp",), {
            "w1": (n((te, d)) * 0.02).to(dtype), "b1": zeros(d),
            "w2": (n((d, d)) * 0.02).to(dtype), "b2": zeros(d)})
        p["eps_head"] = place(("eps_head",), (n((d, d)) * 0.02).to(dtype))
    if encdec:
        p["encoder"] = [place(("encoder", j), _init_layer(gen, cfg, 0, dtype, device))
                        for j in range(cfg.encoder_layers)]
        p["enc_final_norm"] = place(("enc_final_norm",), zeros(d))
    return p


def _time_mlp(tm, te):
    """``silu(te @ w1 + b1) @ w2 + b2`` with the silu in float32.

    The products run on at least two rows: BLAS takes a one-row product
    down its matrix-vector path, whose summation order differs from the
    matrix-matrix path, and a request's time embedding (hence its whole
    sample) would then depend on whether it was served alone."""
    n = te.shape[0]
    if n == 1:
        te = te.expand(2, -1)
    te = F.silu((te @ tm["w1"] + tm["b1"]).to(torch.float32)).to(te.dtype)
    return (te @ tm["w2"] + tm["b2"])[:n]


def _cross_kv(cfg: ModelConfig, layer: dict, enc_out) -> dict:
    """A decoder layer's cross-attention ``{"k", "v"}``, each (B, F,
    n_kv_heads, head_dim), projected from the encoder's output (B, F,
    d_model) with its ``cross`` block's ``wk`` and ``wv``. On a mesh (a
    placed layer) the kv heads this rank holds, and ``"k0"``, the first,
    where it is not 0."""
    hd, p = cfg.resolved_head_dim, layer["cross"]
    q_split = L.heads_split(p["wq"], cfg.n_heads)
    k, k0 = L.head_block(enc_out, p["wk"], cfg.n_kv_heads, hd, q_split)
    v, _ = L.head_block(enc_out, p["wv"], cfg.n_kv_heads, hd, q_split)
    return {"k": k, "v": v} if k0 == 0 else {"k": k, "v": v, "k0": k0}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device=None, enc_out=None, params=None) -> dict:
    """A zeroed decode cache ``{"blocks": [per-layer dict]}`` on ``device``
    (None means CUDA), each layer's entry of its mixer's kind (jamba mixes
    the two in one model). Attention layers hold ``k`` and ``v`` of shape
    (batch, L, n_kv_heads, head_dim): L is ``cache_len``, or at most the
    window for a sliding-window arch (a ring); ssm layers hold ``conv``
    (batch, conv_width - 1, d_inner + 2 N) and a float32 ``state`` (batch,
    H, P, N). ``dtype`` (a torch dtype) defaults to the config's. Given
    ``enc_out`` and ``params``, an encdec arch adds ``"cross"``, one ``{"k",
    "v"}`` per decoder layer projected with ``params``' cross blocks;
    without them the cache has no ``"cross"`` (decode then raises until
    prefill's is put in), where the reference fills zeros that decode
    would attend to as if they were the encoder's."""
    _check_arch(cfg)
    if (enc_out is None) != (params is None):
        raise ValueError("init_cache: the cross cache needs both enc_out= and params=")
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    hd = cfg.resolved_head_dim
    blocks = []
    for i in range(cfg.n_layers):
        if _layer_kind(cfg, i)[0] == "ssm":
            d_inner, n_heads = S.ssm_dims(cfg)
            n = cfg.ssm.state_dim
            blocks.append({"conv": zeros(batch, cfg.ssm.conv_width - 1, d_inner + 2 * n),
                           "state": zeros(batch, n_heads, cfg.ssm.head_dim, n,
                                          dt=torch.float32)})
        else:
            n_slots = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
            blocks.append({"k": zeros(batch, n_slots, cfg.n_kv_heads, hd),
                           "v": zeros(batch, n_slots, cfg.n_kv_heads, hd)})
    cache = {"blocks": blocks}
    if cfg.arch_type == "encdec" and enc_out is not None:
        cache["cross"] = [_cross_kv(cfg, layer, enc_out) for layer in params["blocks"]]
    return cache


def _apply_layer(cfg: ModelConfig, i: int, bp: dict, h, positions, aux: dict, *,
                 causal, cache=None, cache_index=None, cross=None,
                 collect_kv=False, valid_len=None, use_kernels=False,
                 sharded=False, cross_out=None, tracer=NULL_TRACER):
    """Layer ``i`` (the reference's ``_apply_block`` for one slot): the
    mixer and its residual; for a decoder layer of an encdec arch, given
    ``cross`` (its ``{"k", "v"}``), ``norm_x`` and cross-attention with its
    residual; then the MLP or MoE (whose aux losses are added into
    ``aux``). Returns ``(h, the layer's cache)``.

    ``sharded``: the layer's parameters are on a mesh; they are placed
    here, just before the layer runs (see ``forward``), and a ``cross``
    that is the encoder's output (a tensor, not a ``{"k", "v"}`` dict) is
    projected here with the placed ``cross`` weights; ``cross_out``, a
    list, then receives the projection (prefill's cross cache).

    Each branch adds ``cfg.residual_multiplier`` times its output
    (:func:`_residual`).

    ``tracer``: spans named by the layer's parts, without its index:
    ``layer.norm`` (each RMS norm), ``layer.ssm`` or ``layer.attn`` (the
    mixer and its residual; the SSM mixer's own parts nest in it, see
    :func:`repro_torch.models.ssm.ssm_forward`), ``layer.cross`` and
    ``layer.mlp`` or ``layer.moe`` (the MoE's parts nest in it, see
    :func:`repro_torch.models.layers.moe`)."""
    mixer, mlpk = _layer_kind(cfg, i)
    if sharded:
        bp = TP.place_tree(bp)
        if cross is not None and not isinstance(cross, dict):
            cross = _cross_kv(cfg, bp, cross)
            if cross_out is not None:
                cross_out.append(cross)
    with tracer.span("layer.norm"):
        hn = L.rms_norm(h, bp["norm1"], cfg.norm_eps)
    if mixer == "ssm":
        with tracer.span("layer.ssm"):
            out, nc = S.ssm_forward(bp["ssm"], cfg, hn, cache=cache,
                                    use_kernels=use_kernels, tracer=tracer)
            h = _residual(cfg, h, out)
    else:
        with tracer.span("layer.attn"):
            out, nc = L.attention(bp["attn"], cfg, hn, positions, causal=causal,
                                  cache=cache, cache_index=cache_index,
                                  return_kv=collect_kv, valid_len=valid_len,
                                  use_kernels=use_kernels)
            h = _residual(cfg, h, out)
    if cross is not None:
        with tracer.span("layer.norm"):
            hx = L.rms_norm(h, bp["norm_x"], cfg.norm_eps)
        with tracer.span("layer.cross"):
            out, _ = L.attention(bp["cross"], cfg, hx, positions, causal=False,
                                 kv_override=(cross["k"], cross["v"], cross.get("k0", 0)))
            h = _residual(cfg, h, out)
    if mlpk != "none":
        with tracer.span("layer.norm"):
            hn = L.rms_norm(h, bp["norm2"], cfg.norm_eps)
        if mlpk == "dense":
            with tracer.span("layer.mlp"):
                h = _residual(cfg, h, L.mlp(bp["mlp"], cfg, hn))
        else:
            with tracer.span("layer.moe"):
                out, moe_aux = L.moe(bp["moe"], cfg, hn, tracer, use_kernels)
                h = _residual(cfg, h, out)
            _add_aux(aux, moe_aux)
    return h, nc


def _residual(cfg: ModelConfig, h, out):
    """``h + residual_multiplier * out``, one rounding (no multiply at 1)."""
    m = cfg.residual_multiplier
    return h + out if m == 1.0 else torch.add(h, out, alpha=m)


def _add_aux(aux: dict, new: dict) -> None:
    for k, v in new.items():
        aux[k] = aux[k] + v if k in aux else v


def _remat_layer(cfg, i, bp, h, positions, cross, causal, valid_len, use_kernels,
                 sharded):
    """Layer ``i`` in train mode as a pure function of its inputs, ``(h, its
    own aux losses)``: what ``forward(remat=True)`` checkpoints (the
    backward pass re-runs it, so it must not add into the caller's aux; on
    a mesh the re-run places the layer's parameters again)."""
    aux: dict = {}
    h, _ = _apply_layer(cfg, i, bp, h, positions, aux, causal=causal, cross=cross,
                        valid_len=valid_len, use_kernels=use_kernels, sharded=sharded)
    return h, aux


def _run_encoder(params, cfg: ModelConfig, frames, sharded=False):
    """The encoder over ``frames`` (B, F, d_model): bidirectional attention
    + MLP layers on the plain route, then ``enc_final_norm``."""
    h = frames.to(_dtype(cfg))
    b, f, _ = h.shape
    positions = torch.arange(f, device=h.device)[None].expand(b, f)
    for layer in params["encoder"]:
        h, _ = _apply_layer(cfg, 0, layer, h, positions, {}, causal=False, sharded=sharded)
    return L.rms_norm(h, TP.place(params["enc_final_norm"]), cfg.norm_eps)


def lm_head(params, cfg: ModelConfig, embed=None):
    """The LM head (d_model, vocab): ``embed``'s transpose for tied
    embeddings (``embed``, when given, is the placed table), else
    ``lm_head``; placed on a mesh (split over 'model' on the vocabulary)."""
    if cfg.tie_embeddings:
        return TP.transpose(TP.place(params["embed"]) if embed is None else embed)
    return TP.place(params["lm_head"])


def forward(params, cfg: ModelConfig, *, tokens=None, embeds=None, prefix=None,
            frames=None, mode: str = "train", cache=None, cache_index=None,
            t_cond=None, causal: Optional[bool] = None, valid_len=None,
            logits: bool = True, use_kernels: bool = False, remat: bool = False,
            tracer=NULL_TRACER) -> dict:
    """Forward over tokens (an embedding lookup) or continuous inputs.
    Returns a dict with ``hidden``, ``cache``, ``aux`` (the MoE layers'
    ``moe_lb`` and ``moe_z`` losses, each summed over the layers; empty
    without MoE), ``eps`` (diffusion objective with ``embeds``) and
    ``logits`` (float32, only when ``logits=True``).

    tokens: (B, S) int; embeds: (B, S, d_model); t_cond: scalar or (B,)
    diffusion time, its embedding added at every position. prefix: (B, P,
    d_model) image-patch embeddings of a vlm arch, put in front of the
    token embeddings (not of ``embeds``, and not in decode), so positions
    and outputs run over P + S. The input stream is the embeddings (or
    ``embeds``) times ``cfg.embedding_multiplier``, then the time
    embedding; the logits are divided by ``cfg.logits_scaling``. frames: (B, F, d_model) encoder inputs,
    required by an encdec arch in train and prefill mode (the encoder runs
    on them; decode reads the cache's cross k and v instead). mode:
    "train" (full sequence, cache None), "prefill" (full sequence; the
    cache of every layer comes back: post-RoPE k and v, a ring of
    ``window`` slots for a sliding-window arch longer than its window, or
    the ssm conv history and state; encdec adds the cross k and v) or
    "decode" (one token at position ``cache_index``, an int that counts a
    vlm prefix, against ``cache``; attention caches are written in place).
    valid_len: optional (B,) per-row true length for bucket-padded batches
    (padded tail keys are masked out); use_kernels: self-attention through
    K2 (which refuses ``valid_len`` and a cache), the Mamba2 scan
    through K3, a MoE on the card through its dispatch kernels. remat: train mode only; each decoder layer runs under
    ``torch.utils.checkpoint`` (its activations are recomputed in the
    backward pass; the reference's ``jax.checkpoint`` of a scan block).
    tracer: each decoder layer's spans (:func:`_apply_layer`; none under
    remat), in whatever span the caller has open.

    On a mesh (DTensor parameters placed by the spec rules: the sharded
    steps) the inputs are this rank's rows of the batch, on the plain
    route. Each layer's parameters are placed just before it runs: their
    compute layout is the storage layout without the batch axes (an fsdp
    weight is gathered over 'data' for its layer only: the reference's
    ZeRO-3 ``block_constraint``); under ``remat`` the placement is re-run
    in the backward. A cache, in and out, is this rank's local tensors in
    the compute layout (``training.steps.cache_to_compute``). The eps
    head's output comes back whole; the logits come back split over
    'model' on the vocabulary when the head is, with ``logits_split`` (the
    head's split) beside them."""
    _check_arch(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    sharded = TP.on_mesh(params["embed"])
    if sharded and use_kernels:
        raise ValueError("a model on a mesh runs on the plain route: use_kernels "
                         "must be False")
    dtype = _dtype(cfg)
    if causal is None:
        causal = cfg.objective != "diffusion"
    h = embeds if embeds is not None else TP.embedding(TP.place(params["embed"]), tokens)
    if cfg.embedding_multiplier != 1.0:
        h = h * cfg.embedding_multiplier
    h = h.to(dtype)
    if embeds is None and cfg.arch_type == "vlm" and mode != "decode" and prefix is not None:
        h = torch.cat([prefix.to(dtype), h], dim=1)
    b, s, _ = h.shape
    if mode == "decode":
        if cache is None or s != 1:
            raise ValueError("decode takes one token per row against a cache")
        positions = torch.full((b, 1), int(cache_index), device=h.device)
    else:
        positions = torch.arange(s, device=h.device)[None].expand(b, s)

    if t_cond is not None:
        te = _time_mlp(TP.place_tree(params["time_mlp"]), L.sinusoidal_embedding(
            t_cond, cfg.time_emb_dim).to(dtype))
        h = h + te[:, None, :]     # (B or 1, 1, d_model) broadcasts over rows

    enc_out = None
    if cfg.arch_type == "encdec":
        if mode == "decode":
            if "cross" not in cache:
                raise ValueError(f"{cfg.name} is an encoder-decoder: decode needs "
                                 "the cache's cross k and v (from prefill or "
                                 "init_cache(enc_out=, params=))")
        elif frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: forward in {mode} "
                             "mode needs frames= (B, F, d_model), the encoder's inputs")
        else:
            enc_out = _run_encoder(params, cfg, frames, sharded)

    collect_kv = mode == "prefill"
    if remat and mode != "train":
        raise ValueError("remat recomputes a layer in the backward pass; it is for "
                         "train mode only")
    new_blocks = [] if (cache is not None or collect_kv) else None
    new_cross = [] if (collect_kv and enc_out is not None) else None
    aux: dict[str, Any] = {}
    for i, bp in enumerate(params["blocks"]):
        c = cache["blocks"][i] if cache is not None else None
        cross = None
        if "cross" in bp:
            if mode == "decode":
                cross = cache["cross"][i]
            elif sharded:      # projected in the layer, from its placed weights
                cross = enc_out
            else:
                cross = _cross_kv(cfg, bp, enc_out)
            if new_cross is not None and not sharded:
                new_cross.append(cross)
        if remat:
            h, layer_aux = checkpoint(_remat_layer, cfg, i, bp, h, positions, cross,
                                      causal, valid_len, use_kernels, sharded,
                                      use_reentrant=False)
            _add_aux(aux, layer_aux)
            nc = None
        else:
            h, nc = _apply_layer(cfg, i, bp, h, positions, aux, causal=causal, cache=c,
                                 cache_index=cache_index, cross=cross,
                                 collect_kv=collect_kv, valid_len=valid_len,
                                 use_kernels=use_kernels, sharded=sharded,
                                 cross_out=new_cross, tracer=tracer)
        if new_blocks is not None:
            new_blocks.append(nc if nc is not None else c)

    h = L.rms_norm(h, TP.place(params["final_norm"]), cfg.norm_eps)
    new_cache = None
    if new_blocks is not None:
        new_cache = dict(cache or {}, blocks=new_blocks)
        if new_cross is not None:
            new_cache["cross"] = new_cross
    out = {"hidden": h, "aux": aux, "cache": new_cache}
    if cfg.objective == "diffusion" and embeds is not None:
        eps_head = TP.place(params["eps_head"])
        out["eps"] = TP.whole(*TP.linear(h, eps_head), eps_head)
    if logits:
        head = lm_head(params, cfg)
        lg, split = TP.linear(h.to(torch.float32), TP.cast(head, torch.float32))
        if cfg.logits_scaling != 1.0:
            lg = lg / cfg.logits_scaling
        if cfg.logit_softcap:
            lg = cfg.logit_softcap * torch.tanh(lg / cfg.logit_softcap)
        out["logits"] = lg
        if split:
            out["logits_split"] = TP.split_of(head)
    return out
