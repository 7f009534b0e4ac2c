"""Train, prefill, decode and DEIS sampling steps (the counterpart of
``repro.training.steps``).

``train_step``: one optimizer step on the configured objective
('diffusion' = the paper's eps matching, :func:`repro_torch.diffusion.lm.
diffusion_loss`; 'ar' = causal LM, :func:`ar_loss`), with autograd through
the plain route (the reference trains with ``use_pallas=False``: no kernel
has a backward). ``prefill_step``: full-sequence forward returning the
logits and the cache. ``decode_step``: ONE new token against the cache.

The reference's ``unroll`` (of its ``lax.scan`` over blocks) has no
counterpart: the port loops over its layers in Python. The prefill and
decode steps run under the caller's ``torch.no_grad()``.

On a mesh (DTensor parameters and a batch placed by
``data.pipeline.device_put_sharded``) the same functions run the sharded
train step: each rank computes on its rows of the batch and its shards of
the parameters (``sharding.tensor_parallel``), the losses are means over
the whole batch, and the grads come back as DTensors placed like the
parameters. A weight stored split over 'data' (fsdp) is gathered for its
layer, dropped after it and gathered again in the backward: the ZeRO-3
profile, which the reference asks for with a ``block_constraint`` of each
layer's model-only specs. ``make_train_step`` accepts that constraint
(and refuses any other); the port needs it nowhere else. The prefill,
decode and DEIS steps run on a mesh too (the dry runs, ``launch.dryrun``):
each rank its rows, the caches laid out by ``rules.cache_specs``.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.sde import SDE, VPSDE
from ..diffusion import lm as DLM
from ..models import transformer as T
from ..sharding import tensor_parallel as TP
from .optimizer import AdamW, value_and_grad


def cross_entropy(logits, targets, cfg: ModelConfig, split=None):
    """Mean token cross-entropy in float32. ``cfg.ce_mode``: "gather"
    (log_softmax, then the targets' entries) or "onehot" (logsumexp minus
    a one-hot contraction over the vocabulary; the same value).

    ``split`` (a ``tensor_parallel.Split``): the logits are this rank's
    block of the vocabulary over 'model'. "gather" then gathers them
    whole; "onehot" keeps them split and sums its two contractions over
    'model' (the max, the exponentials' sum and the picked logit)."""
    logits = logits.to(torch.float32)
    targets = targets.long()
    if split is not None:
        if cfg.ce_mode != "onehot":
            logits = TP.gather_model(logits, -1, split.ax)
        else:
            return _onehot_split(logits, targets, split.ax)
    if cfg.ce_mode == "onehot":
        lse = torch.logsumexp(logits, dim=-1)
        onehot = F.one_hot(targets, logits.shape[-1]).to(torch.float32)
        picked = torch.sum(logits * onehot, dim=-1)
        return torch.mean(lse - picked)
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, targets[..., None]))


def _onehot_split(logits, targets, ax):
    """The "onehot" cross-entropy of logits split over 'model' on the
    vocabulary (this rank's block of V / model entries)."""
    m = TP.all_reduce_max(logits.amax(-1, keepdim=True), ax)
    lse = torch.log(TP.reduce_from_model(torch.exp(logits - m).sum(-1), ax)) + m[..., 0]
    v = logits.shape[-1]
    local = targets - ax.model_rank * v
    hit = (local >= 0) & (local < v)
    onehot = F.one_hot(torch.where(hit, local, 0), v).to(torch.float32) * hit[..., None]
    picked = TP.reduce_from_model(torch.sum(logits * onehot, dim=-1), ax)
    return torch.mean(lse - picked)


def ar_loss(params, cfg: ModelConfig, tokens, *, prefix=None, frames=None,
            remat: bool = False):
    """Next-token cross-entropy (a vlm's prefix positions dropped from the
    logits) plus the MoE aux losses. Returns ``(loss, {"loss", "ppl"})``,
    ``"loss"`` being the cross-entropy alone. On a mesh, the mean over the
    whole batch."""
    out = T.forward(params, cfg, tokens=tokens, mode="train", causal=True,
                    prefix=prefix, frames=frames, remat=remat)
    logits = out["logits"]
    if cfg.arch_type == "vlm" and prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    loss = TP.batch_mean(cross_entropy(logits[:, :-1], tokens[:, 1:], cfg,
                                       split=out.get("logits_split")),
                         TP.axes_of(params["embed"]))
    aux = sum(out["aux"].values()) if out["aux"] else 0.0
    return loss + aux, {"loss": loss, "ppl": torch.exp(loss)}


def _local_batch(cfg: ModelConfig, batch: dict):
    """``(this rank's rows of each entry, rows)``: a batch on a mesh (DTensors)
    becomes its local rows, ``rows`` being ``(lo, hi, B)`` (None for a plain
    batch). ``cfg.act_shard_axes`` must name mesh axes the rows are split
    over (the MoE batch pin)."""
    if not TP.is_sharded(batch["tokens"]):
        return batch, None
    out, rows = {}, None
    for k, v in batch.items():
        out[k], r = TP.local_rows(v)
        if rows is not None and r != rows:
            raise ValueError(f"batch entry {k} holds rows {r}, tokens {rows}")
        rows = r
    pinned = tuple(cfg.act_shard_axes or ())
    split = TP.rows_split_over(batch["tokens"])
    if not set(pinned) <= set(split):
        raise ValueError(f"act_shard_axes {pinned} pins the MoE batch to mesh axes the "
                         f"batch of {rows[2]} rows is not split over (it is over {split})")
    return out, rows


def make_loss_fn(cfg: ModelConfig, sde: Optional[SDE] = None, remat=False):
    """``loss_fn(params, batch, gen=None, *, t=None, eps=None) -> (loss,
    metrics)`` on ``cfg.objective``; ``batch`` holds ``tokens`` and, where
    the arch takes them, ``prefix`` or ``frames``. ``gen`` draws the
    diffusion loss's ``t`` and ``eps`` unless they are given (an ar loss
    draws nothing and refuses them); given, they are the whole batch's.

    remat: False | "block" or True (each layer under
    ``torch.utils.checkpoint``) | "loss" (the whole loss under one
    checkpoint; ``t`` and ``eps`` are drawn before it, so the backward's
    recomputation sees the same draws). All three give the same loss and
    grads."""
    sde = sde or VPSDE()
    block_remat = remat == "block" or remat is True

    def local_loss(params, batch, gen, t, eps, rows):
        kw = {k: batch[k] for k in ("prefix", "frames") if k in batch}
        if cfg.objective != "diffusion":
            return ar_loss(params, cfg, batch["tokens"], remat=block_remat, **kw)
        return DLM.diffusion_loss(params, cfg, sde, batch["tokens"], gen,
                                  remat=block_remat, t=t, eps=eps, rows=rows, **kw)

    def loss_fn(params, batch, gen=None, *, t=None, eps=None):
        batch, rows = _local_batch(cfg, batch)
        if cfg.objective != "diffusion" and (t is not None or eps is not None):
            raise ValueError("the ar objective draws no t or eps")
        if remat != "loss":
            return local_loss(params, batch, gen, t, eps, rows)
        if cfg.objective == "diffusion":
            t, eps = DLM.draw_t_eps(sde, batch["tokens"], cfg.d_model, gen,
                                    params["embed"].device, t, eps, rows)
        return checkpoint(lambda p, bt: local_loss(p, bt, None, t, eps, None), params,
                          batch, use_reentrant=False)
    return loss_fn


def make_train_step(cfg: ModelConfig, opt: AdamW, sde: Optional[SDE] = None,
                    remat=False, block_constraint=None):
    """``train_step(params, opt_state, batch, gen=None, *, t=None, eps=None)
    -> (params, opt_state, metrics)``: the loss's grads by autograd, then
    ``opt.update`` (in place: the returned trees are the ones passed in).
    metrics: the loss's (``loss``, ``ppl`` or ``mse`` / ``ce``), plus
    ``grad_norm`` and ``lr``, as 0-d tensors on the parameters' device
    (the whole batch's, the same on every rank of a mesh).

    ``block_constraint``: the reference's, checked against the parameters
    at each step (``tensor_parallel.check_block_constraint``): only its
    ZeRO-3 one, each layer's model-only specs, is taken, and that is how
    the port computes every layer on a mesh anyway. The ZeRO-3 saved-tensor
    hooks (``regather_saved``) are on only when some placement gathers."""
    loss_fn = make_loss_fn(cfg, sde, remat=remat)

    def train_step(params, opt_state, batch, gen=None, *, t=None, eps=None):
        if block_constraint is not None:
            TP.check_block_constraint(params["blocks"], block_constraint)
        saves = TP.regather_saved() if TP.gathers(params) else contextlib.nullcontext()
        with saves:
            (_, metrics), grads = value_and_grad(loss_fn, params, batch, gen, t=t,
                                                 eps=eps, has_aux=True)
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, **opt_metrics)

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> (last-position logits (B, vocab),
    cache)`` over ``batch["tokens"]`` (B, S), causal, with
    ``batch["prefix"]`` (vlm) and ``batch["frames"]`` (encdec) passed on
    where present.

    On a mesh (DTensor parameters and batch) each rank runs its rows; the
    logits come back as a DTensor (rows over the batch axes, the vocabulary
    over 'model' where the head splits it) and the cache as DTensors laid
    out by ``rules.cache_specs`` (:func:`cache_to_storage`)."""
    def prefill_step(params, batch):
        batch, rows = _local_batch(cfg, batch)
        kw = {k: batch[k] for k in ("prefix", "frames") if k in batch}
        out = T.forward(params, cfg, tokens=batch["tokens"], mode="prefill",
                        causal=True, **kw)
        if rows is None:
            return out["logits"][:, -1], out["cache"]
        mesh = params["embed"].device_mesh
        return (_logits_out(out, mesh, rows[2]),
                cache_to_storage(out["cache"], cfg, mesh, rows[2]))
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, cache, token (B, 1), cache_index: int) ->
    (logits (B, vocab), cache)``; attention caches are written in place.
    ``cache_index`` counts a vlm prefix; an encdec cache carries the cross
    k and v from prefill.

    On a mesh the cache is DTensors laid out by ``rules.cache_specs`` and
    ``token`` a DTensor (rows over the batch axes, or whole): each cache
    leaf is brought to the layout the layer computes in
    (:func:`cache_to_compute`: a gather over 'model' where the spec splits
    a dim the layer holds whole), and the new cache comes back in the
    spec's layout."""
    def decode_step(params, cache, token, cache_index):
        if not TP.is_sharded(token):
            out = T.forward(params, cfg, tokens=token, mode="decode", causal=True,
                            cache=cache, cache_index=cache_index)
            return out["logits"][:, -1], out["cache"]
        local, (_, _, rows) = TP.local_rows(token)
        mesh = params["embed"].device_mesh
        out = T.forward(params, cfg, tokens=local, mode="decode", causal=True,
                        cache=cache_to_compute(cache, cfg), cache_index=cache_index)
        return (_logits_out(out, mesh, rows),
                cache_to_storage(out["cache"], cfg, mesh, rows, like=cache))
    return decode_step


def make_deis_sample_step(cfg: ModelConfig, sde: Optional[SDE] = None):
    """One DEIS NFE (paper Eq. 14): ``deis_step(params, x, eps_hist, t,
    psi_k, coeff_row) -> (x_next, hist)``, the eps-net at ``(x, t)``, then
    ``hist = cat([eps[None], eps_hist[:-1]])`` and ``x_next = psi_k x +
    tensordot(coeff_row, hist)``: the reference's update, in plain tensor
    operations (:func:`_deis_update`). ``x`` (B, S, D), ``eps_hist``
    (order + 1, B, S, D), ``t``, ``psi_k`` 0-d and ``coeff_row`` (order +
    1,) tensors; runs without autograd.

    On a mesh ``x`` and ``eps_hist`` are DTensors in the dry run's
    ``deis_shard`` layout: the batch over the data axes and, over 'model',
    the last dim ("dmodel") or the sequence ("seq"). ``x`` is gathered over
    'model' into the eps-net's own layout (rows over data, whole over
    'model'); each rank keeps only its block of ``eps``, so the update and
    the history stay local and come back in ``x``'s layout. The port has
    no sequence-parallel attention: "seq" changes only that boundary, the
    eps-net runs the same either way. ``sde`` is the reference's argument
    (its schedule is in ``psi_k`` and ``coeff_row``)."""
    del sde

    @torch.no_grad()
    def deis_step(params, x, eps_hist, t, psi_k, coeff_row):
        if not TP.is_sharded(x):
            eps = DLM.make_eps_fn(params, cfg)(x, t)
            hist = torch.cat([eps[None], eps_hist[:-1]], dim=0)
            return _deis_update(x, hist, psi_k, coeff_row), hist
        ax = TP.axes(x.device_mesh)
        layout = TP._layout_of_placements(x.placements, x.ndim, ax)
        split = [d for d, axes in enumerate(layout) if "model" in axes]
        xl, hl = x.to_local(), eps_hist.to_local()
        whole = xl
        for d in split:
            whole = TP._all_gather(whole, d, ax.groups["model"], ax.model)
        eps = DLM.make_eps_fn(params, cfg)(whole, t)
        for d in split:
            eps = TP._block(eps, d, ax.model, ax.model_rank)
        hist = torch.cat([eps[None], hl[:-1]], dim=0)
        return (TP.as_shard(_deis_update(xl, hist, psi_k, coeff_row), x),
                TP.as_shard(hist, eps_hist))

    return deis_step


def _deis_update(x, hist, psi_k, coeff_row):
    """``psi_k x + tensordot(coeff_row, hist)`` in the promoted dtype of
    ``x`` and the coefficients, as the reference's arrays promote (a float32
    coefficient makes a bfloat16 state's update float32)."""
    dt = torch.promote_types(x.dtype, torch.promote_types(psi_k.dtype, coeff_row.dtype))
    return psi_k.to(dt) * x.to(dt) + torch.tensordot(coeff_row.to(dt), hist.to(dt), dims=1)


# ------------------------------------------------------- caches on a mesh
def _compute_layout(path: tuple, shape: tuple, lead: tuple, cfg: ModelConfig, ax) -> tuple:
    """The layout a layer computes a cache leaf in (per dim, the mesh axes
    splitting it): rows over ``lead``; attention ``k`` / ``v`` (B, S, KV,
    hd) split over 'model' on the kv heads where their count divides it,
    else whole; the SSM ``conv`` (B, K-1, C) on its channels where C
    divides it (as ``conv_w`` is); the SSM ``state`` whole (the scan runs
    whole on every model rank)."""
    out = [lead] + [()] * (len(shape) - 1)
    if path[-1] in ("k", "v") and cfg.n_kv_heads % ax.model == 0:
        out[2] = ("model",)
    elif path[-1] == "conv" and shape[-1] % ax.model == 0:
        out[-1] = ("model",)
    return tuple(out)


def _map_cache(fn, cache, path=()):
    """``fn(path, leaf)`` over a cache's tensors (a cross entry's ``k0``
    dropped)."""
    if isinstance(cache, dict):
        return {k: _map_cache(fn, v, path + (k,)) for k, v in cache.items() if k != "k0"}
    if isinstance(cache, (list, tuple)):
        return type(cache)(_map_cache(fn, v, path + (i,)) for i, v in enumerate(cache))
    return fn(path, cache)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _dtensor(local, mesh, layout: tuple, shape: tuple):
    """``local``, this rank's block in ``layout`` of a ``shape`` tensor, as
    a DTensor."""
    from torch.distributed.tensor import DTensor
    from ..sharding import rules as R
    spec = R.P(*(None if not a else a if len(a) > 1 else a[0] for a in layout))
    return DTensor.from_local(local, mesh, R.to_placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def cache_to_compute(cache, cfg: ModelConfig):
    """A cache of DTensors (laid out by ``rules.cache_specs``) as the local
    tensors the layers compute with (:func:`_compute_layout`): a leaf whose
    spec splits a dim over 'model' that the layer holds whole is gathered
    over 'model'. A cross-attention entry whose kv heads are split gets
    ``k0``, its first kv head."""
    def to_compute(path, t):
        ax = TP.axes(t.device_mesh)
        src = TP._layout_of_placements(t.placements, t.ndim, ax)
        dst = _compute_layout(path, tuple(t.shape), src[0], cfg, ax)
        return TP._relayout(t.to_local(), ax, src, dst, tuple(t.shape))

    out = _map_cache(to_compute, cache)
    for entry in out.get("cross", []):
        n = entry["k"].shape[2]
        if n < cfg.n_kv_heads:
            entry["k0"] = TP.axes(cache["cross"][0]["k"].device_mesh).model_rank * n
    return out


def cache_to_storage(cache, cfg: ModelConfig, mesh, rows: int, like=None):
    """A cache of local tensors in the compute layout, over a ``rows``-row
    batch, as DTensors laid out as ``like``'s leaves are, or by
    ``rules.cache_specs``: each leaf keeps its block (a cut, never a
    collective: the spec splits at least the dims the layer does)."""
    from ..sharding import rules as R
    ax = TP.axes(mesh)
    lead = ax.batch if rows % ax.n_batch == 0 else ()

    def whole(path, t):       # a meta tensor of the leaf's whole shape
        dst = _compute_layout(path, tuple(t.shape), lead, cfg, ax)
        return torch.empty((rows,) + tuple(n * ax.size(a) for n, a in
                                           zip(t.shape[1:], dst[1:])), device="meta")

    shapes = _map_cache(whole, cache)
    if like is None:
        specs = R.cache_specs(shapes, mesh)
        layout = lambda path, n: tuple(
            () if e is None else e if isinstance(e, tuple) else (e,) for e in _at(specs, path))
    else:
        layout = lambda path, n: TP._layout_of_placements(
            _at(like, path).placements, n, ax)

    def to_storage(path, t):
        shape = tuple(_at(shapes, path).shape)
        src = _compute_layout(path, tuple(t.shape), lead, cfg, ax)
        dst = layout(path, len(shape))
        return _dtensor(TP._relayout(t, ax, src, dst, shape), mesh, dst, shape)

    return _map_cache(to_storage, cache)


def _logits_out(out, mesh, rows: int):
    """The last position's logits of a forward on a mesh as a DTensor:
    rows over the batch axes (where the batch was split), the vocabulary
    over 'model' where the head splits it."""
    ax = TP.axes(mesh)
    lg = out["logits"][:, -1]
    split = "logits_split" in out
    layout = (ax.batch if rows % ax.n_batch == 0 else (), ("model",) if split else ())
    return _dtensor(lg, mesh, layout, (rows, lg.shape[-1] * (ax.model if split else 1)))
