"""AdamW, learning-rate schedules and global-norm clipping over the port's
parameter trees (the counterpart of ``repro.training.optimizer``).

A parameter tree is the port's: nested dicts, with the per-layer lists of
``"blocks"`` and ``"encoder"`` (``convert.LAYER_LISTS``). The arithmetic
follows the reference's in float32: the grads are cast to float32 and
clipped by their global norm, the moments ``m`` and ``v`` are float32, and
each parameter is updated in float32 and cast back to its dtype.

Weight decay goes to the leaves the reference decays: those of two or more
dimensions *in the reference's layout*. The reference stacks each slot of
a block on a leading block axis, so every per-layer leaf under
``"blocks"`` or ``"encoder"`` (the norms, the ssm's ``A_log``, ``D`` and
``dt_bias``) has one more dimension there than here, and is decayed;
top-level vectors (``final_norm``, ``enc_final_norm``, ``time_mlp``'s
biases) are not.

On a mesh the parameters, grads and moments are DTensors placed alike
(``opt_state_specs``: each moment as its parameter; the step counter
replicated). The update is elementwise, so it runs leaf by leaf on the
local shards (``to_local()``) and no DTensor op enters it; the global norm
sums each shard's squares once (a leaf replicated over a mesh axis counts
on that axis's rank 0 only) and all-reduces the sum.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from ..models.convert import LAYER_LISTS, tree_leaves, tree_map
from ..sharding import tensor_parallel as TP


class OptState(NamedTuple):
    step: torch.Tensor   # int32 scalar: the number of updates applied
    m: dict              # float32 first moments, the params' structure
    v: dict              # float32 second moments


def value_and_grad(fn, params, *args, has_aux: bool = False, **kw):
    """``(fn(params, *args, **kw), grads)``, the grads a tree like
    ``params``: the counterpart of ``jax.value_and_grad`` by autograd over
    detached leaves (the caller's tensors gain no ``.grad``). With
    ``has_aux``, ``fn`` returns ``(loss, aux)``. A leaf the loss does not
    reach gets a zero grad, as under ``jax.grad``. The returned values are
    detached. A DTensor leaf's local shard is the autograd leaf
    (``tensor_parallel.tracked``) and its grad comes back as a DTensor
    placed as the leaf."""
    leaves = tree_leaves(params)
    live = [TP.tracked(p) if TP.is_sharded(p) else p.detach().requires_grad_(True)
            for p in leaves]
    it = iter(live)
    tracked = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        out = fn(tracked, *args, **kw)
        grads = torch.autograd.grad(out[0] if has_aux else out, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(live, grads)]
    it = iter(TP.as_shard(g, p) if TP.is_sharded(p) else g for p, g in zip(leaves, grads))
    detach = lambda v: v.detach() if isinstance(v, torch.Tensor) else v
    return tree_map(detach, out), tree_map(lambda _: next(it), params)


def _reference_ndims(tree, extra: int = 0):
    """Each leaf's ndim in the reference's layout: one more than its own
    under a per-layer list of ``LAYER_LISTS`` (stacked on a block axis
    there)."""
    if isinstance(tree, dict):
        return {k: _reference_ndims(v, 1 if (k in LAYER_LISTS and isinstance(v, list))
                                    else extra) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_reference_ndims(v, extra) for v in tree)
    return tree.ndim + extra


def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    """Linear warm-up over ``warmup`` steps, then a cosine decay to
    ``min_frac * base_lr`` at ``total``; float32 as the reference's."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(1, warmup)
        prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_schedule(base_lr: float):
    return lambda step: torch.full((), base_lr, dtype=torch.float32,
                                   device=getattr(step, "device", None))


def _local(t):
    """A DTensor's local shard (itself: in-place updates reach the DTensor),
    or the tensor."""
    return t.to_local() if TP.is_sharded(t) else t


def _counted_here(t) -> bool:
    """Whether this rank counts a DTensor leaf's shard in a sum over the
    mesh: on every axis the leaf is replicated over, its coordinate is 0."""
    ax = TP.axes(t.device_mesh)
    return all(ax.coords[a] == 0 for a, pl in zip(ax.names, t.placements)
               if pl.is_replicate())


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32. Over DTensor
    leaves, each shard counted once on the mesh, then summed over it."""
    leaves = tree_leaves(tree)
    if not leaves or not TP.is_sharded(leaves[0]):
        return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                              for leaf in leaves))
    ax = TP.axes(leaves[0].device_mesh)
    total = sum((torch.sum(torch.square(leaf.to_local().to(torch.float32)))
                 for leaf in leaves if _counted_here(leaf)),
                torch.zeros((), dtype=torch.float32, device=leaves[0].device))
    return torch.sqrt(TP._all_reduce(total, ax.group(ax.names)))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr_fn: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> OptState:
        """Zero moments like ``params``: on a mesh each moment a DTensor with
        its parameter's placements (only the shard is allocated), and the
        step counter replicated over the mesh."""
        first = tree_leaves(params)[0]
        if not TP.is_sharded(first):
            zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            return OptState(torch.zeros((), dtype=torch.int32, device=first.device),
                            tree_map(zeros, params), tree_map(zeros, params))
        from torch.distributed.tensor import DTensor, Replicate

        def zeros(p):
            local = torch.zeros(p.to_local().shape, dtype=torch.float32, device=p.device)
            return DTensor.from_local(local, p.device_mesh, p.placements, run_check=False,
                                      shape=p.shape,
                                      stride=torch.empty(p.shape, device="meta").stride())
        mesh = first.device_mesh
        step = DTensor.from_local(torch.zeros((), dtype=torch.int32, device=first.device),
                                  mesh, [Replicate()] * mesh.ndim, run_check=False)
        return OptState(step, tree_map(zeros, params), tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        """One AdamW step. Returns ``(params, state, {"grad_norm", "lr"})``.

        ``params`` and the moments are updated in place, one leaf at a time
        (the counterpart of the reference's donated buffers: at full width
        a second copy of the moments would not fit beside the first), and
        the returned trees are the ones passed in."""
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        step = _local(state.step) + 1
        lr = self.lr_fn(step)
        b1, b2 = self.b1, self.b2
        stepf = step.to(torch.float32)
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf
        ndims = _reference_ndims(params)

        def upd(p, g, m, v, ndim):
            p, g, m, v = _local(p), _local(g), _local(m), _local(v)
            g = g.to(torch.float32) * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if ndim >= 2:   # decoupled weight decay on the reference's matrices
                u = u + self.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))

        tree_map(upd, params, grads, state.m, state.v, ndims)
        if TP.is_sharded(state.step):
            _local(state.step).copy_(step)
            step = state.step
        return params, OptState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}
