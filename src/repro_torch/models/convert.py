"""Carry the JAX package's parameters over to the port.

The reference's parameters are a pytree of arrays; handed over as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) they convert
here without the port importing JAX. The reference's ``blocks`` hold one
subtree per slot (``slot0`` .. ``slot{bs-1}``, ``bs`` layers a block: 1,
or ``attn_every`` for hybrid), each stacked on a leading ``n_blocks``
axis; they are split into the port's per-layer list, layer ``i`` being
slot ``i % bs`` of block ``i // bs``. An encdec arch's ``encoder`` is
stacked the same way over its ``encoder_layers`` layers, one slot a block,
and splits into a per-layer list too. :func:`params_to_numpy` restacks
them (checkpoints are written in the reference's layout).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .transformer import block_size

# the per-layer lists of the port's params (and caches), each the stack of
# a reference subtree of ``slot<j>`` entries
LAYER_LISTS = ("blocks", "encoder")


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """numpy -> torch, copying. bfloat16 arrays (``ml_dtypes.bfloat16``,
    which ``torch.from_numpy`` rejects, or their raw 2-byte words as a
    ``'V2'`` array, which is how ``np.load`` returns them) travel through an
    int16 view."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        t = torch.from_numpy(np.array(a.view(np.int16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, named tuples, lists and
    tuples (``rest`` of the same structure); None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return None if tree is None else fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, lists and tuples, dict keys in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's parameter tree (numpy leaves) as the port's params on
    ``device`` (``None`` means CUDA). Layer ``i`` is slice ``i // bs`` of
    the block's ``slot{i % bs}`` subtree as it stands: ``attn`` or ``ssm``
    (float32 ``A_log``, ``dt_bias``, ``D``; conv weights ``(K, C)``), then
    ``norm2`` with ``mlp`` or ``moe`` (float32 ``router``; experts (E, d,
    f) and (E, f, d)) unless the layer is a pure ssm one; an encdec
    decoder layer's ``norm_x`` and ``cross`` too. The ``encoder`` (encdec)
    splits into its ``encoder_layers`` layers, one slot a block."""
    device = resolve_device(device)
    layout = {"blocks": (cfg.n_layers, block_size(cfg)),
              "encoder": (cfg.encoder_layers, 1)}
    out = {}
    for name, sub in tree.items():
        if name in LAYER_LISTS:
            n, bs = layout[name]
            if set(sub) != {f"slot{j}" for j in range(bs)}:
                raise ValueError(f"{name} hold {sorted(sub)}, {cfg.name} has "
                                 f"{bs} slots a block")
            out[name] = [
                tree_map(lambda a, i=i: tensor_from_numpy(np.asarray(a)[i // bs], device),
                         sub[f"slot{i % bs}"])
                for i in range(n)]
        else:
            out[name] = tree_map(lambda a: tensor_from_numpy(a, device), sub)
    return out


def layers_per_block(layers: list) -> int:
    """The block size of a per-layer list (params or a cache): the shortest
    period of its layers' structure (leaf names and shapes). A block of the
    reference's holds one period of the layer pattern (dense, moe, ssm: 1;
    hybrid: ``attn_every``, one attention layer a block), so this is the
    reference's :func:`~repro_torch.models.transformer.block_size`."""
    def shape(node):
        if isinstance(node, dict):
            return tuple((k, shape(v)) for k, v in sorted(node.items()))
        return tuple(node.shape)
    sig = [shape(layer) for layer in layers]
    n = len(sig)
    return next(p for p in range(1, n + 1) if n % p == 0 and sig[p:] == sig[:n - p])


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy on the host. bfloat16 (which numpy lacks) comes back
    as its raw 2-byte words in a ``'V2'`` array: the bytes the JAX package's
    ``np.savez`` writes for an ``ml_dtypes.bfloat16`` array."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _restack(layers: list) -> dict:
    """A per-layer list as the reference's ``{"slot<j>": stacked subtree}``
    (:func:`layers_per_block` slots, each leaf stacked over the blocks)."""
    bs = layers_per_block(layers)
    return {f"slot{j}": tree_map(lambda *ls: np.stack([tensor_to_numpy(t) for t in ls]),
                                 *layers[j::bs])
            for j in range(bs)}


def params_to_numpy(tree):
    """The inverse of :func:`params_from_numpy`: the port's params (or a
    cache, or a tuple or named tuple holding them, such as ``(params,
    opt_state)``) as the reference's tree of numpy arrays, each per-layer
    list under ``"blocks"`` or ``"encoder"`` restacked into its slots."""
    if isinstance(tree, dict):
        return {k: _restack(v) if k in LAYER_LISTS and isinstance(v, list)
                else params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(params_to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tensor_to_numpy(tree)
    return tree if tree is None else np.asarray(tree)


def opt_state_from_numpy(state, cfg: ModelConfig, device=None):
    """The reference's optimizer state (``OptState(step, m, v)`` with numpy
    leaves, e.g. ``jax.tree.map(np.asarray, opt_state)``) as the port's
    :class:`~repro_torch.training.optimizer.OptState` on ``device``: ``m``
    and ``v`` split into per-layer lists as :func:`params_from_numpy` splits
    the params."""
    from ..training.optimizer import OptState   # the optimizer imports this module
    step, m, v = state
    return OptState(tensor_from_numpy(np.asarray(step, np.int32), resolve_device(device)),
                    params_from_numpy(m, cfg, device), params_from_numpy(v, cfg, device))


def opt_state_to_numpy(state):
    """The inverse of :func:`opt_state_from_numpy`: ``(step, m, v)`` with
    ``m`` and ``v`` restacked in the reference's layout."""
    step, m, v = state
    return tensor_to_numpy(step), params_to_numpy(m), params_to_numpy(v)
