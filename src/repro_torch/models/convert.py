"""Carry the JAX package's parameters over to the port.

The reference's parameters are a pytree of arrays; handed over as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) they convert
here without the port importing JAX. Stacked blocks (leading ``n_blocks``
axis) are split into the port's per-layer list; :func:`params_to_numpy`
restacks them (checkpoints are written in the reference's layout).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device


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


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (of the same keys as ``rest``)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's parameter tree of a dense or ssm arch (numpy leaves)
    as the port's params on ``device`` (``None`` means CUDA). Each layer is
    the block's ``slot0`` subtree as it stands: ``attn``/``norm2``/``mlp``
    for dense layers, ``ssm`` (float32 ``A_log``, ``dt_bias``, ``D``; conv
    weights ``(K, C)``) for ssm layers."""
    device = resolve_device(device)
    out = {}
    for name, sub in tree.items():
        if name == "blocks":
            layer = sub["slot0"]   # dense and ssm: one layer per block
            out["blocks"] = [
                _map(lambda a, i=i: tensor_from_numpy(np.asarray(a)[i], device), layer)
                for i in range(cfg.n_layers)]
        else:
            out[name] = _map(lambda a: tensor_from_numpy(a, device), sub)
    return out


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy on the host. bfloat16 (which numpy lacks) comes back
    as its raw 2-byte words in a ``'V2'`` array: the bytes the JAX package's
    ``np.savez`` writes for an ``ml_dtypes.bfloat16`` array."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def params_to_numpy(tree):
    """The inverse of :func:`params_from_numpy`: the port's params (or a
    cache, or a tuple holding them) as the reference's tree of numpy arrays,
    each per-layer list under ``"blocks"`` restacked on a leading axis under
    ``"slot0"``."""
    if isinstance(tree, dict):
        return {k: {"slot0": _map(lambda *ls: np.stack([tensor_to_numpy(t) for t in ls]), *v)}
                if k == "blocks" and isinstance(v, list) else params_to_numpy(v)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tensor_to_numpy(tree)
    return tree if tree is None else np.asarray(tree)
