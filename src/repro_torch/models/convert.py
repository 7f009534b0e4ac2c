"""Carry the JAX package's parameters over to the port.

The reference's parameters are a pytree of arrays; handed over as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``) they convert
here without the port importing JAX. Stacked blocks (leading ``n_blocks``
axis) are split into the port's per-layer list.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """numpy -> torch, copying. bfloat16 arrays (``ml_dtypes.bfloat16``,
    which ``torch.from_numpy`` rejects) travel through an int16 view."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.int16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


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
