"""Checkpoints in the JAX package's on-disk format (a counterpart of
``repro.training.checkpoint``): a step directory ``step_<8 digits>``
holding ``arrays.npz`` (``a0``, ``a1``, ...) and ``manifest.json``
(``paths``, ``dtypes``, ``shapes``, ``step``, ``metadata``), written
atomically. Leaves are keyed by the reference's path strings, e.g.
``['blocks']/['slot0']/['attn']/['wq']``, each slot's layers stacked on a
leading block axis (layer ``i`` of the port is slot ``i % bs`` of block
``i // bs``; ``convert.layers_per_block`` reads ``bs`` off the layers; an
encdec arch's ``['encoder']/['slot0']/...`` likewise, one slot a block), so
either package reads a checkpoint the other wrote.

bfloat16 leaves are stored as numpy stores ``ml_dtypes.bfloat16`` arrays:
their raw 2-byte words (``'V2'``), with ``"bfloat16"`` in the manifest's
``dtypes``; :func:`restore` views them as int16 and then as
``torch.bfloat16``. (The JAX package's own ``restore`` cannot cast such a
leaf back and raises, whichever package wrote it.)

A tree on a mesh (DTensor leaves) is saved whole: each leaf is gathered in
turn, rank 0 writes the same files, and every rank waits for the write.
Restoring into such a tree loads the whole arrays on every rank and keeps
each leaf's block as ``like``'s leaf is placed, so a sharded run resumes an
unsharded one and the reverse.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from ..models.convert import LAYER_LISTS, layers_per_block, params_to_numpy, tree_map
from ..sharding import tensor_parallel as TP
from ..sharding.rules import place_like


def _keys(node):
    """A named tuple's path keys (``.field``, as JAX names a named tuple's
    fields), else None."""
    return [f".{f}" for f in node._fields] if isinstance(node, tuple) and \
        hasattr(node, "_fields") else None


def _flatten(tree, prefix=()):
    """(path, leaf) pairs of nested dicts, named tuples, lists and tuples in
    the reference's order: dict keys sorted, named tuples by field,
    sequences by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (f"[{k!r}]",))
    elif _keys(tree) is not None:
        for key, v in zip(_keys(tree), tree):
            yield from _flatten(v, prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (f"[{i}]",))
    elif tree is not None:
        yield "/".join(prefix), tree


def save(ckpt_dir: str, step: int, tree, metadata: dict | None = None) -> str:
    """Atomically write ``tree`` (the port's params, ``(params, opt_state)``,
    or any nesting of dicts, named tuples, lists and tuples of tensors or
    arrays) as step ``step``; returns the step directory. An
    :class:`~repro_torch.training.optimizer.OptState`'s fields go under
    ``.step``, ``.m`` and ``.v``, its moments restacked like the params
    (paths ``[1]/.m/['blocks']/['slot0']/...``)."""
    if _on_mesh(tree):
        import torch.distributed as dist
        host = _gather_to_host(tree, dist.get_rank() == 0)
        step_dir = save(ckpt_dir, step, host, metadata) if dist.get_rank() == 0 else \
            os.path.join(ckpt_dir, f"step_{step:08d}")
        dist.barrier()
        return step_dir
    pairs = list(_flatten(params_to_numpy(tree)))
    paths = [p for p, _ in pairs]
    arrs = [a for _, a in pairs]
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir if os.path.isdir(ckpt_dir) else None)
    os.makedirs(ckpt_dir, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": a for i, a in enumerate(arrs)})
    manifest = {
        "paths": paths,
        "dtypes": ["bfloat16" if a.dtype == np.dtype("V2") else str(a.dtype)
                   for a in arrs],
        "shapes": [list(a.shape) for a in arrs],
        "step": step,
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.isdir(step_dir):
        shutil.rmtree(step_dir)
    os.replace(tmp, step_dir)
    return step_dir


def _on_mesh(tree) -> bool:
    return any(TP.is_sharded(leaf) for _, leaf in _flatten(tree))


def _gather_to_host(tree, keep: bool):
    """Each DTensor leaf gathered whole (every rank takes part, leaf by
    leaf) and, where ``keep``, moved to the host; elsewhere dropped."""
    def leaf(t):
        if not TP.is_sharded(t):
            return t
        whole = t.full_tensor()
        return whole.cpu() if keep else None
    return tree_map(leaf, tree)


def latest_step(ckpt_dir: str) -> int | None:
    """The highest step under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _rebuild_layers(layers, prefix, load):
    """Layer ``i`` of a per-layer list reads slice ``i // bs`` of the
    stacked ``<prefix>/['slot<i % bs>']/...`` entries."""
    bs = layers_per_block(layers)
    return [_rebuild(lay, prefix + (f"['slot{i % bs}']",), load, i // bs)
            for i, lay in enumerate(layers)]


def _rebuild(node, prefix, load, block=None):
    """``node``'s structure with each leaf replaced by ``load(path, leaf,
    block)``; the leaves of a per-layer list under ``"blocks"`` or
    ``"encoder"`` read their block's slice of their slot's stacked
    entries."""
    if isinstance(node, dict):
        return {k: _rebuild_layers(v, prefix + (f"[{k!r}]",), load)
                if k in LAYER_LISTS and isinstance(v, list) and block is None
                else _rebuild(v, prefix + (f"[{k!r}]",), load, block)
                for k, v in node.items()}
    if _keys(node) is not None:
        return type(node)(*(_rebuild(v, prefix + (key,), load, block)
                            for key, v in zip(_keys(node), node)))
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, prefix + (f"[{i}]",), load, block)
                          for i, v in enumerate(node))
    return None if node is None else load("/".join(prefix), node, block)


def restore(ckpt_dir: str, like, step: int | None = None):
    """Restore into the structure of ``like`` (the port's params, or the
    ``(params, opt_state)`` pair a training run saves; tensors): each leaf
    takes ``like``'s dtype and device. Returns ``(tree, metadata)``;
    raises ``KeyError`` for a path the checkpoint lacks (as the reference
    does, e.g. when the serving launcher's params-only template meets the
    ``(params, opt_state)`` pair the train launcher saves)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(step_dir, "arrays.npz"))
    entries = {p: (i, d) for i, (p, d) in
               enumerate(zip(manifest["paths"], manifest["dtypes"]))}

    def load(path, leaf, block):
        if path not in entries:
            raise KeyError(f"checkpoint missing {path}")
        i, dtype = entries[path]
        arr = data[f"a{i}"]
        if block is not None:
            arr = arr[block]
        if dtype == "bfloat16":
            t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        t = t.to(device=leaf.device, dtype=leaf.dtype)
        return place_like(t, leaf) if TP.is_sharded(leaf) else t

    return _rebuild(like, (), load), manifest["metadata"]
