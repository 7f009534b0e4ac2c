"""Each layer's kind, from a configuration's ``model`` dict: a frozen copy of
the port's rule (``models/transformer.py`` ``_layer_kind``), so that the
weights, the FLOP count and the reference lay a model out layer by layer as
the program does, without importing it.

- ``dense``, ``moe``: every layer attention; the feed-forward a MoE where the
  model has experts (``moe_every`` > 1 counts slots of a one-layer block, so
  no layer takes it), else dense.
- ``ssm``: every layer an SSM mixer with no feed-forward.
- ``hybrid``: blocks of ``attn_every`` layers, attention in slot
  ``attn_every // 2`` and SSM mixers elsewhere; with experts and
  ``moe_every`` > 1, a MoE in the slots where ``slot % moe_every == 1``.
"""
from __future__ import annotations

ARCHS = ("dense", "moe", "ssm", "hybrid")


def layer_kinds(m: dict) -> list[tuple[str, str]]:
    """``[(mixer, ffn)]`` for each layer of ``m``: mixer "attn" or "ssm", ffn
    "none", "dense" or "moe"."""
    arch = m["arch_type"]
    if arch not in ARCHS:
        raise ValueError(f"arch_type {arch!r}: the harness lays out {ARCHS} only")
    block = m.get("attn_every", 0) if arch == "hybrid" else 1
    if block < 1 or m["n_layers"] % block:
        raise ValueError(f"{arch}: n_layers {m['n_layers']} is no multiple of the block "
                         f"size {block}")
    moe_every = m.get("moe_every", 0)
    out = []
    for i in range(m["n_layers"]):
        slot = i % block
        if arch == "ssm":
            mixer = "ssm"
        elif arch == "hybrid":
            mixer = "attn" if slot == block // 2 else "ssm"
        else:
            mixer = "attn"
        if arch == "ssm":
            ffn = "none"
        elif m.get("moe") is None:
            ffn = "dense"
        elif moe_every > 1:
            ffn = "moe" if slot % moe_every == 1 else "dense"
        else:
            ffn = "moe"
        out.append((mixer, ffn))
    return out
