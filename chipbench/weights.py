"""Random weights made on the device from the seed, in the type they are
served in and in the port's parameter layout (each layer's leaves by its
kinds, :func:`chipbench.layers.layer_kinds`), handed to the program and to
the reference alike.

Every matrix in the model's dtype is a view into one flat buffer filled by a few large
``normal_`` calls from one ``torch.Generator`` on the device, then scaled in
place (the port's initialisation scales: 0.02 for the embedding, the heads
and the time MLP; 1/sqrt(d) for projections, divided again by
sqrt(2 n_layers) for the output projections; 0.1 for the convolution). The
float32 leaves (the routers) come from a second flat buffer; norms, biases
and the SSM's A_log, dt_bias and D are constants as in the port.
"""
from __future__ import annotations

import math

import torch

from . import spec
from .layers import layer_kinds

CHUNK = 1 << 30      # elements per normal_ call
ALIGN = 64           # elements between leaves (128-byte aligned bases)


def layer_leaves(m: dict, i: int, kinds: tuple, rnd, const) -> dict:
    """Layer ``i``'s leaves in the port's layout, by its ``kinds`` (mixer,
    ffn): ``norm1``; ``ssm`` or ``attn``; ``norm2`` with ``mlp`` or ``moe``
    unless the ffn is "none". ``rnd(shape, scale, dtype="model")`` and
    ``const(shape, value, dtype="model")`` make each leaf's spec, in the
    order of the generator's draws."""
    mixer, ffn = kinds
    d, L = m["d_model"], m["n_layers"]
    s = 1.0 / math.sqrt(d)
    out_s = s / math.sqrt(2 * L)
    layer = {"norm1": const((d,), 0.0)}
    if mixer == "ssm":
        c = m["ssm"]
        d_in = c["expand"] * d
        heads = d_in // c["head_dim"]
        n = c["state_dim"]
        layer["ssm"] = {
            "in_proj": rnd((d, 2 * d_in + 2 * n + heads), s),
            "conv_w": rnd((c["conv_width"], d_in + 2 * n), 0.1),
            "conv_b": const((d_in + 2 * n,), 0.0),
            "A_log": const((heads,), 0.0, "f32"),
            "dt_bias": const((heads,), math.log(math.e - 1), "f32"),
            "D": const((heads,), 1.0, "f32"),
            "norm_scale": const((d_in,), 0.0),
            "out_proj": rnd((d_in, d), out_s)}
    else:
        hd = m.get("head_dim") or d // m["n_heads"]
        qd, kvd = m["n_heads"] * hd, m["n_kv_heads"] * hd
        layer["attn"] = {"wq": rnd((d, qd), s), "wk": rnd((d, kvd), s),
                         "wv": rnd((d, kvd), s), "wo": rnd((qd, d), out_s)}
    if ffn == "none":
        return layer
    layer["norm2"] = const((d,), 0.0)
    f = m["d_ff"]
    if ffn == "moe":
        e = m["moe"]["num_experts"]
        layer["moe"] = {"router": rnd((d, e), s, "f32"), "w_gate": rnd((e, d, f), s),
                        "w_up": rnd((e, d, f), s), "w_down": rnd((e, f, d), out_s)}
    else:
        layer["mlp"] = {"w_up": rnd((d, f), s), "w_down": rnd((f, d), out_s)}
        if m.get("glu", True):
            layer["mlp"]["w_gate"] = rnd((d, f), s)
    return layer


def _layout(m: dict, arch=None) -> tuple[dict, list]:
    """(tree of leaf specs, list of the specs): a spec is [shape, dtype,
    scale or ("const", value)]; a random leaf's tensor is filled in later.
    Each layer's leaves come from ``arch.layer_leaves`` where the reference
    module ``arch`` defines it, else from :func:`layer_leaves`."""
    arch = arch or spec.arch_module()
    per_layer = getattr(arch, "layer_leaves", layer_leaves)
    d = m["d_model"]
    leaves: list = []

    def rnd(shape, scale, dtype="model"):
        leaf = [tuple(shape), dtype, scale]
        leaves.append(leaf)
        return leaf

    def const(shape, value, dtype="model"):
        leaf = [tuple(shape), dtype, ("const", value)]
        leaves.append(leaf)
        return leaf

    blocks = [per_layer(m, i, kinds, rnd, const) for i, kinds in enumerate(layer_kinds(m))]
    te = m.get("time_emb_dim", 256)
    tree = {"embed": rnd((m["vocab_size"], d), 0.02), "blocks": blocks,
            "final_norm": const((d,), 0.0),
            "time_mlp": {"w1": rnd((te, d), 0.02), "b1": const((d,), 0.0),
                         "w2": rnd((d, d), 0.02), "b2": const((d,), 0.0)},
            "eps_head": rnd((d, d), 0.02)}
    if not m.get("tie_embeddings", False):
        tree["lm_head"] = rnd((d, m["vocab_size"]), 0.02)
    return tree, leaves


def n_params(m: dict, arch=None) -> int:
    return sum(math.prod(leaf[0]) for leaf in _layout(m, arch)[1])


def make(m: dict, seed: int, device, arch=None) -> dict:
    """The weights of config ``m`` (the port's ModelConfig fields) from
    ``seed``, on ``device``, laid out by the reference module ``arch``
    (:func:`chipbench.spec.arch_module`; default ``model``)."""
    tree, leaves = _layout(m, arch)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    dtypes = {"model": getattr(torch, m.get("dtype", "bfloat16")), "f32": torch.float32}
    for key, dt in dtypes.items():
        rand = [lf for lf in leaves if lf[1] == key and not isinstance(lf[2], tuple)]
        sizes = [-(-math.prod(lf[0]) // ALIGN) * ALIGN for lf in rand]
        if not rand:
            continue
        flat = torch.empty(sum(sizes), dtype=dt, device=device)
        for lo in range(0, flat.numel(), CHUNK):
            flat[lo:lo + CHUNK].normal_(generator=gen)
        off = 0
        for lf, size in zip(rand, sizes):
            t = flat[off:off + math.prod(lf[0])].view(lf[0])
            t.mul_(lf[2])
            lf.append(t)
            off += size
    for lf in leaves:
        if isinstance(lf[2], tuple):
            lf.append(torch.full(lf[0], lf[2][1], dtype=dtypes[lf[1]], device=device))

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list) and node and isinstance(node[0], dict):
            return [build(v) for v in node]
        return node[3]
    return build(tree)
