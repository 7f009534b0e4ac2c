"""Expert-parallel MoE over ``torch.distributed.all_to_all_single`` (the
counterpart of ``repro.sharding.expert_parallel``).

The baseline MoE (``models.layers.moe``) keeps every expert on every
device. Expert parallelism shards the EXPERTS over a mesh axis and moves
the TOKENS: each rank routes its own block of the batch, sends each
expert's slots to the rank that holds the expert, runs its own experts on
what it received, and sends the outputs back -- the GShard / Switch
layout, with traffic of about 2 x (capacity x d_model) each way per rank,
whatever d_ff is.

Multi-controller, as the rest of the port: every rank of the axis calls
the function with its own block of the batch. The routing (top-k, the
capacity ``max(1, int(capacity_factor * S * k / E)) * B`` over the
flattened block, each pair's place in its expert's queue) is the
reference's, so with no drops the output is ``layers.moe``'s. Needs
``num_experts % axis size == 0``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding.rules import axis_sizes

_EXPERT_LEAVES = ("w_up", "w_gate", "w_down")


def moe_expert_parallel(params, cfg: ModelConfig, x, mesh, axis: str = "data"):
    """Expert-parallel MoE (collective over ``mesh``'s ``axis``).

    params: an ``init_moe`` dict, ``router`` (D, E) replicated; the expert
      leaves ``w_up``/``w_gate`` (E, D, F) and ``w_down`` (E, F, D) either
      whole (the rank keeps its contiguous block of E / n experts) or
      already this rank's block.
    x: (B, S, D), this rank's block of the batch.
    Returns ``(out, {"moe_lb": lb})``: ``out`` (B, S, D) for this rank's
    tokens, ``lb`` the load-balance loss averaged over the axis (the
    reference's ``pmean``), the same on every rank.
    """
    mcfg = cfg.moe
    if mcfg.shared_ff:
        raise ValueError("expert parallelism routes the routed experts only; a shared "
                         "expert (moe.shared_ff) runs in layers.moe")
    n_shards = axis_sizes(mesh)[axis]
    me = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    e = mcfg.num_experts
    if e % n_shards:
        raise ValueError(f"{e} experts do not divide over {n_shards} ranks")
    e_loc = e // n_shards
    k = mcfg.top_k
    w = {}
    for name in _EXPERT_LEAVES:
        t = params[name]
        w[name] = t[me * e_loc:(me + 1) * e_loc] if t.shape[0] == e else t
        if w[name].shape[0] != e_loc:
            raise ValueError(f"{name} holds {t.shape[0]} experts: neither all "
                             f"{e} nor this rank's {e_loc}")

    b, s, d = x.shape
    n_tok = b * s
    xf = x.reshape(n_tok, d)
    cap = min(max(1, int(mcfg.capacity_factor * s * k / e)) * b, n_tok)

    logits = xf.to(torch.float32) @ params["router"]
    gates = torch.softmax(logits, dim=-1)                           # (N, E)
    gate_vals, gate_idx = torch.topk(gates, k, dim=-1)              # (N, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    choice = F.one_hot(gate_idx, e).to(torch.float32)               # (N, k, E)
    flat = choice.reshape(n_tok * k, e)
    pos = (flat.cumsum(0) - flat).reshape(n_tok, k, e)
    pos = (pos * choice).sum(-1).to(torch.long)                     # (N, k)
    valid = pos < cap

    # this rank's (E * cap, D) dispatch buffer: a slot table, dropped pairs
    # into a dustbin slot cut off after
    vflat = valid.reshape(-1)
    slot = torch.where(vflat, (gate_idx * cap + pos).reshape(-1), e * cap)
    tok_ids = torch.arange(n_tok, device=x.device)[:, None].expand(n_tok, k).reshape(-1)
    table = torch.zeros(e * cap + 1, dtype=torch.long, device=x.device)
    table = table.scatter(0, slot, torch.where(vflat, tok_ids, 0))[:-1]
    occ = torch.zeros(e * cap + 1, dtype=torch.bool, device=x.device)
    occ = occ.scatter(0, slot, vflat)[:-1]
    buf = torch.where(occ[:, None], xf[table], 0)                   # (E*cap, D)

    # tokens -> expert ranks: block q of the buffer (experts q*e_loc ...)
    # goes to rank q; recv[src] is src's slots for this rank's experts
    recv = torch.empty_like(buf)
    dist.all_to_all_single(recv, buf.contiguous(), group=group)
    recv = recv.reshape(n_shards, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, n_shards * cap, d)

    h = torch.bmm(recv, w["w_up"])
    g = torch.bmm(recv, w["w_gate"])
    h = (F.silu(g.to(torch.float32)) * h.to(torch.float32)).to(recv.dtype)
    out_e = torch.bmm(h, w["w_down"])

    out_e = out_e.reshape(e_loc, n_shards, cap, d).transpose(0, 1).reshape(
        n_shards * e_loc * cap, d)
    back = torch.empty_like(out_e)
    dist.all_to_all_single(back, out_e.contiguous(), group=group)   # (E*cap, D)

    gf = torch.where(valid, gate_idx * cap + pos, 0)
    got = back[gf]                                                  # (N, k, D)
    wts = (gate_vals * valid).to(got.dtype)
    out = torch.einsum("nk,nkd->nd", wts, got).reshape(b, s, d)

    mean_gate = gates.mean(0)
    frac = (choice * valid[..., None]).sum(1).mean(0)
    lb = e * (mean_gate * frac).sum() * mcfg.load_balance_loss
    dist.all_reduce(lb, group=group)
    return out, {"moe_lb": lb / n_shards}
