"""Sharding rules: param / cache / batch / plan / state trees -> spec trees
(the counterpart of ``repro.sharding.rules``).

Baseline policy, as in the reference:

  * batch dims  -> all data-like mesh axes ('pod', 'data').
  * tensor parallel over 'model': output-feature dims of up-projections
    (wq/wk/wv/w_up/w_gate/moe experts' d_ff) and input-feature dims of
    down-projections (wo/w_down/out_proj) -- Megatron pairing.
  * FSDP over 'data' on a second axis of large weights (``fsdp=True``),
    with ``ff2d`` moving it onto the feed-forward dim beside 'model'.
  * every rule checks divisibility against the mesh axis size and falls back
    to replication.

The rules read only axis names and sizes, so a mesh is any object with
them: a ``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``
and a tuple ``shape``) or a structural stand-in with an ``axis_names``
tuple and a ``shape`` dict. A spec is a :class:`PartitionSpec`, a tuple of
one entry per tensor dim (an axis name, a tuple of names, or None), which
compares equal to the reference's ``PartitionSpec`` entries.

Layout differences from the reference, which the rules follow:

  * the port's layers are unstacked (``blocks`` and ``encoder`` are lists
    of per-layer dicts, see ``models/convert.py``), so a layer leaf's spec
    is the reference's stacked spec without its leading ``n_blocks`` entry,
    and a cache leaf's batch dim is 0 (the reference's is 1 under
    ``blocks`` / ``cross``);
  * a stacked ``SamplerState.key`` is a tuple of R per-row generators, so
    its spec has one entry (the reference's (R, 2) key stack has two).
"""
from __future__ import annotations

import dataclasses
import math
import re


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names, or
    None (replicated along that dim). ``PartitionSpec()`` replicates. A
    one-name tuple is stored as the bare name, as the reference's does."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (the reference's ``NamedSharding``). The port
    places leaves by hand: :meth:`local` cuts this rank's block out of a
    whole (replicated) tensor; :func:`to_placements` names the DTensor
    placements of the same layout."""
    mesh: object
    spec: PartitionSpec

    def local(self, t):
        """This rank's block of ``t`` under the spec: each sharded dim is
        cut into ``size`` contiguous blocks (``block_range``), and the rank
        keeps the one at its coordinate on those axes."""
        coords = mesh_coords(self.mesh)
        sizes = axis_sizes(self.mesh)
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            axes = axis if isinstance(axis, tuple) else (axis,)
            idx = 0
            for a in axes:          # row-major over the named axes
                idx = idx * sizes[a] + coords[a]
            n = math.prod(sizes[a] for a in axes)
            lo, hi = block_range(t.shape[dim], n, idx)
            t = t.narrow(dim, lo, hi - lo)
        return t


def block_range(rows: int, n: int, i: int) -> tuple[int, int]:
    """Rows ``[lo, hi)`` of block ``i`` when ``rows`` rows are cut into
    ``n`` contiguous blocks: ``[i * rows // n, (i + 1) * rows // n)``. The
    blocks are equal when ``n`` divides ``rows`` and otherwise differ by at
    most one row (a join's intermediate row count may not divide)."""
    return i * rows // n, (i + 1) * rows // n


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh or a structural stand-in."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh) -> tuple:
    return tuple(axis_sizes(mesh))


def mesh_coords(mesh) -> dict:
    """This rank's coordinate on each axis of a DeviceMesh."""
    return {a: mesh.get_local_rank(a) for a in axis_names(mesh)}


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def batch_axes(mesh) -> tuple:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _div(n: int, mesh, axis) -> bool:
    if isinstance(axis, tuple):
        size = math.prod(_axis_size(mesh, a) for a in axis)
    else:
        size = _axis_size(mesh, axis)
    return n % size == 0


def _spec(mesh, shape, assignments: dict) -> P:
    """A spec assigning mesh axes to dims where divisible."""
    parts: list = [None] * len(shape)
    for dim, axis in assignments.items():
        d = dim % len(shape)
        if axis is not None and _div(shape[d], mesh, axis):
            parts[d] = axis
    return P(*parts)


# matched in order; first hit wins. Patterns are regexes over the
# "/"-joined tree path (e.g. "blocks/3/attn/wq").
def _param_rules(fsdp: bool, ff2d: bool = False):
    """``fsdp``: shard a second weight axis over 'data' (ZeRO-style).
    ``ff2d``: for FFN / MoE weights put the 'data' factor on the
    feed-forward dim together with 'model', not on the contraction dim."""
    f = "data" if fsdp else None
    ff_up = {-1: ("data", "model") if (fsdp and ff2d) else "model",
             -2: None if ff2d else f}
    ff_down = {-2: ("data", "model") if (fsdp and ff2d) else "model",
               -1: None if ff2d else f}
    return [
        (r"embed$",            lambda sh, m: _spec(m, sh, {0: "model", 1: f})),
        (r"lm_head$",          lambda sh, m: _spec(m, sh, {1: "model", 0: f})),
        (r"eps_head$",         lambda sh, m: _spec(m, sh, {1: "model"})),
        (r"(wq|wk|wv)$",       lambda sh, m: _spec(m, sh, {-1: "model", -2: f})),
        (r"(w_up|w_gate)$",    lambda sh, m: _spec(m, sh, dict(ff_up))),
        (r"wo$",               lambda sh, m: _spec(m, sh, {-2: "model", -1: f})),
        (r"(w_down|out_proj)$", lambda sh, m: _spec(m, sh, dict(ff_down))),
        (r"in_proj$",          lambda sh, m: _spec(m, sh, {-1: "model", -2: f})),
        (r"router$",           lambda sh, m: P()),
        (r"conv_w$",           lambda sh, m: _spec(m, sh, {-1: "model"})),
        (r"conv_b$",           lambda sh, m: _spec(m, sh, {-1: "model"})),
        (r"norm",              lambda sh, m: P()),
        (r"(A_log|dt_bias|D)$", lambda sh, m: P()),
        (r"time_mlp",          lambda sh, m: P()),
        (r".*",                lambda sh, m: P()),
    ]


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts, lists and tuples (the path a
    tuple of keys and indices); None stays None."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def param_specs(params_shape, mesh, fsdp: bool = False, ff2d: bool = False,
                path: tuple = ()):
    """Spec tree for a params (or AdamW moment) tree; leaves need only a
    ``shape``. ``path``: where ``params_shape`` sits in the params tree,
    for a piece of it (``("blocks", 3)`` for layer 3)."""
    rules = _param_rules(fsdp, ff2d)

    def assign(path, leaf):
        ps = _path_str(path)
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        for pat, fn in rules:
            if re.search(pat, ps):
                return fn(shape, mesh)
        return P()

    return _map_with_path(assign, params_shape, tuple(path))


def opt_state_specs(opt_state_shape, params_spec, mesh):
    """``OptState(step, m, v)``: the moments shard like the params, the
    step replicates."""
    from ..training.optimizer import OptState  # local: keeps the rules light
    return OptState(P(), params_spec, _map_specs(lambda s: s, params_spec))


def batch_specs(batch_shape, mesh):
    """Input batch: leading dim over ('pod', 'data') when divisible."""
    ba = batch_axes(mesh)

    def assign(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        if _div(shape[0], mesh, ba):
            return P(ba, *([None] * (len(shape) - 1)))
        return P(*([None] * len(shape)))

    return _map_with_path(assign, batch_shape)


def cache_specs(cache_shape, mesh, seq_shard: bool = True):
    """Decode cache specs. Attention ``k``/``v`` (B, S, KV, hd): batch over
    the data axes; the kv heads (or else head_dim, or else the sequence)
    over 'model' when divisible. SSM ``state`` (B, H, P, N): heads over
    'model'; ``conv`` (B, K-1, C): channels over 'model'. The port's cache
    layers are unstacked, so the batch dim is 0 everywhere."""
    ba = batch_axes(mesh)

    def assign(path, leaf):
        ps = _path_str(path)
        sh = tuple(leaf.shape)
        if len(sh) == 0:
            return P()
        parts: list = [None] * len(sh)
        bdim = 0
        if _div(sh[bdim], mesh, ba):
            parts[bdim] = ba
        if re.search(r"/(k|v)$", ps) and len(sh) >= bdim + 4:
            seq_d, kv_d, hd_d = bdim + 1, bdim + 2, bdim + 3
            if _div(sh[kv_d], mesh, "model"):
                parts[kv_d] = "model"
            elif _div(sh[hd_d], mesh, "model"):
                parts[hd_d] = "model"
            elif seq_shard and _div(sh[seq_d], mesh, "model"):
                parts[seq_d] = "model"
        elif re.search(r"/state$", ps) and len(sh) >= bdim + 4:
            if _div(sh[bdim + 1], mesh, "model"):
                parts[bdim + 1] = "model"
        elif re.search(r"/conv$", ps) and len(sh) >= bdim + 3:
            if _div(sh[-1], mesh, "model"):
                parts[-1] = "model"
        return P(*parts)

    return _map_with_path(assign, cache_shape)


def _is_spec_leaf(x) -> bool:
    return isinstance(x, PartitionSpec)


def _map_specs(fn, tree):
    if _is_spec_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_specs(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), (dict, list, tuple))})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):      # NamedTuple
        return type(tree)(*(_map_specs(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return tree


def to_shardings(spec_tree, mesh):
    """Each spec of ``spec_tree`` bound to ``mesh`` as a :class:`NamedSharding`."""
    return _map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


def _place_leaf(t, sharding):
    """One leaf on its mesh: a DTensor whose local tensor is a copy of this
    rank's block of ``t`` (the same tensor on every rank) under the
    sharding's spec (``t`` is neither kept nor changed by later in-place
    updates)."""
    import torch
    from torch.distributed.tensor import DTensor
    local = sharding.local(t).clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, sharding.mesh, to_placements(sharding.spec, sharding.mesh),
                              run_check=False, shape=t.shape, stride=t.stride())


def device_put(tree, shardings):
    """Put a tree on its mesh (the reference's ``jax.device_put(tree,
    to_shardings(specs, mesh))``): each tensor leaf, the same on every
    rank, becomes a ``torch.distributed.tensor.DTensor`` with
    ``to_placements(spec)`` holding only this rank's block. ``shardings``
    is a tree of :class:`NamedSharding` like ``tree`` (``to_shardings``)
    or one sharding for every leaf."""
    from ..models.convert import tree_map   # local: keeps the rules light
    if isinstance(shardings, NamedSharding):
        return tree_map(lambda t: _place_leaf(t, shardings), tree)
    return tree_map(_place_leaf, tree, shardings)


def place_like(t, like):
    """The whole tensor ``t`` placed as the DTensor ``like`` is (its mesh and
    placements; this rank keeps its block)."""
    from torch.distributed.tensor import Shard
    mesh = like.device_mesh
    names = axis_names(mesh)
    parts: list = [None] * t.ndim
    for name, pl in zip(names, like.placements):
        if isinstance(pl, Shard):
            prev = parts[pl.dim]
            parts[pl.dim] = name if prev is None else (prev if isinstance(prev, tuple)
                                                      else (prev,)) + (name,)
    return _place_leaf(t, NamedSharding(mesh, P(*parts)))


def to_placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` its axis is assigned to, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(mesh):
        dims = [d for d, axis in enumerate(spec) if axis is not None and
                name in (axis if isinstance(axis, tuple) else (axis,))]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


# -------------------------------------------- request-axis (serving) sharding
def _leading_axis_spec(shape, mesh, dim: int) -> P:
    """P with the data axes on ``dim`` when divisible, else replicated."""
    ba = batch_axes(mesh)
    parts: list = [None] * len(shape)
    if ba and dim < len(shape) and _div(shape[dim], mesh, ba):
        parts[dim] = ba[0] if len(ba) == 1 else ba
    return P(*parts)


def plan_specs(plan, mesh):
    """Spec tree (a ``SolverPlan`` of specs) for a stacked plan: every
    coefficient leaf and ``ts`` carries the request axis leading, sharded
    over the data-like axes when the batch divides and replicated
    otherwise. An unstacked plan replicates entirely."""
    def spec(v):
        return _leading_axis_spec(tuple(v.shape), mesh, 0) if plan.stacked else P()
    return dataclasses.replace(
        plan, coeffs={k: spec(v) for k, v in plan.coeffs.items()}, ts=spec(plan.ts))


def step_index_specs(k, mesh) -> P:
    """Spec of the executor's step index: a per-row ``(R,)`` vector shards
    with the rows it indexes; a group-uniform scalar replicates."""
    shape = tuple(getattr(k, "shape", ()))
    if not shape and isinstance(k, (list, tuple)):
        shape = (len(k),)
    return _leading_axis_spec(shape, mesh, 0) if shape else P()


def state_specs(state, mesh):
    """Spec tree (a ``SamplerState`` of specs) for a stacked state: ``x``
    (R, *inner) on axis 0, ``hist`` (H, R, *inner) on axis 1, the per-row
    generator tuple and ``err`` (R,) on axis 0, the step counter
    replicated. An unstacked state (one generator or None) replicates."""
    from ..core.sampler import SamplerState  # local: avoid core<->sharding cycle
    stacked = isinstance(state.key, tuple)

    def lead(shape, dim):
        return _leading_axis_spec(shape, mesh, dim) if stacked else P()
    return SamplerState(
        x=lead(tuple(state.x.shape), 0),
        hist=lead(tuple(state.hist.shape), 1),
        key=lead((len(state.key),) if stacked else (), 0),
        k=P(),
        err=lead(tuple(state.err.shape), 0))
