"""Tensor and data parallelism of the train step on a ('data', 'model')
mesh: what GSPMD does for the reference's ``jax.jit(train_step,
in_shardings=...)``, written out as explicit collectives.

Storage. Every parameter, grad and AdamW moment is a DTensor placed by the
spec rules (``rules.device_put``): each rank stores only its shard.

Compute. The forward runs no DTensor op. :func:`place` turns a parameter
into this rank's local tensor in its *compute layout*: the storage layout
without the batch axes (an fsdp shard is all-gathered over 'data' for the
layer that uses it). The result carries ``.tp``, a :class:`Split`: the mesh and the tensor dim the
'model' axis splits (None: whole on every model rank). The layers then run
Megatron's pairing over the 'model' group:

  * :func:`linear` -- a weight split on its output dim takes the whole input
    (``copy_to_model``: identity forward, all-reduce of the grad) and gives
    the output's block; a weight split on its contraction dim takes the
    input's block and all-reduces the product (``reduce_from_model``);
  * :func:`gather_model` / :func:`split_model` -- an activation split over
    'model' made whole (the grad's block back), or a whole one cut to its
    block (the grad all-gathered);
  * :func:`embedding` -- a lookup in a vocab-split table: each rank looks up
    the ids in its rows, zero elsewhere, and the results are all-reduced.

Activations are this rank's rows of the batch (its block over the batch
axes, whole over 'model'). Every mean over the batch goes through
:func:`batch_mean` (the all-reduce mean over the batch axes; its backward
divides the grad by their size), so each rank holds the global loss and
the grads on the ranks of a batch group sum to the global loss's grad.
:func:`place`'s backward makes that sum: it all-reduces a parameter's grad
over the batch axes, or reduce-scatters it where the shard was gathered.

ZeRO-3. A layout change that gathers (fsdp) makes a tensor whose autograd
saves are replaced by a handle (:func:`regather_saved`): the backward
gathers it again, so a layer's gathered weights are freed after it. That
is the reference's ZeRO-3 ``block_constraint`` (each layer's weights
constrained to their model-only specs), which the port thus needs no
lever for: :func:`check_block_constraint` accepts that constraint and
refuses any other.

At one rank (mesh (1, 1)) every collective is a copy over a group of one,
and the local shapes are the unsharded ones: the same products in the
same order as the unsharded step.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch.autograd import Function

from .rules import axis_names, batch_axes, block_range


# ----------------------------------------------------------------- the mesh
class MeshAxes:
    """A mesh's axes as the tensor-parallel code reads them: sizes, this
    rank's coordinate on each, each axis's process group and the batch
    axes ('pod', 'data'). One per mesh (:func:`axes`)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = axis_names(mesh)
        self.sizes = dict(zip(self.names, mesh.shape))
        self.coords = {a: mesh.get_local_rank(a) for a in self.names}
        self.groups = {a: mesh.get_group(a) for a in self.names}
        self.batch = batch_axes(mesh)
        self.n_batch = math.prod(self.sizes[a] for a in self.batch)
        self.model = self.sizes.get("model", 1)
        self.model_rank = self.coords.get("model", 0)

    def size(self, names) -> int:
        return math.prod(self.sizes[a] for a in names)

    def index(self, names) -> int:
        """This rank's block index over ``names``, row-major (a spec's
        ``("data", "model")`` entry)."""
        idx = 0
        for a in names:
            idx = idx * self.sizes[a] + self.coords[a]
        return idx

    def group(self, names):
        """The process group over ``names``: one axis's own, or every axis of
        a mesh that lays the world out in rank order."""
        names = tuple(names)
        if len(names) == 1:
            return self.groups[names[0]]
        if names == self.names and mesh_ranks(self.mesh) == list(range(dist.get_world_size())):
            return dist.group.WORLD
        raise NotImplementedError(f"no process group over the mesh axes {names}")


def mesh_ranks(mesh) -> list:
    """The ranks of ``mesh`` in mesh order (read outside any
    ``FakeTensorMode``: the mesh's rank tensor is a real one)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return mesh.mesh.flatten().tolist()


def axes(mesh) -> MeshAxes:
    """The :class:`MeshAxes` of ``mesh``, made once per mesh object and
    default process group (DTensor's dispatch may hand back an equal mesh
    object of an earlier world, whose groups are gone)."""
    world = dist.distributed_c10d._get_default_group()
    got = mesh.__dict__.get("_tp_axes")
    if got is None or got[0] is not world:
        got = mesh.__dict__["_tp_axes"] = (world, MeshAxes(mesh))
    return got[1]


_DTENSOR: list = []


def is_sharded(t) -> bool:
    """Whether ``t`` is a DTensor (a leaf of a tree on a mesh)."""
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(t, _DTENSOR[0])


def shard_of(t):
    """The DTensor a parameter stands for: itself, or the DTensor whose local
    shard ``t`` is, tracked for autograd (:func:`tracked`); else None."""
    return t if is_sharded(t) else getattr(t, "_shard_of", None)


def on_mesh(t) -> bool:
    """Whether ``t`` is a parameter on a mesh (a DTensor or a tracked shard)."""
    return shard_of(t) is not None


def tracked(p):
    """A DTensor parameter's local shard as an autograd leaf (detached,
    requiring grad) that :func:`place` knows by its DTensor: the sharded
    step's autograd graph then holds no DTensor op."""
    t = p.to_local().detach().requires_grad_(True)
    t._shard_of = p
    return t


def as_shard(g, p):
    """A local grad ``g`` of the DTensor parameter ``p``'s shard as a DTensor
    placed as ``p``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(g, p.device_mesh, p.placements, run_check=False,
                              shape=p.shape, stride=p.stride())


def axes_of(t) -> Optional[MeshAxes]:
    """The mesh axes of a parameter on a mesh or of a placed tensor
    (``.tp``), else None (an unsharded tensor)."""
    src = shard_of(t)
    if src is not None:
        return axes(src.device_mesh)
    split = getattr(t, "tp", None)
    return None if split is None else split.ax


@dataclasses.dataclass(frozen=True)
class Split:
    """A placed tensor's layout: the mesh axes and the tensor dim the
    'model' axis splits in contiguous blocks (None: whole on every model
    rank)."""
    ax: MeshAxes
    dim: Optional[int]


def split_of(t) -> Optional[Split]:
    return getattr(t, "tp", None)


# ------------------------------------------------------- plain collectives
def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def _all_gather(x, dim: int, group, n: int):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _block(x, dim: int, n: int, i: int):
    lo, hi = block_range(x.shape[dim], n, i)
    return x.narrow(dim, lo, hi - lo).contiguous()


def _reduce_scatter(x, dim: int, group, n: int, i: int):
    """The sum over ``group`` of ``x``, this rank's block ``i`` of ``n``
    along ``dim`` (NCCL's reduce-scatter; an all-reduce and a cut on gloo,
    which has none). A ``fake`` group (the dry runs) does what the real
    backend of ``x``'s device would."""
    backend = dist.get_backend(group)
    if not (backend == "nccl" or (backend == "fake" and x.is_cuda)):
        return _block(_all_reduce(x, group), dim, n, i)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // n,) + tuple(xm.shape[1:]))
    dist.reduce_scatter_tensor(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


# --------------------------------------------- collectives with a backward
class _CopyToModel(Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax.groups["model"]), None


class _ReduceFromModel(Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax.groups["model"])

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherModel(Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _all_gather(x, dim, ax.groups["model"], ax.model)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.ax.model, ctx.ax.model_rank), None, None


class _GatherModelSummed(Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _all_gather(x, dim, ax.groups["model"], ax.model)

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        return _reduce_scatter(g, ctx.dim, ax.groups["model"], ax.model,
                               ax.model_rank), None, None


class _SplitModel(Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _block(x, dim, ax.model, ax.model_rank)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.ax.groups["model"], ctx.ax.model), None, None


class _BatchMean(Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        for a in ax.batch:
            x = _all_reduce(x, ax.groups[a])
        return x / ax.n_batch

    @staticmethod
    def backward(ctx, g):
        return g / ctx.ax.n_batch, None


def copy_to_model(x, ax: MeshAxes):
    """Identity; the backward all-reduces the grad over 'model' (the input
    of a product with a weight split on its output dim)."""
    return _CopyToModel.apply(x, ax)


def reduce_from_model(x, ax: MeshAxes):
    """The sum of ``x`` over 'model'; the grad passes through."""
    return _ReduceFromModel.apply(x, ax)


def gather_model(x, dim: int, ax: MeshAxes, summed: bool = False):
    """The whole of an activation split over 'model' along ``dim``. The
    backward takes the grad's block: the whole feeds a computation that is
    the same on every model rank. ``summed``: it feeds one split over
    'model' (each rank uses its part), so the backward sums the grad over
    'model' first (a reduce-scatter)."""
    return (_GatherModelSummed if summed else _GatherModel).apply(x, dim % x.ndim, ax)


def split_model(x, dim: int, ax: MeshAxes):
    """This rank's 'model' block of a whole activation along ``dim``."""
    return _SplitModel.apply(x, dim % x.ndim, ax)


def batch_mean(x, ax: Optional[MeshAxes]):
    """The mean over the batch axes of a per-rank mean (each rank's rows are
    an equal block of the batch, or all of it); the backward divides the
    grad by the batch axes' size. ``ax`` None: ``x``."""
    return x if ax is None else _BatchMean.apply(x, ax)


def all_reduce_max(x, ax: MeshAxes):
    """The maximum over 'model' (no grad)."""
    return _all_reduce(x.detach(), ax.groups["model"], dist.ReduceOp.MAX)


# ------------------------------------------------------------------ layouts
def _layout_of_placements(placements, ndim: int, ax: MeshAxes) -> tuple:
    """Per tensor dim, the mesh axes that split it, in mesh order."""
    return _layout(tuple(placements), ndim, ax.names)


@functools.lru_cache(maxsize=None)
def _layout(placements: tuple, ndim: int, names: tuple) -> tuple:
    from torch.distributed.tensor import Shard
    out = [()] * ndim
    for name, pl in zip(names, placements):
        if isinstance(pl, Shard):
            out[pl.dim] = out[pl.dim] + (name,)
        elif not pl.is_replicate():
            raise ValueError(f"a parameter's placement {pl} is neither Shard nor Replicate")
    return tuple(out)


def _relayout(x, ax: MeshAxes, src, dst, shape):
    """This rank's block in layout ``dst`` of a tensor whose block in layout
    ``src`` is ``x``: each dim whose axes differ is gathered whole over its
    ``src`` axes, then cut to its ``dst`` block."""
    moved = False
    for d, (s, t) in enumerate(zip(src, dst)):
        if s == t:
            continue
        if s:
            x = _all_gather(x, d, ax.group(s), ax.size(s))
        if t:
            lo, hi = block_range(shape[d], ax.size(t), ax.index(t))
            x = x.narrow(d, lo, hi - lo)
        moved = True
    if not moved:
        return x
    if x.storage_offset() or x.untyped_storage().nbytes() != x.numel() * x.element_size():
        x = x.clone(memory_format=torch.contiguous_format)
    return x


def _relayout_grad(g, ax: MeshAxes, src, dst, shape):
    """The grad of the ``src`` block, summed over the ranks that computed
    with it: each moved dim is put back whole (zeros outside the ``dst``
    block) and reduce-scattered over its ``src`` axes (all-reduced over its
    ``dst`` axes where ``src`` had none); then all-reduced over every batch
    axis not yet summed over."""
    summed = set()
    for d, (s, t) in enumerate(zip(src, dst)):
        if s == t:
            continue
        if t:
            g = _pad(g, d, shape[d], block_range(shape[d], ax.size(t), ax.index(t))[0])
        if s:
            g = _reduce_scatter(g, d, ax.group(s), ax.size(s), ax.index(s))
            summed |= set(s)
        else:
            for a in t:
                g = _all_reduce(g, ax.groups[a])
                summed.add(a)
    for a in ax.batch:
        if a not in summed:
            g = _all_reduce(g, ax.groups[a])
    return g


def _pad(g, dim: int, size: int, lo: int):
    whole = list(g.shape)
    whole[dim] = size
    out = g.new_zeros(whole)
    out.narrow(dim, lo, g.shape[dim]).copy_(g)
    return out


# storage (its StorageImpl, which a fake tensor has too) -> the gathered
# tensor (weakly held); its ``_regather`` makes it again
_GATHERED: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


class _Relayout(Function):
    @staticmethod
    def forward(ctx, local, ax, src, dst, shape):
        ctx.ax, ctx.src, ctx.dst, ctx.shape = ax, src, dst, shape
        out = _relayout(local, ax, src, dst, shape)
        if out is local:
            return local.view_as(local)
        held = local.detach()
        out._regather = lambda: _relayout(held, ax, src, dst, shape)
        _GATHERED[out.untyped_storage()._cdata] = out
        return out

    @staticmethod
    def backward(ctx, g):
        return _relayout_grad(g, ctx.ax, ctx.src, ctx.dst, ctx.shape), None, None, None, None


class _Regathered:
    __slots__ = ("fn", "size", "stride", "offset")

    def __init__(self, fn, t):
        self.fn, self.size, self.stride, self.offset = \
            fn, t.size(), t.stride(), t.storage_offset()


def _pack(t):
    if type(t) is not torch.Tensor or t.device.type == "meta":
        return t
    base = _GATHERED.get(t.untyped_storage()._cdata)
    if base is None or base.untyped_storage()._cdata != t.untyped_storage()._cdata:
        return t
    return _Regathered(base._regather, t)


def _unpack(x):
    if isinstance(x, _Regathered):
        return x.fn().as_strided(x.size, x.stride, x.offset)
    return x


def regather_saved():
    """A context in which autograd saves a gathered weight (a :func:`place`
    that moved a layout) as a handle that gathers it again in the backward:
    the ZeRO-3 memory profile (each layer's gathered weights live only
    while the layer runs, forward and backward)."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


# ---------------------------------------------------------------- placement
def gathers(params) -> bool:
    """Whether placing some leaf of ``params`` moves its layout: a DTensor
    split over a batch axis (fsdp), which :func:`place` gathers."""
    if isinstance(params, dict):
        return any(gathers(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return any(gathers(v) for v in params)
    src = shard_of(params)
    if src is None:
        return False
    ax = axes(src.device_mesh)
    return any(a in ax.batch for s in _layout_of_placements(src.placements, src.ndim, ax)
               for a in s)


def place(w):
    """A parameter as this rank computes with it: a DTensor (or a
    :func:`tracked` shard of one) becomes its local block in the compute
    layout (the storage layout without the batch axes), differentiable,
    tagged ``.tp`` (:class:`Split`); the grad that comes back to the shard
    is summed over the batch axes. Anything else comes back as it is."""
    src_t = shard_of(w)
    if src_t is None:
        return w
    ax = axes(src_t.device_mesh)
    src = _layout_of_placements(src_t.placements, src_t.ndim, ax)
    dst = tuple(tuple(a for a in s if a not in ax.batch) for s in src)
    local = w.to_local() if w is src_t else w
    out = _Relayout.apply(local, ax, src, dst, tuple(src_t.shape))
    dims = [d for d, t in enumerate(dst) if "model" in t]
    out.tp = Split(ax, dims[0] if dims else None)
    return out


def place_tree(tree):
    """:func:`place` over a tree of parameters (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: place_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v) for v in tree)
    return place(tree)


def check_block_constraint(layers, constraint) -> None:
    """Accept the reference's ``block_constraint`` for the layers ``layers``
    (a list of per-layer parameter trees on a mesh): one layer's spec tree,
    or a list of one per slot of a block (the hybrid pattern). The port
    computes every layer in its storage layout without the batch axes,
    which is what the reference's ZeRO-3 constraint (each layer's
    ``param_specs(fsdp=False)``) asks; any other constraint raises."""
    for i, layer in enumerate(layers):
        con = constraint[i % len(constraint)] if isinstance(constraint, list) else constraint
        _check_layer(layer, con, (i,))


def _check_layer(tree, con, path) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _check_layer(v, con[k], path + (k,))
        return
    if isinstance(tree, (list, tuple)):
        for j, v in enumerate(tree):
            _check_layer(v, con[j], path + (j,))
        return
    src_t = shard_of(tree)
    if src_t is None:
        raise ValueError("block_constraint constrains the layers of a model on a mesh; "
                         "these parameters are on none")
    ax = axes(src_t.device_mesh)
    src = _layout_of_placements(src_t.placements, src_t.ndim, ax)
    want = tuple(tuple(a for a in s if a not in ax.batch) for s in src)
    if len(con) > src_t.ndim:
        raise ValueError(f"layer leaf {path}: spec {con} has more entries than its "
                         f"{src_t.ndim} dims")
    got = tuple(() if d >= len(con) or con[d] is None else
                (con[d] if isinstance(con[d], tuple) else (con[d],))
                for d in range(src_t.ndim))
    if got != want:
        raise NotImplementedError(
            f"layer leaf {path}: block_constraint {con} is not the storage layout "
            f"without the batch axes {want}; the port computes every layer in that "
            "layout (per-layer ZeRO-3 under fsdp) and has no other")


def transpose(w):
    """``w.T`` of a placed 2-D weight, its ``.tp`` dim swapped."""
    out = w.T
    s = split_of(w)
    if s is not None:
        out.tp = Split(s.ax, None if s.dim is None else 1 - s.dim)
    return out


def cast(w, dtype):
    """``w.to(dtype)`` keeping its ``.tp``."""
    out = w.to(dtype)
    s = split_of(w)
    if s is not None and out is not w:
        out.tp = s
    return out


# ------------------------------------------------------------- the products
def linear(x, w, x_split: bool = False, op=torch.matmul):
    """``op(x, w)`` over this rank's blocks, Megatron's pairing by the split
    of ``w`` (a placed weight, the contraction on its dim -2 and the output
    on -1). ``x_split``: ``x``'s last dim is split over 'model' (the output
    of a product with a weight split on its output). Returns ``(y,
    y_split)``; an unsharded ``w`` gives ``(op(x, w), False)``."""
    s = split_of(w)
    if s is None or s.dim is None:
        if x_split:
            x = gather_model(x, -1, s.ax)
        return op(x, w), False
    if s.dim == w.ndim - 1:
        if x_split:
            x = gather_model(x, -1, s.ax)
        return op(copy_to_model(x, s.ax), w), True
    if s.dim == w.ndim - 2:
        if not x_split:
            x = split_model(x, -1, s.ax)
        return reduce_from_model(op(x, w), s.ax), False
    raise NotImplementedError(f"a weight split over 'model' on dim {s.dim} of {w.ndim}")


def whole(y, y_split: bool, w, summed: bool = False):
    """``y`` (the output of :func:`linear` with ``w``) made whole over
    'model' (``summed``: see :func:`gather_model`)."""
    return gather_model(y, -1, split_of(w).ax, summed) if y_split else y


def embedding(table, ids):
    """``table[ids]`` for a placed table: split over 'model' on its rows
    (the vocabulary), each rank looks up the ids in its rows (zero for the
    others) and the lookups are summed over 'model'; split on its columns,
    the lookup is gathered."""
    s = split_of(table)
    if s is None or s.dim is None:
        return table[ids]
    if s.dim == 1:
        return gather_model(table[ids], -1, s.ax)
    lo = s.ax.model_rank * table.shape[0]
    local = ids - lo
    hit = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(hit, local, 0)]
    return reduce_from_model(torch.where(hit[..., None], rows, 0), s.ax)


# ---------------------------------------------------------------- the batch
def local_rows(t):
    """``(local tensor, (lo, hi, rows))``: a batch DTensor's block on this
    rank and the rows ``[lo, hi)`` of the ``rows``-row batch it holds (all
    of them where the batch is whole on every rank). A plain tensor is all
    of its batch."""
    if not is_sharded(t):
        return t, (0, t.shape[0], t.shape[0])
    ax = axes(t.device_mesh)
    src = _layout_of_placements(t.placements, t.ndim, ax)
    if any(src[1:]):
        raise ValueError(f"a batch is split on its rows only, got {t.placements}")
    lo, hi = block_range(t.shape[0], ax.size(src[0]), ax.index(src[0]))
    return t.to_local(), (lo, hi, t.shape[0])


def rows_split_over(t) -> tuple:
    """The mesh axes a batch DTensor's rows are split over."""
    if not is_sharded(t):
        return ()
    ax = axes(t.device_mesh)
    return _layout_of_placements(t.placements, t.ndim, ax)[0]
