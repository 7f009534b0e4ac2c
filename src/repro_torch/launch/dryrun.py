"""Dry runs on torch.distributed: every (arch x input shape x mesh) step on a
``fake`` process group of 256 (or 512) ranks, counted per device on rank 0,
with an H100 roofline from the counts (the counterpart of
``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma_2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --arch gemma_2b --shape deis_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl

The process is rank 0 of a ``fake`` group (it moves nothing); the
production mesh is built over it, and the step runs once on fake tensors
(``FakeTensorMode``: shapes, dtypes and devices, no storage) through the
port's own sharded code: ``launch.train.init_on_mesh``, the spec rules
and the explicit collectives of ``sharding.tensor_parallel``. ``--device``
defaults to ``cuda`` (fake tensors that claim the card, and a mesh on
"cuda": it needs CUDA torch and a card); ``cpu`` runs anywhere.

What is counted, on rank 0, by one stack of dispatch modes around one call
of the step (forward, backward and AdamW for ``train``):

* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``;
* ``bytes_per_device``: the sum over every aten op that is not a view
  (``OpOverload.is_view``, and ``_unsafe_view``) of the bytes of its
  tensor inputs and outputs. That is what unfused eager moves, each op
  reading its inputs from and writing its outputs to device memory; it
  stands where the reference has XLA's post-fusion "bytes accessed";
* ``collectives``: per kind under the reference's names (``all-reduce``
  counted twice, a ring's reduce and broadcast, as the reference's
  ``collective_bytes`` does), from the result tensors of the c10d ops, with
  ``counts``, ``total`` and ``by_axis`` (the mesh axis of each op's group;
  the group over every axis is named by them all, joined by "+");
* ``memory``: ``argument_bytes`` (the local shards of the step's
  arguments), ``output_bytes`` (of its outputs), ``temp_bytes`` (the peak
  of the live bytes of the storages the step made: each op's new output
  storages, freed when the last tensor on them goes) and ``peak_bytes``,
  their sum over the arguments, against the card's 80 GB.

Meta tensors (shape carriers) are left out of every count.

Eager runs every op of every layer, so the counts are whole: the
reference's ``extrapolated_costs`` (XLA counts a scan body once) and its
``--no-unroll`` have no counterpart, and ``cost_extrapolated`` is always
False. ``compile_s`` is the wall time of building the fake workload and
running its step; ``full_compile_s`` that of the step alone.

The roofline (``launch.mesh``'s H100 SXM spec-sheet constants, not
measurements): ``compute_s`` = flops / 989 TFLOP/s, ``memory_s`` = bytes
/ 3.35 TB/s, ``collective_s`` = the sum over mesh axes of the axis's bytes
over the slowest link its groups cross: NVLink 4 (450 GB/s) when every
group lies in one 8-GPU node, else the node's NIC (50 GB/s per GPU); a
group of one rank crosses none. Ranks are in mesh order, so the 16-wide
'model' axis spans two nodes. Nothing here is measured: every time is
modelled from counts.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import re
import time
import traceback
import weakref

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig, get_config
from ..core.sde import VPSDE
from ..device import resolve_device
from ..models import transformer as T
from ..sharding import rules as R
from ..sharding import tensor_parallel as TP
from ..training import steps as STEPS
from ..training.optimizer import AdamW, constant_schedule
from .mesh import (GPUS_PER_NODE, HBM_BW, HBM_BYTES, NIC_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                   make_production_mesh)
from .train import init_on_mesh

# archs that may run the 524k-decode shape (sub-quadratic attention path),
# as in the reference
LONG_OK = {"mamba2_2p7b", "jamba_1p5_large", "h2o_danube_3_4b", "mixtral_8x7b"}

ALL_ARCHS = ["whisper_tiny", "h2o_danube_3_4b", "paligemma_3b", "mixtral_8x7b",
             "grok_1_314b", "mamba2_2p7b", "glm4_9b", "gemma_2b",
             "granite_3_8b", "jamba_1p5_large"]

FSDP_PARAM_THRESHOLD = 8e9  # shard big-model weights/opt-state over 'data' too

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# c10d op -> kind; each op's first argument holds its result tensors. A
# c10d op outside this table raises (nothing goes uncounted).
_C10D_KIND = {
    "allreduce_": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "send": "collective-permute",
    "recv_": "collective-permute",
}
_VIEW_LIKE = {torch.ops.aten._unsafe_view.default}


def _shape(shape) -> ShapeConfig:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, path + (k,))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (i,))
    elif tree is not None:
        yield "/".join(map(str, path)), tree


@functools.lru_cache(maxsize=32)
def param_shapes(cfg: ModelConfig) -> dict:
    """The params tree of ``cfg`` with each leaf's ``torch.Size`` (a fake
    init: no storage; cached per config, so do not change it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..models.convert import tree_map
    with FakeTensorMode():
        return tree_map(lambda t: t.shape, T.init_params(cfg, 0, "cpu"))


def param_count(tree) -> int:
    """Elements over a tree of tensors (a DTensor counts whole) or shapes."""
    return sum(math.prod(getattr(leaf, "shape", leaf)) for _, leaf in _leaves_with_path(tree))


def model_flops(cfg: ModelConfig, shape) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE), D = tokens processed.
    Decode: D = global_batch (one token each); train counts fwd+bwd (x3)."""
    shp = _shape(shape)
    n_active = 0
    for ps, leaf in _leaves_with_path(param_shapes(cfg)):
        n = math.prod(leaf)
        if cfg.moe is not None and re.search(r"moe/(w_up|w_gate|w_down)$", ps):
            n = n * cfg.moe.top_k // cfg.moe.num_experts
        if ps == "embed":
            if cfg.tie_embeddings:
                n_active += n  # used as the LM head matmul
            continue  # lookup itself is not a matmul
        n_active += n
    tokens = shp.global_batch * (shp.seq_len if shp.kind != "decode" else 1)
    mult = 6.0 if shp.kind == "train" else 2.0
    return mult * n_active * tokens


def make_workload(cfg: ModelConfig, shape, mesh, *, fsdp=None, remat=True,
                  seq_shard_cache=True, sde=None, ff2d=False, zero3=False,
                  deis_shard="dmodel", device=None):
    """``(fn, args, n_params)``: the step of ``shape`` (a name of
    ``INPUT_SHAPES`` or a ``ShapeConfig``) and its arguments on ``mesh``,
    ready for ``fn(*args)``. Tensors are made on ``device`` (None: CUDA)
    under whatever mode the caller is in (fake under ``dryrun_one``, real
    on the card check): parameters by ``init_on_mesh``, AdamW's state
    placed as them, the batch by ``batch_specs``, a decode cache by
    ``cache_specs``.

    Kinds: ``train`` -> ``make_train_step`` (remat: each layer under
    checkpoint), ``prefill`` -> ``make_prefill_step``, ``deis`` -> one
    DEIS NFE (``make_deis_sample_step``: ``x`` and the order-3 history over
    'model' on the last dim, "dmodel", or the sequence, "seq"), ``decode``
    -> ``make_decode_step``, ONE token against a ``seq_len`` cache. The
    reference's ``in_shardings`` and ``donate`` have no eager counterpart:
    the placements are the arguments' own, and AdamW updates in place.

    fsdp None: over 'data' too when the model has more than
    ``FSDP_PARAM_THRESHOLD`` parameters. zero3: the reference's per-layer
    ``block_constraint`` (each layer's model-only specs) for the train step,
    which the port's fsdp already is (``make_train_step`` checks and takes
    it)."""
    shp = _shape(shape)
    b, s = shp.global_batch, shp.seq_len
    device = resolve_device(device)
    dtype = T._dtype(cfg)
    sde = sde or VPSDE()
    n_params = param_count(param_shapes(cfg))
    if fsdp is None:
        fsdp = n_params > FSDP_PARAM_THRESHOLD
    ba = R.batch_axes(mesh)
    params = init_on_mesh(cfg, 0, device, mesh, fsdp=fsdp, ff2d=ff2d)

    def put(t, spec):
        return R.device_put(t, R.NamedSharding(mesh, spec))

    def placed_batch(tree):
        return R.device_put(tree, R.to_shardings(R.batch_specs(tree, mesh), mesh))

    gen = torch.Generator(device=device).manual_seed(1)
    randn = lambda *sh: torch.randn(sh, generator=gen, device=device).to(dtype)
    batch = {"tokens": torch.zeros((b, s), dtype=torch.int32, device=device)}
    if cfg.arch_type == "encdec":
        batch["frames"] = randn(b, cfg.encoder_seq, cfg.d_model)
    if cfg.arch_type == "vlm":
        batch["prefix"] = randn(b, cfg.prefix_tokens, cfg.d_model)

    if shp.kind == "train":
        opt = AdamW(constant_schedule(1e-4))
        bc = None
        if zero3 and fsdp:      # model-only specs of one block's layers
            bs = T.block_size(cfg)
            slots = [R.param_specs(params["blocks"][j], mesh, path=("blocks", j))
                     for j in range(bs)]
            bc = slots[0] if bs == 1 else slots
        fn = STEPS.make_train_step(cfg, opt, sde, remat="block" if remat else False,
                                   block_constraint=bc)
        return fn, (params, opt.init(params), placed_batch(batch), gen), n_params

    if shp.kind == "prefill":
        fn = torch.no_grad()(STEPS.make_prefill_step(cfg))
        return fn, (params, placed_batch(batch)), n_params

    if shp.kind == "deis":
        order = 3
        if deis_shard == "seq":
            xs, hs = R.P(ba, "model", None), R.P(None, ba, "model", None)
        elif deis_shard == "dmodel":
            xs, hs = R.P(ba, None, "model"), R.P(None, ba, None, "model")
        else:
            raise ValueError(f"deis_shard must be dmodel or seq, got {deis_shard!r}")
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        x = put(randn(b, s, cfg.d_model), xs)
        hist = put(randn(order + 1, b, s, cfg.d_model), hs)
        fn = STEPS.make_deis_sample_step(cfg, sde)
        args = (params, x, hist, f32(0.5), f32(0.9), f32([0.4, 0.3, 0.2, 0.1]))
        return fn, args, n_params

    # decode: ONE token against a seq_len cache
    cache = T.init_cache(cfg, b, s, dtype, device)
    if cfg.arch_type == "encdec":       # the cross k and v prefill would leave
        kv = (b, cfg.encoder_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["cross"] = [{"k": torch.zeros(kv, dtype=dtype, device=device),
                           "v": torch.zeros(kv, dtype=dtype, device=device)}
                          for _ in range(cfg.n_layers)]
    cache = R.device_put(cache, R.to_shardings(
        R.cache_specs(cache, mesh, seq_shard=seq_shard_cache), mesh))
    n_b = math.prod(R.axis_sizes(mesh)[a] for a in ba)
    token = put(torch.zeros((b, 1), dtype=torch.int32, device=device),
                R.P(ba, None) if b % n_b == 0 else R.P(None, None))
    fn = torch.no_grad()(STEPS.make_decode_step(cfg))
    return fn, (params, cache, token, s - 1), n_params


# ----------------------------------------------------------------- counting
def _tensors(tree):
    """The tensors under ``tree``, meta ones (shape carriers) left out."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type != "meta":
            yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for k in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, k))


def _local_tensors(tree):
    for t in _tensors(tree):
        yield t.to_local() if TP.is_sharded(t) else t


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``'s (local) tensors."""
    seen = {}
    for t in _local_tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def axis_groups(mesh) -> dict:
    """``{axis name: [[ranks of each group along it]]}``, plus the group
    over every axis under their names joined by "+"."""
    shape = tuple(R.axis_sizes(mesh).values())
    names = R.axis_names(mesh)
    ranks = np.array(TP.mesh_ranks(mesh)).reshape(shape)
    out = {a: np.moveaxis(ranks, d, -1).reshape(-1, shape[d]).tolist()
           for d, a in enumerate(names)}
    out["+".join(names)] = [ranks.reshape(-1).tolist()]
    return out


def link_bw(groups) -> float:
    """Bytes/s of the slowest link ``groups`` cross: NVLink inside one node
    of ``GPUS_PER_NODE`` ranks, the NIC across nodes; inf for groups of one
    rank (they cross none)."""
    if all(len(g) == 1 for g in groups):
        return math.inf
    one_node = all(len({r // GPUS_PER_NODE for r in g}) == 1 for g in groups)
    return NVLINK_BW if one_node else NIC_BW


class CostCounter(TorchDispatchMode):
    """Counts what one call moves (see the module docstring): ``bytes`` of
    the non-view aten ops, the collectives by kind and by mesh axis, and the
    live and peak bytes of the storages made under it (``track`` names the
    arguments', which are not made here)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.bytes = 0
        self.coll = {k: 0.0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}
        self.by_axis: dict = {}
        self._axes = {} if mesh is None else self._axes_of(mesh)
        self.live = self.peak = 0
        self._held: dict = {}

    @staticmethod
    def _axes_of(mesh):
        names = R.axis_names(mesh)
        out = {id(mesh.get_group(a)): a for a in names}
        out.setdefault(id(dist.group.WORLD), "+".join(names))
        return out

    def track(self, tree) -> None:
        for t in _local_tensors(tree):
            self._held.setdefault(t.untyped_storage()._cdata, None)

    def _free(self, key, n):
        self._held.pop(key, None)
        self.live -= n

    def _new_storages(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held:
                continue
            n = st.nbytes()
            self._held[key] = weakref.finalize(st, self._free, key, n)
            self.live += n
            self.peak = max(self.peak, self.live)

    def _collective(self, func, args):
        kind = _C10D_KIND.get(func._opname)
        if kind is None:
            raise ValueError(f"the dry run counts no collective {func}")
        n = _nbytes(args[0]) * (2 if kind == "all-reduce" else 1)
        pg = next(dist.ProcessGroup.unbox(a) for a in args[1:]
                  if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()))
        axis = self._axes.get(id(pg), "+".join(map(str, dist.get_process_group_ranks(pg))))
        self.coll[kind] += n
        self.counts[kind] += 1
        self.by_axis[axis] = self.by_axis.get(axis, 0.0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self._collective(func, args)
        elif func.namespace == "aten" and not (func.is_view or func in _VIEW_LIKE):
            self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        self._new_storages(out)
        return out


def count_costs(fn, args, mesh=None) -> dict:
    """Run ``fn(*args)`` once under ``FlopCounterMode`` and a
    :class:`CostCounter`; returns the per-device counts (``flops``,
    ``bytes``, ``collectives``, ``memory``)."""
    from torch.utils.flop_counter import FlopCounterMode
    flops = FlopCounterMode(display=False)
    costs = CostCounter(mesh)
    costs.track(args)
    arg_bytes = _storage_bytes(args)
    with flops, costs:
        out = fn(*args)
    coll = dict(costs.coll, total=sum(costs.coll.values()), counts=dict(costs.counts),
                by_axis=dict(costs.by_axis))
    return {"flops": float(flops.get_total_flops()), "bytes": float(costs.bytes),
            "collectives": coll,
            "memory": {"argument_bytes": arg_bytes, "output_bytes": _storage_bytes(out),
                       "temp_bytes": costs.peak, "generated_code_bytes": None,
                       "peak_bytes": arg_bytes + costs.peak,
                       "fits_80gb": arg_bytes + costs.peak <= HBM_BYTES}}


def roofline(costs: dict, mesh) -> dict:
    """The three modelled terms of :func:`count_costs`' counts (seconds; a
    term with nothing counted is None, collectives over links that cross
    nothing are 0)."""
    groups = axis_groups(mesh)
    coll_s = sum(n / link_bw(groups[a]) if a in groups else n / NIC_BW
                 for a, n in costs["collectives"]["by_axis"].items())
    return {"compute_s": costs["flops"] / PEAK_FLOPS_BF16 if costs["flops"] > 0 else None,
            "memory_s": costs["bytes"] / HBM_BW if costs["bytes"] > 0 else None,
            "collective_s": coll_s}


def mesh_name(mesh) -> str:
    shape = tuple(R.axis_sizes(mesh).values())
    if shape == (16, 16):
        return "16x16"
    if shape == (2, 16, 16):
        return "pod2x16x16"
    return "x".join(map(str, shape))


def skip_reason(arch: str, cfg: ModelConfig, shape) -> str | None:
    """Why the reference's dry run skips this combo, or None."""
    shp = _shape(shape)
    if shp.kind == "deis" and cfg.arch_type == "encdec":
        return ("deis sampling workload is lowered unconditionally; "
                "enc-dec conditioning goes through the serve engine")
    if shp.name == "long_500k" and arch not in LONG_OK:
        return "full-attention arch; see DESIGN.md shape-coverage skips"
    return None


def dryrun_one(arch: str, shape, *, multi_pod: bool = False, mesh=None,
               fsdp=None, remat=True, seq_shard_cache=True, objective=None,
               verbose=True, overrides: dict | None = None, ff2d: bool = False,
               zero3: bool = False, deis_shard="dmodel", device=None) -> dict:
    """One combo's record (the reference's keys): the step built by
    :func:`make_workload` on fake tensors over ``mesh`` (default the
    production mesh of the default process group, which must have 256 or
    512 ranks) and counted by :func:`count_costs` on this rank.
    ``overrides``: config fields (``ssm_*`` ones go to the SSM config), as
    the hillclimb's variants give them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch)
    shp = _shape(shape)
    if objective is None:
        objective = "diffusion" if shp.kind in ("train", "deis") else "ar"
    cfg = cfg.with_(objective=objective)
    skip = {"arch": arch, "shape": shp.name, "status": "skipped"}
    if shp.kind == "deis" and cfg.arch_type == "encdec":
        return dict(skip, reason=skip_reason(arch, cfg, shp))
    if overrides:
        import dataclasses
        ssm_over = {k[4:]: v for k, v in overrides.items() if k.startswith("ssm_")}
        plain = {k: v for k, v in overrides.items() if not k.startswith("ssm_")}
        if ssm_over and cfg.ssm is not None:
            cfg = cfg.with_(ssm=dataclasses.replace(cfg.ssm, **ssm_over))
        if plain:
            cfg = cfg.with_(**plain)
    reason = skip_reason(arch, cfg, shp)
    if reason is not None:
        return dict(skip, reason=reason)

    device = resolve_device("cuda" if device is None else device)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device.type)
    t0 = time.perf_counter()
    with FakeTensorMode():
        fn, args, n_params = make_workload(
            cfg, shp, mesh, fsdp=fsdp, remat=remat, seq_shard_cache=seq_shard_cache,
            ff2d=ff2d, zero3=zero3, deis_shard=deis_shard, device=device)
        t1 = time.perf_counter()
        costs = count_costs(fn, args, mesh)
        del fn, args
    step_s = time.perf_counter() - t1
    n_dev = mesh.size()
    terms = roofline(costs, mesh)
    present = {k: v for k, v in terms.items() if v is not None}
    flops_dev = costs["flops"]
    mf = model_flops(cfg, shp)
    res = {
        "arch": arch, "shape": shp.name, "status": "ok",
        "mesh": mesh_name(mesh), "devices": n_dev,
        "objective": objective, "n_params": n_params,
        "compile_s": round(time.perf_counter() - t0, 1),
        "full_compile_s": round(step_s, 1),
        "flops_per_device": flops_dev, "bytes_per_device": costs["bytes"],
        "collectives": costs["collectives"],
        "cost_extrapolated": False,
        "memory": costs["memory"],
        "roofline": terms,
        "bottleneck": max(present, key=present.get) if present else None,
        "model_flops_total": mf,
        "useful_flops_ratio": mf / (flops_dev * n_dev) if flops_dev > 0 else None,
    }
    if verbose:
        print(json.dumps({k: res[k] for k in
                          ("arch", "shape", "mesh", "status", "compile_s",
                           "flops_per_device", "bytes_per_device", "bottleneck")}))
        print("  roofline:", terms)
        print("  collectives:", res["collectives"])
        print("  memory:", res["memory"])
    return res


def init_fake_world(world_size: int = 256) -> None:
    """This process as rank 0 of a ``fake`` process group of ``world_size``
    ranks (256 for the production mesh, 512 for the multi-pod one), its
    default group: collectives on it return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--objective", default=None)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device the fake tensors claim (default cuda; cpu runs "
                         "without a card)")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    args = ap.parse_args(argv)

    archs = ALL_ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]
    device = resolve_device(args.device)
    results = []
    for mp in meshes:
        init_fake_world(512 if mp else 256)
        try:
            mesh = make_production_mesh(multi_pod=mp, device_type=device.type)
            for a in archs:
                for s in shapes:
                    results.append(_run_one(a, s, mp, mesh, args, device))
        finally:
            dist.destroy_process_group()

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped, {n_err} errors"
          f" / {len(results)} combos")
    if n_err:
        raise SystemExit(1)


def _run_one(arch, shape, multi_pod, mesh, args, device) -> dict:
    try:
        r = dryrun_one(arch, shape, multi_pod=multi_pod, mesh=mesh,
                       fsdp=(False if args.no_fsdp else None),
                       remat=not args.no_remat, objective=args.objective, device=device)
    except Exception as e:  # noqa: BLE001 -- the record says what failed
        traceback.print_exc()
        r = {"arch": arch, "shape": shape, "mesh": mesh_name(mesh),
             "status": "error", "error": str(e)[:2000]}
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(r) + "\n")
    return r


if __name__ == "__main__":
    main()
