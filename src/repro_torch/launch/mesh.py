"""Device meshes on torch.distributed (the counterpart of
``repro.launch.mesh``) and the H100 constants of the dry runs' roofline.

Functions, not module-level constants: importing this module touches no
process group, and no builder initialises one. Each needs the default
process group up already (``torch.distributed.init_process_group``, as
``launch.serve --data-parallel`` does under ``torchrun``), and each mesh
spans every rank of it, rank order kept. The port is multi-controller: one
process per device, every rank builds the same mesh. A mesh lies on the
device type of the default backend unless the caller names one
(``device_type=``): "cuda" under NCCL, "cpu" under gloo and any other
backend. The dry runs (``launch.dryrun``) name "cuda" over the ``fake``
backend: fake tensors that claim the card, on a group of 256 or 512 ranks
that moves nothing.
"""
from __future__ import annotations

import math
import os
import weakref
from datetime import timedelta

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..sharding.rules import axis_sizes
from ..sharding.tensor_parallel import mesh_ranks


def launched() -> bool:
    """Whether a launcher (``torchrun``) set this process's ``RANK`` and
    ``WORLD_SIZE``."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_process_group(device_arg: str, init_method: str = "env://") -> torch.device:
    """The default process group of a launcher entry point: under a
    launcher's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` environment one
    rank of it (over ``init_method``), else a one-rank group in this
    process. NCCL on ``cuda:LOCAL_RANK``, gloo with ``device_arg`` "cpu".
    Returns this rank's device."""
    env = os.environ
    up = launched()
    rank = int(env["RANK"]) if up else 0
    world = int(env["WORLD_SIZE"]) if up else 1
    local = int(env.get("LOCAL_RANK", 0)) if up else 0
    if torch.device(device_arg).type == "cpu":
        device, backend, kw = resolve_device("cpu"), "gloo", {}
    else:
        device = resolve_device(f"cuda:{local}")
        torch.cuda.set_device(device)
        backend, kw = "nccl", {"device_id": device}
    if up:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    return device


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs the default process group: call "
            "torch.distributed.init_process_group first (a mesh never "
            "initialises one)")
    return dist.get_world_size()


def _mesh(shape: tuple, names: tuple, device_type=None):
    from torch.distributed.device_mesh import DeviceMesh
    n = _world()
    if math.prod(shape) != n:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs "
                         f"{math.prod(shape)} ranks, the world has {n}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """Single pod: (16, 16) ('data', 'model'); multi-pod: (2, 16, 16)
    ('pod', 'data', 'model'). Raises unless the world has that many ranks."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mesh((16, 16), ("data", "model"), device_type)


def make_host_mesh(model: int = 1, device_type=None):
    """('data', 'model') over every rank, ``model`` of them a data group."""
    n = _world()
    if n % model:
        raise ValueError(f"model={model} does not divide the {n} ranks")
    return _mesh((n // model, model), ("data", "model"), device_type)


def make_request_mesh(data: int | None = None):
    """1-axis ('data',) mesh for request-parallel serving and sampling over
    every rank (``data``, when given, must be the world size: every rank
    of an SPMD server runs the engine)."""
    n = _world() if data is None else data
    return _mesh((n,), ("data",))


def mesh_fingerprint(mesh) -> tuple:
    """Hashable identity of a mesh for executor-cache keys: axis names and
    sizes, then the ranks in mesh order."""
    return (tuple(axis_sizes(mesh).items()), tuple(int(r) for r in mesh_ranks(mesh)))


# How long a rank waits in a control-group collective before it raises. An
# idle leader sends a heartbeat well inside it (``serving.driver``).
CONTROL_TIMEOUT = timedelta(minutes=30)

# default process group -> {mesh fingerprint: control group}; weak, so the
# groups of a destroyed world go with it and a later world never gets them
_CONTROL: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def control_group(mesh):
    """The gloo group over ``mesh``'s ranks that carries host values (tick
    inputs, error estimates, tokens, generator states), with the timeout
    ``CONTROL_TIMEOUT``: made once per mesh layout and default process
    group (every rank must ask in the same order, as for any group)."""
    groups = _CONTROL.setdefault(dist.distributed_c10d._get_default_group(), {})
    key = mesh_fingerprint(mesh)
    if key not in groups:
        groups[key] = dist.new_group(mesh_ranks(mesh), backend="gloo",
                                     timeout=CONTROL_TIMEOUT)
    return groups[key]


def data_group(mesh):
    """The group of a 1-axis mesh (NCCL between cards, gloo on the CPU)."""
    return mesh.get_group(mesh.mesh_dim_names[0])


# H100 SXM constants of the dry runs' roofline (``launch.dryrun``), per GPU:
# spec-sheet values (NVIDIA H100 and DGX H100 data sheets), not
# measurements. PEAK_FLOPS_BF16 and HBM_BW are the figures the kernel
# bounds in PERF.md use.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12              # bytes/s, HBM3
HBM_BYTES = 80e9              # bytes of device memory
NVLINK_BW = 450e9             # bytes/s each way, NVLink 4 (18 links)
GPUS_PER_NODE = 8             # a DGX H100 node
NIC_BW = 50e9                 # bytes/s, one 400 Gb/s NIC per GPU
