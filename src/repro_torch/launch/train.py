"""Training launcher on PyTorch (the counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_2b \
        --steps 50 --batch 8 --seq 64 [--objective diffusion|ar] \
        [--ckpt-dir ckpts/run1 [--ckpt-every N]]
    PYTHONPATH=src torchrun --nproc_per_node=W -m repro_torch.launch.train \
        --arch gemma_2b --model-parallel M ...

Runs on the CUDA card; ``--device cpu`` runs it on the CPU (with
``--reduced`` for the small float32 model). The log lines are the
reference's (``arch=... mesh=...``, ``step ... loss=... gnorm=...``,
``restored checkpoint at step N``, ``final checkpoint -> DIR``), plus a
last summary line: the median step time, tokens per second over the
global batch and this rank's peak device memory.

Under a launcher (``torchrun``'s ``RANK`` / ``WORLD_SIZE``; the process
group from ``--dist-init-method``, NCCL on ``cuda:LOCAL_RANK`` or gloo with
``--device cpu``) it trains on ``make_host_mesh(model=M)``, a (data W/M,
model M) mesh: the parameters and the AdamW state are placed by
``param_specs`` / ``opt_state_specs`` (each rank holds its shards), and
each batch by ``batch_specs`` (each rank its rows). Only rank 0 prints
and writes. Without a launcher it trains on one device (``--model-parallel``
above 1 then raises: it needs M ranks).

Checkpoints hold ``(params, opt_state)`` whole, in the reference's format,
so either launcher, sharded or not, resumes the other's run. As in the
reference, a resumed run re-seeds its generator (``seed + 1``) before the
loop, so its first steps re-use the draws of the run's first steps: it is
not the uninterrupted run.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch
import torch.distributed as dist

from ..configs.base import get_config
from ..data.pipeline import MarkovTextSource, device_put_sharded, make_batch
from ..device import resolve_device
from ..models import transformer as T
from ..sharding import rules as R
from ..training import checkpoint as CKPT
from ..training.optimizer import AdamW, cosine_schedule
from ..training.steps import make_train_step
from .mesh import init_process_group, launched, make_host_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--objective", default="diffusion")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-axis size of the mesh (under torchrun; the data "
                         "axis takes the other ranks)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu runs "
                         "the port on the CPU explicitly)")
    ap.add_argument("--dist-init-method", default="env://",
                    help="init method of the process group under a launcher's "
                         "RANK / WORLD_SIZE environment (default env://, the "
                         "MASTER_ADDR / MASTER_PORT torchrun sets)")
    args = ap.parse_args(argv)
    if not launched():
        if args.model_parallel > 1:
            raise ValueError(
                f"--model-parallel {args.model_parallel} shards the model over "
                f"{args.model_parallel} ranks: run it under torchrun (e.g. torchrun "
                f"--nproc_per_node={args.model_parallel} -m repro_torch.launch.train ...)")
        _train(args, resolve_device(args.device), None)
        return
    device = init_process_group(args.device, args.dist_init_method)
    try:
        _train(args, device, make_host_mesh(model=args.model_parallel))
        dist.barrier()
    finally:
        dist.destroy_process_group()    # a rank that raised fails the others' collectives


def init_on_mesh(cfg, seed: int, device, mesh, fsdp: bool = False,
                 ff2d: bool = False) -> dict:
    """``init_params(cfg, seed, device)`` placed on ``mesh`` by
    ``param_specs`` (with its ``fsdp`` and ``ff2d`` levers), each layer and
    top-level entry as soon as it is made: a rank never holds more of the
    model whole than its largest piece."""
    return T.init_params(cfg, seed, device, place=lambda path, tree: R.device_put(
        tree, R.to_shardings(R.param_specs(tree, mesh, fsdp=fsdp, ff2d=ff2d, path=path),
                             mesh)))


def _train(args, device, mesh) -> None:
    leader = mesh is None or dist.get_rank() == 0
    say = print if leader else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.with_(objective=args.objective)
    shape = {"data": 1, "model": 1} if mesh is None else R.axis_sizes(mesh)
    say(f"arch={cfg.name} objective={cfg.objective} mesh={shape}")

    params = (T.init_params(cfg, args.seed, device) if mesh is None
              else init_on_mesh(cfg, args.seed, device, mesh))
    opt = AdamW(cosine_schedule(args.lr, max(1, args.steps // 10), args.steps))
    opt_state = opt.init(params)       # on a mesh: the moments placed as their params
    step = make_train_step(cfg, opt)

    start = 0
    if args.ckpt_dir and CKPT.latest_step(args.ckpt_dir) is not None:
        (params, opt_state), meta = CKPT.restore(args.ckpt_dir, (params, opt_state))
        start = meta.get("next_step", 0)
        say(f"restored checkpoint at step {start}")

    src = MarkovTextSource(cfg.vocab_size, args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step_s = []
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        host = make_batch(cfg, src, i, args.batch, args.seq)
        if mesh is None:
            batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        else:
            batch = device_put_sharded(
                host, R.to_shardings(R.batch_specs(host, mesh), mesh), device)
        t_step = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch, gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t_step)
        if i % max(1, args.steps // 10) == 0:
            say(f"step {i:5d} loss={float(m['loss']):.4f} "
                f"gnorm={float(m['grad_norm']):.3f} "
                f"({(time.perf_counter() - t0):.1f}s)")
        if args.ckpt_dir and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            CKPT.save(args.ckpt_dir, i + 1, (params, opt_state),
                      {"next_step": i + 1, "arch": cfg.name})
    if args.ckpt_dir:
        CKPT.save(args.ckpt_dir, args.steps, (params, opt_state),
                  {"next_step": args.steps, "arch": cfg.name})
        say(f"final checkpoint -> {args.ckpt_dir}")
    if step_s:
        med = statistics.median(step_s)
        peak = (f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
                if device.type == "cuda" else "not measured (cpu)")
        say(f"trained {len(step_s)} steps on {device}: median step {med * 1e3:.1f} ms "
            f"(first {step_s[0] * 1e3:.1f} ms), "
            f"{args.batch * args.seq / med:.1f} tokens/s, peak memory {peak}")


if __name__ == "__main__":
    main()
