"""Training launcher on PyTorch (the counterpart of ``repro.launch.train``
on one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_2b \
        --steps 50 --batch 8 --seq 64 [--objective diffusion|ar] \
        [--ckpt-dir ckpts/run1 [--ckpt-every N]]

Runs on the CUDA card; ``--device cpu`` runs it on the CPU (with
``--reduced`` for the small float32 model). The log lines are the
reference's (``arch=... mesh=...``, ``step ... loss=... gnorm=...``,
``restored checkpoint at step N``, ``final checkpoint -> DIR``), the mesh
being one device, plus a last summary line: the median step time, tokens
per second and peak device memory. ``--model-parallel`` above 1 (a
sharded mesh) is not ported and raises.

Checkpoints hold ``(params, opt_state)`` in the reference's format, so
either launcher resumes the other's run. As in the reference, a resumed
run re-seeds its generator (``seed + 1``) before the loop, so its first
steps re-use the draws of the run's first steps: it is not the
uninterrupted run.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from ..configs.base import get_config
from ..data.pipeline import MarkovTextSource, make_batch
from ..device import resolve_device
from ..models import transformer as T
from ..training import checkpoint as CKPT
from ..training.optimizer import AdamW, cosine_schedule
from ..training.steps import make_train_step


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
                    help="model-axis shards (not ported: above 1 raises)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu runs "
                         "the port on the CPU explicitly)")
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 (a sharded mesh over several devices) is not "
            "ported yet: it is ROADMAP Queue 1's multi-GPU item; train on one "
            "device without it")
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.with_(objective=args.objective)
    print(f"arch={cfg.name} objective={cfg.objective} mesh={{'data': 1, 'model': 1}}")

    params = T.init_params(cfg, args.seed, device)
    opt = AdamW(cosine_schedule(args.lr, max(1, args.steps // 10), args.steps))
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt)

    start = 0
    if args.ckpt_dir and CKPT.latest_step(args.ckpt_dir) is not None:
        (params, opt_state), meta = CKPT.restore(args.ckpt_dir, (params, opt_state))
        start = meta.get("next_step", 0)
        print(f"restored checkpoint at step {start}")

    src = MarkovTextSource(cfg.vocab_size, args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    step_s = []
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 make_batch(cfg, src, i, args.batch, args.seq).items()}
        t_step = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch, gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t_step)
        if i % max(1, args.steps // 10) == 0:
            print(f"step {i:5d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"({(time.perf_counter() - t0):.1f}s)")
        if args.ckpt_dir and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            CKPT.save(args.ckpt_dir, i + 1, (params, opt_state),
                      {"next_step": i + 1, "arch": cfg.name})
    if args.ckpt_dir:
        CKPT.save(args.ckpt_dir, args.steps, (params, opt_state),
                  {"next_step": args.steps, "arch": cfg.name})
        print(f"final checkpoint -> {args.ckpt_dir}")
    if step_s:
        med = statistics.median(step_s)
        peak = (f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
                if device.type == "cuda" else "not measured (cpu)")
        print(f"trained {len(step_s)} steps on {device}: median step {med * 1e3:.1f} ms "
              f"(first {step_s[0] * 1e3:.1f} ms), "
              f"{args.batch * args.seq / med:.1f} tokens/s, peak memory {peak}")


if __name__ == "__main__":
    main()
