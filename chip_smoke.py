#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one CUDA card.

    python3 chip_smoke.py                      # on a machine with a CUDA card
    python3 chip_smoke.py --device cpu --reduced   # rehearsal, plain versions

Phases (any failure raises and the script exits non-zero):

1. Device: the card's name, count, ``nvidia-smi`` name and power limit;
   TF32 off for float32 matmuls and convolutions.
2. Build: kernels K2 and K3, the SSM mixer's passes and the MoE's four
   kernels (CUDA C++, ``src/repro_torch/kernels/csrc``) compiled by nvcc for sm_90a into
   ``build/kernels``, one nvcc per source, started together. Each source holds four kernels, one per route: wgmma
   (bf16 that TMA can describe), mma_sync (other bf16), tf32x3 (float32
   with 16-byte aligned bases; K3: P and N multiples of 8) and cuda_cores
   (other float32). For every kernel, ptxas's registers and spills, and its
   HMMA (mma.sync), HGMMA (wgmma) and UTMALDG (TMA load) counts in SASS
   (``cuobjdump -sass``); an mma_sync or tf32x3 kernel without HMMA, a wgmma
   kernel without HGMMA or UTMALDG, any of them with spills, or a
   setmaxnreg that ptxas dropped, fails the phase.
3. Kernel K1 (``fused_ab_step``, Triton, built into ``build/triton``): held
   against its plain PyTorch version for r in 1..4, noise on/off, error
   pair on/off, R in {1, 5} at a ragged size (rtol = atol = 1e-6; K1 is
   built without FMA contraction, so float32 reads 0), stacked rows bitwise equal to solo
   calls; at the one-shot path's shapes (one row of M 1024 = batch 4 x seq
   256, D 2048 for gemma-2b and 2560 for mamba2-2.7b, r 1..3, no noise, no
   error pair); then timed with CUDA events at the main path's shape beside
   the plain version and the byte bound.
4. Kernel K2 (``flash_attention``): held against its plain version over the
   five shapes of the JAX kernel tests, a cross-attention case (Sq != Sk),
   a causal window at D 256, and the full widths of gemma-2b (B 4, S 256,
   H 8, KV 1, D 256), mixtral-8x7b (B 4, S 256, H 32, KV 8, D 128, window
   4096), whisper-tiny's decoder (B 4, S 256, H 6, KV 6, D 64),
   paligemma-3b's prefix and text (B 4, S 512, H 8, KV 1, D 256),
   glm4-9b (B 4, S 256, H 32, KV 2, D 128), granite-4.0-h-small (B 16, S
   256, H 32, KV 8, D 128, softmax scale 1/128) and cifar10-scorenet (B 4,
   S 256, H 4, KV 4, D 64), all bidirectional: each dtype on its own route
   (float32 tf32x3; bf16 wgmma, mma_sync at D 32), again on the route that
   takes any operand of the dtype (float32 cuda_cores, bf16 mma_sync) asked
   for and as unaligned views, at the JAX tests' tolerance (2e-5 float32,
   2e-2 bf16), each route's launch count checked; then at those shapes, in
   turns, the wgmma kernel, the mma_sync kernel, the plain version and
   ``scaled_dot_product_attention`` (the yardstick only; the port never
   calls it) in bf16, and the tf32x3 and cuda_cores kernels, the plain
   version and SDPA in float32, beside the bound (float32: at 165 TFLOP/s,
   3xTF32 on the tensor cores, and at 67 TFLOP/s, the CUDA cores).
5. Kernel K3 (``ssd_scan``): held against its plain version over the four
   shapes of the JAX kernel tests, three chunks at mamba2's widths and
   mamba2-2.7b's full width (Bb 4, S 256, H 80, P 64, N 128, chunk 256,
   float32 a): each dtype on its own route (float32 tf32x3, bf16 wgmma),
   again on cuda_cores or mma_sync asked for and as unaligned views, at the
   JAX tests' tolerance (2e-4 float32, 5e-2 bf16); float32 at mamba2's
   widths adds an absolute term of 1e-5 x max|want| (sums of 256 x 128
   terms in another order, on outputs of order hundreds); then the four
   kernels timed in turns beside the plain version and the bound (C B^T
   counted once per batch; float32 at 165 and 67 TFLOP/s; no single
   library call).
5a. The SSM mixer's two pointwise passes (``phase_ssm_pointwise``,
   ``kernels/ssm_pointwise.py``: ``ssm_conv_prep_kernel`` for ``pre``,
   ``ssm_gated_norm_kernel`` for ``post``) on views of an in-projection
   output at mamba2-2.7b's and granite-4.0-h-small's one-shot shapes (Bb
   16, S 256, H 80 and 128), jamba-1.5-large's mixer widths, the reduced
   config, S < K - 1, S no multiple of the time tile, K 1 and unaligned
   views, in float32 and bf16: ``pre`` within one rounding of the same sums
   in float64 (bf16 rtol 2^-7, atol 1e-5; float32 1e-5) and within the
   plain chain's own rounding error, its decay at rtol 1e-5; ``post``, norm
   then gate and gate first, within one rounding of its plain version in
   the same order. Then each kernel timed in turns beside its plain
   version and its byte bound (the gate-first norm at granite's shape, its
   own row ``ssm_post_gate_first`` in the kernel table).
5a'. The MoE layer's four kernels (``phase_moe_dispatch``,
   ``kernels/moe_dispatch.py``: ``moe_route``, ``moe_gather``, ``moe_glu``,
   ``moe_combine``) at granite-4.0-h-small's and mixtral-8x7b's one-shot
   shapes, with every token on the same experts, and at odd widths, in
   float32 and bf16: the route's choices, places, slots and table bitwise
   its plain version's, its gates within float32 rounding; the gather
   bitwise; the GLU and the combine (with and without the shared addend)
   within one rounding. Then each kernel timed in turns beside its plain
   version and its byte bound at granite's shape (its own kernel-table
   row).
5b. Scaling (``phase_scaling``): the bf16 wgmma and mma_sync kernels in
   turns at B 4, 8, 16, 32 of gemma's and whisper's attention and Bb 4, 8,
   16 of mamba2's scan, each time beside B 4's.
5c. Stress (``phase_stress``, ``tools/kernel_stress.py``): the Hopper
   routes launched many times with a sync after each: the wgmma kernels
   (mbarrier rings) 6000 times each, K3 at mamba2's widths with Bb 4 and 16
   in turn, K2 at gemma-2b's heads at B 4 and at B 1, S 1024 (key tiles
   split between the warpgroups) and B 16 (not split) in turn; the tf32x3
   kernels 2000 times each at the same shapes in float32. Every output
   bitwise the first launch's at its shape; a fault or a wrong output fails
   the run.
6. Serving: gemma-2b at its published widths (18 layers, d_model 2048,
   MQA 8/1 heads of 256, d_ff 16384, vocab 256000, bf16), random weights
   from a seed, through ``DiffusionServeEngine`` with a ``RetirePolicy``
   and seq_len buckets (128, 256): two staggered waves of mixed-family
   requests (so a join happens), a warm replay that must add no executor,
   K1's launch count against the ``ab`` group steps served, the
   stacked-vs-solo difference of the eps-net on the card (reported, not
   asserted).
6b. Request-axis serving (after phase 6, on its weights): phase 6's mix
   through ``DiffusionServeEngine(mesh=make_request_mesh())`` over a
   one-rank NCCL data group and its gloo control group (``file://`` store
   under ``build/``): tokens, NFE, early exits and final errors bitwise
   equal to the unsharded engine's on the card (at one rank the local
   shapes are the unsharded ones), no new executor on warm replays, K1's
   launches equal to the ``ab`` group steps; warm ms per tick, sharded
   against unsharded, in turns (the difference is the control plane's
   cost); a ``ServeDriver`` over the sharded engine.
7. One-shot kernel path: ``sample_tokens(..., use_kernels=True)`` with a
   fused tab3 plan of 10 NFE at batch 4, seq 256, on full-width gemma-2b
   (the same weights; attention through K2) and full-width mamba2-2.7b (64
   layers, d_model 2560, 80 SSD heads of 64, state 128, chunk 256, vocab
   50280, bf16, random weights from seed 0; the scan through K3). Launch
   counts asserted (K2 18 x NFE on gemma, K3 64 x NFE on mamba2, all on the
   wgmma route; K1 one per ab step); tokens and x0 compared with
   the same call at ``use_kernels=False`` (reported); eps-forward time per
   NFE on both routes, the kernel route's device time by kernel, peak
   memory.
8. Launcher over HTTP (after phase 6, on its weights): ``ServeDriver``
   with ``stream_decode`` and ``max_pending`` 9 behind ``make_http_server``
   on 127.0.0.1, clients on threads with urllib: a lone request bitwise
   equal to its solo solve through the sync engine; 8 concurrent requests
   of 5 solvers (tab3, ddim, rho_heun, seeds2, dpm2m), half streamed (step
   lines k = 1..n, then the result, ``nfe`` as asked); a burst over
   ``max_pending`` answered 429; a long streamed request cancelled through
   ``/v1/cancel`` (its stream ends in an error event); 400 and 404;
   ``/metrics`` and ``/stats`` counts that add up; no driver crash; K1's
   launches equal to the ``ab`` group steps served. Reports latency p50 and
   max, tokens per second and the share of tokens equal to solo solves.
9. AR decode (after each one-shot model, on its weights with the AR head):
   ``ARServeEngine`` on gemma-2b and mamba2-2.7b, 4 prompts of 8-64
   tokens, 16 new tokens each: prefill-then-decode logits against one full
   forward within AR_TOL (asserted); prefill ms, ms per decoded token, the
   device's idle share during decode, peak memory, and the share of greedy
   tokens equal to a no-cache greedy loop.
10. Mixtral-8x7b at its published widths (d_model 4096, GQA 32/8 heads of
   128, window 4096, 8 experts of d_ff 14336, top-2, vocab 32000, bf16),
   cut to 8 of its 32 layers (11.9 B parameters, 23.8 GB; all 32 would not
   fit the card), random weights from seed 0: (a) the served mix of phase
   6 through ``DiffusionServeEngine`` (K1 launches = ``ab`` group steps and
   no new executor warm, asserted; tokens/s; stacked-vs-solo share); (b)
   the one-shot kernel path of phase 7 (8 x 10 = 80 K2 launches, all on the
   wgmma route, and 80 of each MoE kernel, asserted), the eps forward per
   NFE on both routes for both MoE dispatch modes (the kernel route has one
   algorithm: the two read alike), and the kernel route's device time by part (expert
   GEMMs, attention GEMMs, MoE routing and dispatch, K2, other), idle share
   and peak memory; (c) AR decode as phase 9 at capacity_factor 100 (no
   drops: prefill, decode and the full forward route alike).
10b. Expert parallelism: ``moe_expert_parallel`` on mixtral's layer 0 (8
   experts, d_model 4096, d_ff 14336, bf16, 2.82 GB) over a one-rank NCCL
   group against ``layers.moe`` (gather dispatch) at capacity_factor 100,
   x (4, 256, 4096) from a seed: the output within EP_TOL (2e-2) of
   max|moe|, the load-balance loss within 1e-3; both timed in turns.
10c. Granite-4.0-h-small whole at its published widths (40 layers: 36
   SSD mixers of 128 heads x 64 with the gated norm gate-first, 4 NoPE
   GQA 32/8 attention layers of 128 at softmax scale 1/128, every layer a
   MoE of 72 experts of 768, top 10, with a shared expert of 1536; muP
   multipliers; vocab 100352; 32.2 B parameters, 64.5 GB in bf16), random
   weights from seed 0: the one-shot kernel path of phase 7 (K2 4 x 10 =
   40 launches, K3 and each SSM pass 36 x 10 = 360, all on the wgmma
   route, each MoE kernel 40 x 10 = 400, asserted; the x0 within the
   cell's x0_rel limit, 0.015 relative L2, of the plain route's), the eps
   forward per NFE on both routes, the kernel route's device time by
   kernel and peak memory.
11. Whisper-tiny at its published widths (4 decoder and 4 encoder layers,
   d_model 384, 6 heads of 64, d_ff 1536, vocab 51865, bf16) over frames
   (4, 1500, 384) drawn from a seed, random weights from seed 0: the
   one-shot kernel path of phase 7 with ``frames`` (K2 4 x 10 = 40
   launches on the wgmma route, the encoder and cross-attention on the
   plain route as in the reference, asserted), the encoder's share of the
   eps forward's device time; AR with frames: prefill 16 tokens, then 15
   decode steps against the self and cross caches, the logits against one
   full forward within AR_TOL (asserted).
12. Paligemma-3b at its published widths (gemma-2b's decoder, vocab
   257216) behind a (4, 256, 2048) image-patch prefix drawn from a seed:
   the one-shot kernel path with ``prefix`` (K2 18 x 10 = 180 launches at
   S 512, all on the wgmma route, asserted), peak memory; AR with the prefix (``cache_index``
   counts it) as for whisper.
13. Card against CPU: the reduced float32 models on the card against the
   same models on the CPU (plain versions), finite x0 of the right shape
   that agree at 1e-3: the one-shot route of gemma-2b, mamba2-2.7b,
   jamba-1.5-large (K2 and K3 together), mixtral-8x7b (both dispatch modes;
   every K2 and K3 launch on its 3xTF32 kernel, asserted), grok-1 (the
   plain route: its logit softcap is not in K2), whisper-tiny (with
   frames), paligemma-3b (with a prefix) and cifar10-scorenet at its
   published widths (4 layers, d_model 256, 4 heads of 64, float32: the
   3xTF32 K2 at D 64); the
   reduced float32 AR decode of gemma-2b, mamba2-2.7b, h2o-danube-3-4b (a
   40-token prompt into the 16-slot ring), jamba-1.5-large (a cache of ssm
   and attention layers), whisper-tiny (a cross cache) and paligemma-3b (a
   prefix) at 1e-3.
   Then one train step of each arch type (dense, ssm, moe, hybrid,
   encdec with frames, vlm with a prefix; diffusion, and ar on gemma) at
   the reduced float32 config from the same params, batch and t / eps:
   the loss, every grad and the AdamW update against the CPU; and CLD's
   matrix tAB-DEIS and its RK4 reference in float64 against the CPU.
   Meanwhile ``python -m repro_torch.launch.serve --arch gemma_2b
   --transport driver --requests 6 --seq-len 128`` and ``python -m
   repro_torch.launch.train --arch gemma_2b --steps 3 --batch 4 --seq 256``
   run as subprocesses at full width; each must exit 0 (``served 6
   requests``; three finite losses and the summary line). Beside them,
   ``torchrun --standalone --nproc_per_node=1 -m repro_torch.launch.serve
   --arch gemma_2b --data-parallel --requests 6 --seq-len 128`` (sync
   transport, whose batch does not depend on timing) must exit 0, print
   the mesh line and the unsharded engine's tokens; and the sharded
   engine over 2 gloo ranks on this machine's CPU (reduced gemma-2b,
   subprocesses) must give the unsharded CPU engine's tokens bitwise.
   Once the train CLI has exited (the two would not fit the card
   together), ``torchrun --standalone --nproc_per_node=1 -m
   repro_torch.launch.train --arch gemma_2b --model-parallel 1 --steps 3
   --batch 4 --seq 256`` must exit 0 with the one-rank mesh line and the
   train CLI's step lines; and ``torchrun --nproc_per_node=4 ... --device
   cpu --reduced --model-parallel 2`` (a (2, 2) mesh of gloo ranks on this
   machine's CPU) must print losses and grad norms within one printed digit
   of the unsharded CPU launcher's.
14a. Sharded training (after gemma's AR phase, on its weights, which it
   leaves as they were): 3 diffusion steps at batch 4, seq 256 of the
   unsharded step on a copy of the weights, then of the model-parallel
   step on a one-rank NCCL host mesh {'data': 1, 'model': 1} (params,
   moments and batches as DTensors), then the same with the ZeRO-3
   saved-tensor hooks forced on (their host cost alone: no placement
   gathers, so the step installs none itself), then with ``fsdp`` (each
   layer's weights gathered for it and again in the backward: the port's
   ZeRO-3): losses, grad norms and the params after the last step bitwise
   equal to the unsharded run's (at one rank the local shapes, and so the
   products, are the unsharded ones; the largest differences are
   printed); ms per step, tokens/s, device busy and idle share, the
   optimizer's device time and peak memory of each.
14. Training (after gemma's AR phase, on its weights, which it then
   changes): 5 train steps of the diffusion objective, then 3 of the ar
   objective, each from a fresh AdamW state, at batch 4, seq 256 of the
   Markov corpus on full-width gemma-2b (2.5 B parameters in bf16, float32
   moments, no remat), on the plain route as in the reference (no kernel
   launch, asserted): finite losses and grad norms (asserted), ms per step
   (median, synchronised), tokens/s, peak memory, and from torch.profiler
   the device time by part (forward, backward, optimizer) and the idle
   share. Then cifar10-scorenet at its published widths (vocab 256),
   30 steps at batch 16, seq 32: the loss must fall; its ``(params,
   opt_state)`` checkpoint round-trips bitwise.
15. The paper's headline (examples/quickstart on this device): an MLP score
   net trained 1500 steps on the 8-mode GMM, 1024 samples with ddim, tab1,
   tab2, tab3, rho_heun and ipndm3 at NFE 5/10/20/50 against rho_rk4 on
   400 log_rho steps (the error table printed); tAB3@10 < DDIM@10
   asserted; every ab plan fused, so K1 runs at x (1, 1024, 2), its
   launches asserted and held against its plain version there; the GMM
   likelihood at 8/16/32 kutta3 steps (error under 0.02 bits/dim at 32,
   asserted) and one ``AdaptiveRK23`` solve (NFE, accepted, rejected).
16. The dry runs (``launch.dryrun``, ``launch.hillclimb``; ``phase_dryrun``):
   one DEIS NFE and one model-parallel train step of full-width gemma-2b
   at batch 4, seq 256, built by the dry run's ``make_workload``, counted
   on the card over a one-rank NCCL mesh and, in a subprocess, on fake
   CUDA tensors over a fake one-rank group: FLOPs, bytes and collectives
   equal (asserted); the measured step (CUDA events) beside the modelled
   roofline terms, the fake peak beside ``max_memory_allocated``. Then the
   CLIs on the (16, 16) production mesh of a fake 256-rank group in
   subprocesses: gemma-2b at ``deis_4k`` and ``train_4k`` (status ok,
   FLOPs and collectives counted) and the ``gemma_deis`` hillclimb (every
   variant ran).
17. The port's static analyzer (``python -m repro_torch.analysis``;
   ``phase_analysis``) in a subprocess on this machine's Python, which has
   no JAX: ``src/repro_torch`` with ``--json --bench`` exits 0 with no
   active violation and ``static.files`` equal to the package's ``.py``
   files; each bad fixture of ``tests/torch_analysis_fixtures`` fires its
   rule alone, its exact count of times. Prints the files, the allowed
   sites by rule and the seconds.

The kernel JSON has one row per hand-written kernel: K1, and the four
kernels of K2 and of K3, each with its launches on its paths (K1 on the
served paths of gemma, unsharded and sharded, and of mixtral, and the
paper path's fused solves; the wgmma kernels on the bf16 one-shot paths;
the mma_sync kernels there too, where no launch takes them: they serve
bf16 operands that TMA cannot describe, which no main path makes; the
tf32x3 kernels on the float32 one-shot paths of phase 13, and the
CUDA-core kernels there too, where no launch takes them: they serve
float32 operands that cp.async cannot copy). A float32 row's bound_ms is
at 165 TFLOP/s and its bound_cuda_cores_ms at 67. The training path launches none
(the reference trains with ``use_pallas=False``; no kernel has a
backward).

The line before the last is the kernel JSON; the last line is
``{"ok": true, "device": {...}}``. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
K1_TOL = 1e-6          # float32 (K1 has no FMA contraction: it reads 0 against its plain version)
CARD_VS_CPU_TOL = 1e-3  # reduced float32 model: cuBLAS vs CPU summation order
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published memory rate
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core rate
FP32_FLOPS = 67e12          # H100 SXM float32 rate outside the tensor cores
# float32 products at float32 accuracy on the tensor cores: the dense TF32
# rate (495 TFLOP/s) over the three products of a 3xTF32 split
TF32X3_FLOPS = 495e12 / 3
# each bad fixture of the port's analyzer, its rule and exact count (the
# CASES of tests/test_torch_analysis.py)
ANALYSIS_FIXTURES = ROOT / "tests" / "torch_analysis_fixtures"
ANALYSIS_CASES = {"rl001_bad.py": ("RL001", 11), "rl002_bad.py": ("RL002", 8),
                  "rl003_bad.py": ("RL003", 4), "rl004_bad.py": ("RL004", 5),
                  "kernels/rl005_bad.py": ("RL005", 4)}
# each CUDA source's tensor-core kernels: bf16 on mma.sync (route mma_sync)
# and on wgmma (route wgmma), float32 in 3xTF32 on mma.sync (route tf32x3);
# other float32 runs the CUDA-core kernel of the same source (cuda_cores)
MMA_KERNELS = {"flash_attention": "flash_fwd_mma_kernel", "ssd_scan": "ssd_scan_mma_kernel"}
WGMMA_KERNELS = {"flash_attention": "flash_fwd_wgmma_kernel", "ssd_scan": "ssd_scan_wgmma_kernel"}
TF32_KERNELS = {"flash_attention": "flash_fwd_tf32x3_kernel", "ssd_scan": "ssd_scan_tf32x3_kernel"}
# CUDA sources with no tensor-core work: their kernels (registers and spills
# printed; ptxas spills a few bytes in some instances off the main paths)
PLAIN_KERNELS = {"ssm_pointwise": ("ssm_conv_prep_kernel", "ssm_gated_norm_kernel"),
                 "moe_dispatch": ("moe_route_kernel", "moe_gather_kernel", "moe_glu_kernel",
                                  "moe_combine_kernel")}
SASS_OPS = ("HMMA", "HGMMA", "UTMALDG")   # mma.sync, wgmma, TMA loads
# each (kernel, route)'s CUDA function, as the profiler and cuobjdump name it
KERNEL_NAMES = {("K2", "wgmma"): "flash_fwd_wgmma_kernel",
                ("K2", "mma_sync"): "flash_fwd_mma_kernel",
                ("K2", "tf32x3"): "flash_fwd_tf32x3_kernel",
                ("K2", "cuda_cores"): "flash_fwd_kernel",
                ("K3", "wgmma"): "ssd_scan_wgmma_kernel",
                ("K3", "mma_sync"): "ssd_scan_mma_kernel",
                ("K3", "tf32x3"): "ssd_scan_tf32x3_kernel",
                ("K3", "cuda_cores"): "ssd_scan_kernel"}


def _timer(device):
    """ms per call of fn, averaged over n calls after warm-up: CUDA events
    on the card, perf_counter on the CPU."""
    def timed(fn, n=50, warm=5):
        for _ in range(warm):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                fn()
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b) / n
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n
    return timed


def _device_kernel_us(fn, n):
    """{kernel name: device microseconds per call of fn} over n calls, from
    torch.profiler's CUDA activity; {} when the profiler sees no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / n for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def _kernel_times(device, tag, kname, call, plain, library=None, n=50):
    """Per-call ms of a kernel's wrapper, its plain version and the library
    call: CUDA events over n back-to-back calls (host clock on the CPU);
    then, where the profiler sees device time, the kernel's own device time
    and the summed device time of the plain version's (and the library
    call's) kernels. Returns (kernel, plain, library-or-None)."""
    fns = {"kernel": call, "plain": plain}
    if library is not None:
        fns["library"] = library
    timed = _timer(device)
    out = {k: timed(f, n=n) for k, f in fns.items()}
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    print(f"{tag} per call ({clock}, {n} back-to-back calls, wrapper included): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()))
    if device.type == "cuda":
        dev = {k: _device_kernel_us(f, 20) for k, f in fns.items()}
        own = [v for name, v in dev["kernel"].items() if kname in name]
        if own and all(dev.values()):
            out = {k: sum(d.values()) / 1e3 for k, d in dev.items()}
            others = out["kernel"] - own[0] / 1e3
            out["kernel"] = own[0] / 1e3
            print(f"{tag} device time (torch.profiler): kernel {out['kernel']:.4f} ms "
                  f"(the wrapper's other kernels {others:.4f} ms), "
                  + ", ".join(f"{k} {v:.4f} ms over {len(dev[k])} kernels"
                              for k, v in out.items() if k != "kernel"))
        else:
            print(f"{tag} device time: the profiler saw no device time; CUDA-event times kept")
    return out["kernel"], out["plain"], out.get("library")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def phase_device(device):
    if device.type != "cuda":
        print("device: cpu rehearsal (plain versions; no card numbers)")
        return "cpu", 0
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"device: {name} (count {count}); torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for float32 matmuls and cuDNN convolutions; bf16 reduced-precision "
          f"reductions allowed: "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    return name, count


def _k1_inputs(gen, device, R, m, d, r, noise, err):
    f32 = torch.float32
    n = lambda *s: torch.randn(s, generator=gen, device=device, dtype=f32)
    u = lambda lo, hi, *s: torch.rand(s, generator=gen, device=device, dtype=f32) * (hi - lo) + lo
    kw = {}
    if noise:
        kw.update(s=u(0.0, 0.2, R), noise=n(R, m, d))
    if err:
        kw["err_coeffs"] = n(R, r) * 0.1
    return (n(R, m, d), n(r, R, m, d), u(0.5, 1.0, R), n(R, r)), kw


def phase_k1(device):
    """K1 against its plain version, stacked vs solo, then timed."""
    from repro_torch.kernels import deis_step as K
    from repro_torch.kernels import ref
    gen = torch.Generator(device=device).manual_seed(1234)
    max_err, cases = 0.0, 0
    for r in (1, 2, 3, 4):
        for noise in (False, True):
            for err in (False, True):
                for R, m, d in ((1, 70, 33), (5, 70, 33), (5, 3, 1031),
                                (2, 128, 2048)):
                    args, kw = _k1_inputs(gen, device, R, m, d, r, noise, err)
                    out, e = K.fused_ab_step(*args, **kw)
                    want, want_e = ref.fused_ab_step_ref(*args, **kw)
                    _sync(device)
                    torch.testing.assert_close(out, want, rtol=K1_TOL, atol=K1_TOL)
                    max_err = max(max_err, (out - want).abs().max().item())
                    if err:
                        torch.testing.assert_close(e, want_e, rtol=K1_TOL, atol=K1_TOL)
                        max_err = max(max_err, (e - want_e).abs().max().item())
                    if R > 1:   # a stacked row is bitwise its solo call
                        x, hist, psi, C = args
                        for i in range(R):
                            sl = slice(i, i + 1)
                            kw_i = {k: v[sl] for k, v in kw.items()}
                            o_i, e_i = K.fused_ab_step(
                                x[sl].contiguous(), hist[:, sl].contiguous(),
                                psi[sl], C[sl], **kw_i)
                            if not torch.equal(o_i[0], out[i]):
                                raise AssertionError(f"K1 stacked row {i} != solo (r={r})")
                            if err and not torch.equal(e_i[0], e[i]):
                                raise AssertionError(f"K1 stacked err {i} != solo (r={r})")
                    cases += 1
    # the one-shot path: an unstacked plan runs as one row of batch x seq
    for d in (384, 2048, 2560, 4096):   # whisper-tiny, gemma-2b and paligemma-3b,
                                        # mamba2-2.7b, mixtral-8x7b
        for r in (1, 2, 3):         # tab3's warm-up and full orders
            args, kw = _k1_inputs(gen, device, 1, 4 * 256, d, r, False, False)
            out, _ = K.fused_ab_step(*args, **kw)
            want, _ = ref.fused_ab_step_ref(*args, **kw)
            _sync(device)
            torch.testing.assert_close(out, want, rtol=K1_TOL, atol=K1_TOL)
            max_err = max(max_err, (out - want).abs().max().item())
            cases += 1
    print(f"K1 check: {cases} cases (r 1..4 x noise x err x (R, M, D) in "
          f"(1|5, 70, 33), (5, 3, 1031), (2, 128, 2048); the one-shot path's "
          f"(1, 1024, 384|2048|2560|4096) at r 1..3) within rtol=atol={K1_TOL}, "
          f"max abs err {max_err:.3e}; stacked rows bitwise equal to solo calls")

    # the main path's shape: a group of 8 rows at seq 256, d_model 2048, r=3
    R, m, d, r = 8, 256, 2048, 3
    args, kw = _k1_inputs(gen, device, R, m, d, r, False, True)
    n_it = 200 if device.type == "cuda" else 5
    call = lambda: K.fused_ab_step(*args, **kw)
    plain = lambda: ref.fused_ab_step_ref(*args, **kw)
    out, e = call()
    want, want_e = plain()
    torch.testing.assert_close(out, want, rtol=K1_TOL, atol=K1_TOL)
    torch.testing.assert_close(e, want_e, rtol=K1_TOL, atol=K1_TOL)
    max_err = max(max_err, (out - want).abs().max().item(),
                  (e - want_e).abs().max().item())
    # each input read once, each output written once (x, r history slices,
    # the (R, 1 + 2r) float32 scalars in; x' and err out)
    nbytes = (r + 2) * R * m * d * 4 + R * (1 + 2 * r) * 4 + R * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ms, plain_ms, _ = _kernel_times(
        device, f"K1 at R={R} M={m} D={d} r={r} with err", "fused_ab_kernel",
        call, plain, n=n_it)
    if device.type == "cuda":
        print(f"K1 bound / time = {bound_ms / ms:.3f}")
    print(f"K1 byte bound {bound_ms:.4f} ms ({nbytes} B at 3.35 TB/s), "
          "library call: none")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bytes=nbytes, shape=(R, m, d, r))


def _ptxas_report(log):
    """{entry function: [registers, spill store bytes, spill load bytes]}
    from nvcc's ``-Xptxas -v`` output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = out.setdefault(m.group(1), [None, 0, 0])
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur[1:] = int(m.group(1)), int(m.group(2))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur[0] = int(m.group(1))
    return out


def _sass_mma_counts(lib):
    """{entry function: {"HMMA": n, "HGMMA": n, "UTMALDG": n}}: its mma.sync
    and wgmma instructions and its TMA loads in SASS, read with ``cuobjdump
    -sass`` from the built library."""
    tool = shutil.which("cuobjdump") or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
                                            / "bin" / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out[m.group(1)] = dict.fromkeys(SASS_OPS, 0)
        elif cur is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    cur[op] += 1
    return out


def _short(mangled):
    """flash_fwd_mma_kernel<256> from its mangled name."""
    m = re.search(r"(flash_fwd_wgmma_kernel|flash_fwd_mma_kernel|flash_fwd_tf32x3_kernel|"
                  r"flash_fwd_kernel|ssd_scan_wgmma_kernel|ssd_scan_mma_kernel|"
                  r"ssd_scan_tf32x3_kernel|ssd_scan_kernel|ssm_conv_prep_kernel|"
                  r"ssm_gated_norm_kernel)(?:ILi(\d+)E)?",
                  mangled)
    return (f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)) if m else mangled


def phase_build(device):
    """nvcc builds of K2 and K3, started together; each kernel's registers
    and spills from ptxas's report and its HMMA, HGMMA and UTMALDG counts
    from its SASS. Raises if an mma.sync or 3xTF32 kernel has no HMMA, a
    wgmma kernel no HGMMA or no UTMALDG, or any of them spills. Returns
    {kernel: [registers, spill stores, spill loads, counts]}."""
    if device.type != "cuda":
        print("build: skipped on the cpu (no nvcc; the plain versions run)")
        return {}
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build(list(MMA_KERNELS) + list(PLAIN_KERNELS))
    print(f"build: {', '.join(str(p.relative_to(p.parents[2])) for p in paths.values())} "
          f"in {time.perf_counter() - t0:.1f} s (nvcc for sm_90a, one process per source)")
    out, faults = {}, []
    for name, lib in paths.items():
        log = build.log_path(name)
        text = log.read_text() if log.exists() else ""
        regs = _ptxas_report(text)
        ops = _sass_mma_counts(lib)
        for fn, count in sorted(ops.items(), key=lambda kv: _short(kv[0])):
            r = regs.get(fn, [None, None, None])
            out[_short(fn)] = [*r, count]
            print(f"  {name}: {_short(fn)}: {r[0]} registers, spill stores {r[1]} B, "
                  f"spill loads {r[2]} B; SASS: " + ", ".join(f"{op} {n}" for op, n in count.items()))
            if name in PLAIN_KERNELS:        # no tensor-core work: printed, not held
                continue
            need = (("HMMA",) if MMA_KERNELS[name] in fn or TF32_KERNELS[name] in fn else
                    ("HGMMA", "UTMALDG") if WGMMA_KERNELS[name] in fn else ())
            if need and (any(count[op] == 0 for op in need) or r[1] or r[2]):
                faults.append(f"{_short(fn)}: {count}, spills {r[1]}/{r[2]} B (needs "
                              f"{', '.join(need)} and no spills)")
        if name in PLAIN_KERNELS:
            if not all(any(k in fn for fn in ops) for k in PLAIN_KERNELS[name]):
                faults.append(f"{name}: not every one of {PLAIN_KERNELS[name]} was built")
            continue
        for kind in (MMA_KERNELS, WGMMA_KERNELS, TF32_KERNELS):
            if not any(kind[name] in fn for fn in ops):
                faults.append(f"{name}: no {kind[name]} in the built library")
        # ptxas drops setmaxnreg it cannot place (warning C7508): the consumer
        # warpgroups would then run on the producer's share of registers
        faults += [f"{name}: {ln.strip()}" for ln in text.splitlines() if "setmaxnreg" in ln]
    if faults:
        raise AssertionError("; ".join(faults))
    return out


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _bound(nbytes, flops, flop_rate):
    """The least time (ms) for the work, and whether bytes or operations set it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _route_counts():
    from repro_torch.kernels import flash_attention, ssd_scan
    return dict(K2=dict(flash_attention.flash_attention.route_launches),
                K3=dict(ssd_scan.ssd_scan.route_launches))


def _unaligned(t):
    """A contiguous copy of t whose data starts one element (2 bytes in bf16,
    4 in float32) past a 16-byte line (neither TMA nor 16-byte cp.async can
    copy it: the mma_sync and cuda_cores routes)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _turns(device, tag, calls, reps=3):
    """ms per call of each of ``calls`` ({name: (fn, kernel name or None)}),
    timed in turns (the order reversed every other round), median of
    ``reps``: on the card the named kernel's own device time, or the sum of
    a call's kernels where no name is given (torch.profiler; CUDA events over
    50 back-to-back calls where the profiler sees none); the host clock on
    the CPU."""
    timed = _timer(device)
    got = {k: [] for k in calls}
    names = list(calls)
    for i in range(reps):
        for k in (names if i % 2 == 0 else names[::-1]):
            fn, kname = calls[k]
            if device.type != "cuda":
                got[k].append(timed(fn, n=2, warm=1))
                continue
            dev = _device_kernel_us(fn, 20)
            us = [v for name, v in dev.items() if kname is None or kname in name]
            got[k].append(sum(us) / 1e3 if us else timed(fn, n=50))
    out = {k: float(np.median(v)) for k, v in got.items()}
    clock = "device time, torch.profiler" if device.type == "cuda" else "host clock"
    print(f"{tag} per call ({clock}; in turns, median of {reps}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()))
    return out


def _routed(device, kernel):
    """launch(*args, route) for K2 ("flash_attention") or K3 ("ssd_scan"):
    the wrapper's ``_launch`` on the route asked for on the card, the plain
    version on the CPU (which has no kernel)."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SS
    mod = FA if kernel == "flash_attention" else SS
    if device.type != "cuda":
        if mod is FA:
            return lambda q, k, v, causal, window, route, scale=None: ref.flash_attention_ref(
                q, k, v, causal=causal, window=window, scale=scale)
        return lambda x, a, B, C, chunk, route: ref.ssd_scan_ref(x, a, B, C, chunk=chunk)
    fn = build.entry(kernel, f"{kernel}_fwd", mod.ARGTYPES)
    return lambda *args, **kw: mod._launch(fn, *args[:-1],
                                           torch.cuda.current_stream().cuda_stream, args[-1], **kw)


def phase_k2(device):
    """K2 against its plain version over the JAX test shapes, cross
    attention, a causal window at D 256 and the full widths of gemma-2b
    (MQA 8/1, D 256), mixtral-8x7b (GQA 32/8, D 128, window 4096),
    whisper-tiny (6/6, D 64), paligemma-3b (MQA 8/1, D 256 at S 512),
    glm4-9b (GQA 32/2, D 128) and granite-4.0-h-small (GQA 32/8, D 128 at
    its cell's B 16, softmax scale 1/128, not 1/sqrt(D)), and
    cifar10-scorenet's (4/4, D 64): float32
    on its own route (tf32x3), on cuda_cores asked for and as unaligned views
    (cuda_cores); bf16 on its own route (wgmma; mma_sync at D 32), on
    mma_sync asked for and as unaligned views (mma_sync); the route counts
    asserted. Then at those models' shapes, in turns: the wgmma kernel, the
    mma_sync kernel, the plain version and SDPA in bf16; the tf32x3 kernel,
    the CUDA-core kernel, the plain version and SDPA in float32 (cifar10's
    in float32 only). Returns {model: {route: numbers}}."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ref
    launch = _routed(device, "flash_attention")
    gen = torch.Generator(device=device).manual_seed(2)
    cases = [(2, 64, 64, 4, 4, 32, True, 0), (1, 128, 128, 8, 2, 64, True, 0),
             (2, 96, 96, 4, 1, 32, True, 0), (1, 64, 64, 4, 4, 32, False, 0),
             (1, 128, 128, 4, 2, 32, True, 32),       # the JAX kernel tests' five
             (2, 40, 104, 4, 2, 64, True, 16),        # cross attention, Sq != Sk
             (2, 200, 200, 8, 1, 256, True, 64)]      # causal, window, D 256
    full = {"gemma": (4, 256, 256, 8, 1, 256, False, 0),
            "mixtral": (4, 256, 256, 32, 8, 128, False, 4096),
            "whisper": (4, 256, 256, 6, 6, 64, False, 0),
            "paligemma": (4, 512, 512, 8, 1, 256, False, 0),
            "glm4": (4, 256, 256, 32, 2, 128, False, 0),
            "granite": (16, 256, 256, 32, 8, 128, False, 0),
            "cifar10": (4, 256, 256, 4, 4, 64, False, 0)}
    # the logits' scale where a model's is not 1/sqrt(D): granite's attention_multiplier
    scales = {"granite": 1 / 128}
    max_err = dict.fromkeys(K.ROUTES, 0.0)
    want_routes = dict.fromkeys(K.ROUTES, 0)
    n_cases = 0
    _reset_counts()
    for dtype in (torch.float32, torch.bfloat16):
        for case in cases + list(full.values()):
            b, sq, sk, h, kv, d, causal, window = case
            model = next((m for m, shape in full.items() if shape == case), None)
            scale = scales.get(model)
            rnd = lambda *sh: torch.randn(sh, generator=gen, device=device).to(dtype)
            q, k, v = rnd(b, sq, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, d)
            want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
            own = K.route(q, k, v)
            runs = [(own, lambda: K.flash_attention(q, k, v, causal=causal, window=window,
                                                    scale=scale))]
            # the kernel that takes any operand of the dtype (mma_sync, cuda_cores):
            # asked for, and on unaligned views
            other = "mma_sync" if dtype == torch.bfloat16 else "cuda_cores"
            runs += [(other, lambda: launch(q, k, v, causal, window, other, scale=scale)),
                     (other, lambda: K.flash_attention(
                         _unaligned(q), _unaligned(k), _unaligned(v), causal=causal,
                         window=window, scale=scale))]
            tol = ref.K2_TOL[dtype]
            for route, run in runs:
                got = run()
                _sync(device)
                torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
                err = _max_err(got, want)
                max_err[route] = max(max_err[route], err)
                want_routes[route] += 1
                n_cases += 1
                if model is not None:
                    top = want.float().abs().max().item()
                    print(f"K2 at {model}'s full width {b}x{sq}x{h}/{kv}x{d} window {window} "
                          f"scale {scale or 1 / d ** 0.5:.6g} in "
                          f"{str(dtype)[6:]} ({route}): max abs err {err:.3e} within "
                          f"{tol}, max |want| {top:.3e} (ratio {err / top:.3e})")
    routes = _route_counts()["K2"]
    if device.type == "cuda" and routes != want_routes:
        raise AssertionError(f"K2 checks took the routes {routes}, not {want_routes}")
    print(f"K2 check: {n_cases} runs (the JAX tests' 5 shapes, cross attention 40x104, "
          f"causal window 64 at D 256, gemma 4x256x8/1x256, mixtral 4x256x32/8x128, whisper "
          f"4x256x6/6x64, paligemma 4x512x8/1x256, glm4 4x256x32/2x128, granite "
          f"16x256x32/8x128 at scale 1/128 and cifar10 4x256x4/4x64: float32 within 2e-5 on its own route (tf32x3), on cuda_cores asked "
          f"for and as unaligned views; bf16 within 2e-2 on its own route, on mma_sync asked "
          f"for and as unaligned views), max abs err "
          + ", ".join(f"{r} {e:.3e}" for r, e in max_err.items())
          + f"; routes {routes}")

    out = {}
    for model, (b, sq, sk, h, kv, d, causal, window) in full.items():
        scale = scales.get(model)
        for dtype in (torch.bfloat16, torch.float32):
            if model == "cifar10" and dtype == torch.bfloat16:
                continue   # a float32 model
            rnd = lambda *sh: torch.randn(sh, generator=gen, device=device).to(dtype)
            q, k, v = rnd(b, sq, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, d)
            plain = lambda: ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                                    scale=scale)
            # the window (4096 at most) spans the whole sequence of 512 keys at most:
            # SDPA computes the same function without it
            library = lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), enable_gqa=True,
                scale=scale)
            lib_err = _max_err(library().transpose(1, 2), plain())
            kernels = ("wgmma", "mma_sync") if dtype == torch.bfloat16 else ("tf32x3", "cuda_cores")
            calls = {r: ((lambda r=r: launch(q, k, v, causal, window, r, scale=scale)),
                         KERNEL_NAMES["K2", r]) for r in kernels}
            calls.update(plain=(plain, None), library=(library, None))
            t = _turns(device, f"K2 at {model}'s shape B={b} S={sq} H={h} KV={kv} D={d} "
                       f"{str(dtype)[6:]}", calls)
            # each input read once, the output written once; QK^T and PV over the
            # unmasked (query, key) pairs (all of them here: bidirectional)
            nbytes = q.element_size() * (q.numel() + k.numel() + v.numel() + q.numel())
            flops = 2 * 2 * b * h * sq * sk * d
            row = dict(plain_ms=t["plain"], library_ms=t["library"],
                       **_bounds(f"K2 at {model}'s shape in {str(dtype)[6:]}", dtype, nbytes,
                                 flops, t, kernels))
            print(f"K2 at {model}'s shape in {str(dtype)[6:]}: "
                  + ", ".join(f"{r} {t[r] / t['library']:.2f}x SDPA" for r in kernels)
                  + f"; SDPA (enable_gqa) differs from the plain version by {lib_err:.3e}")
            for r in kernels:
                out.setdefault(model, {})[r] = dict(row, max_abs_err=max_err[r], ms=t[r])
    return out


def _bounds(tag, dtype, nbytes, flops, t, kernels):
    """The least time of the work (bytes at 3.35 TB/s or operations at the
    card's rate), printed with each kernel's share of it: bf16 at 989
    TFLOP/s; float32 at 165 TFLOP/s (3xTF32 on the tensor cores: the bound
    reported) and beside it at 67 TFLOP/s (the CUDA cores)."""
    rates = {"bound": BF16_FLOPS} if dtype == torch.bfloat16 else \
        {"bound": TF32X3_FLOPS, "bound_cuda_cores": FP32_FLOPS}
    row = {}
    for key, rate in rates.items():
        ms, by = _bound(nbytes, flops, rate)
        row[f"{key}_ms"] = ms
        if key == "bound":
            row["bound_by"] = by
        print(f"{tag}: {key.replace('_', ' ')} {ms:.5f} ms by {by} ({nbytes} B at 3.35 TB/s, "
              f"{flops} FLOP at {rate / 1e12:.0f} TFLOP/s); "
              + ", ".join(f"{r} {ms / t[r]:.3f} of it" for r in kernels))
    return row


def phase_k3(device):
    """K3 against its plain version over the JAX test shapes, three chunks
    with a padded tail and mamba2's full width: float32 on its own route
    (tf32x3), on cuda_cores asked for and as unaligned views; bf16 on its own
    route (wgmma), on mma_sync asked for and as unaligned views; the route
    counts asserted. Then at mamba2's shape, in turns: the wgmma kernel, the
    mma_sync kernel and the plain version in bf16, the tf32x3 kernel, the
    CUDA-core kernel and the plain version in float32. Returns {route:
    numbers}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as K
    launch = _routed(device, "ssd_scan")
    gen = torch.Generator(device=device).manual_seed(3)
    cases = [(2, 64, 2, 16, 8, 16), (1, 96, 3, 8, 16, 32), (1, 50, 2, 16, 8, 16),
             (2, 32, 1, 32, 32, 32),                  # the JAX kernel tests' four
             (2, 600, 4, 64, 128, 256)]               # three chunks, the last padded
    mamba = (4, 256, 80, 64, 128, 256)

    def inputs(b, s, h, p, n, dtype):
        rnd = lambda *sh: torch.randn(sh, generator=gen, device=device)
        a = torch.rand((b, s, h), generator=gen, device=device) * 0.299 + 0.7
        return rnd(b, s, h, p).to(dtype), a, rnd(b, s, n).to(dtype), rnd(b, s, n).to(dtype)

    max_err = dict.fromkeys(K.ROUTES, 0.0)
    want_routes = dict.fromkeys(K.ROUTES, 0)
    n_cases = 0
    _reset_counts()
    for dtype in (torch.float32, torch.bfloat16):
        for (b, s, h, p, n, chunk) in cases + [mamba]:
            x, a, B, C = inputs(b, s, h, p, n, dtype)
            y_w, st_w = ref.ssd_scan_ref(x, a, B, C, chunk=chunk)
            own = K.route(x, B, C)
            runs = [(own, lambda: K.ssd_scan(x, a, B, C, chunk=chunk))]
            # the kernel that takes any operand of the dtype (mma_sync, cuda_cores):
            # asked for, and on unaligned views
            other = "mma_sync" if dtype == torch.bfloat16 else "cuda_cores"
            runs += [(other, lambda: launch(x, a, B, C, chunk, other)),
                     (other, lambda: K.ssd_scan(_unaligned(x), a, _unaligned(B),
                                                _unaligned(C), chunk=chunk))]
            tol = ref.K3_TOL[dtype]
            for route, run in runs:
                y, st = run()
                _sync(device)
                for got, want in ((y.float(), y_w.float()), (st, st_w)):
                    atol = tol
                    if dtype == torch.float32 and (p, n, chunk) == mamba[3:]:   # mamba2's widths
                        atol = max(tol, ref.K3_F32_SCALE * want.abs().max().item())
                    torch.testing.assert_close(got, want, rtol=tol, atol=atol)
                max_err[route] = max(max_err[route], _max_err(y, y_w), _max_err(st, st_w))
                want_routes[route] += 1
                n_cases += 1
                if (b, s, h, p, n, chunk) == mamba:
                    top = y_w.float().abs().max().item()
                    err = _max_err(y, y_w)
                    print(f"K3 at mamba2's full width in {str(dtype)[6:]} ({route}): y max "
                          f"abs err {err:.3e}, max |want| {top:.3e} (ratio {err / top:.3e}); "
                          f"state max abs err {_max_err(st, st_w):.3e}, max |want| "
                          f"{st_w.abs().max().item():.3e}")
    routes = _route_counts()["K3"]
    if device.type == "cuda" and routes != want_routes:
        raise AssertionError(f"K3 checks took the routes {routes}, not {want_routes}")
    print(f"K3 check: {n_cases} runs (the JAX tests' 4 shapes, 2x600x4x64 N 128 in three "
          f"chunks of 256 and mamba2 4x256x80x64, N 128, chunk 256: float32 within 2e-4 "
          f"(mamba2's widths: atol {ref.K3_F32_SCALE} x max|want|) on its own route (tf32x3), on "
          f"cuda_cores asked for and as unaligned views; bf16 within 5e-2 on its own route, on "
          f"mma_sync asked for and as unaligned views), max abs err "
          + ", ".join(f"{r} {e:.3e}" for r, e in max_err.items()) + f"; routes {routes}")

    b, s, h, p, n, chunk = mamba
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, a, B, C = inputs(b, s, h, p, n, dtype)
        kernels = ("wgmma", "mma_sync") if dtype == torch.bfloat16 else ("tf32x3", "cuda_cores")
        calls = {r: ((lambda r=r: launch(x, a, B, C, chunk, r)), KERNEL_NAMES["K3", r])
                 for r in kernels}
        calls["plain"] = (lambda: ref.ssd_scan_ref(x, a, B, C, chunk=chunk), None)
        t = _turns(device, f"K3 at mamba2's shape Bb=4 S=256 H=80 P=64 N=128 chunk 256 "
                   f"{str(dtype)[6:]}", calls)
        # x, a, B, C read once; y and the float32 state written once. Operations
        # the function needs per chunk: the lower triangle of C B^T (N each), once
        # per batch (B and C carry no head axis); per head, the lower triangle of
        # W x (P each), C h^T and x^T B (L N P each)
        es = x.element_size()
        nbytes = es * (x.numel() + B.numel() + C.numel() + x.numel()) + 4 * a.numel() \
            + 4 * b * h * p * n
        tri = chunk * (chunk + 1) // 2
        flops = b * (s // chunk) * 2 * tri * n \
            + b * h * (s // chunk) * (2 * tri * p + 2 * 2 * chunk * n * p)
        row = _bounds(f"K3 in {str(dtype)[6:]}", dtype, nbytes, flops, t, kernels)
        print("K3: library call: none")
        for r in kernels:
            out[r] = dict(row, max_abs_err=max_err[r], ms=t[r], plain_ms=t["plain"],
                          library_ms=None)
    return out


# the SSM mixer's passes: (Bb, S, H, P, N, K, extra columns of the in-projection,
# which make its row stride no multiple of 16 bytes: one-element accesses)
PW_CASES = [(16, 256, 80, 64, 128, 4, 0),    # mamba2-2.7b's one-shot shape
            (16, 256, 128, 64, 128, 4, 0),   # granite-4.0-h-small's one-shot shape
            (2, 48, 256, 64, 128, 4, 0),     # jamba-1.5-large's mixer widths
            (2, 40, 32, 16, 16, 4, 0),       # the reduced config
            (3, 2, 32, 16, 16, 4, 0),        # S < K - 1
            (2, 37, 8, 64, 128, 4, 1),       # S no multiple of the time tile, unaligned
            (2, 19, 5, 16, 16, 1, 3),        # K 1, unaligned
            (16, 256, 80, 64, 128, 4, 1)]    # the one-shot shape, unaligned


def _pw_inputs(device, b, s, h, p, n, k, extra, dtype, seed=29):
    """Views z, xBC, dt of an in-projection output drawn from a seed, and the
    mixer's parameters with y and xh for the norm."""
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *sh: torch.randn(sh, generator=gen, device=device)
    d_inner, c = h * p, h * p + 2 * n
    zx = r(b, s, d_inner + c + h + extra).to(dtype)
    z, xbc, dt = zx[..., :d_inner], zx[..., d_inner:d_inner + c], zx[..., d_inner + c:][..., :h]
    prm = dict(conv_w=(r(k, c) * 0.3).to(dtype), conv_b=(r(c) * 0.1).to(dtype),
               dt_bias=r(h), A_log=r(h) * 0.5, D=r(h), scale=(r(d_inner) * 0.1).to(dtype))
    y, xh = r(b, s, h, p).to(dtype), r(b, s, h, p).to(dtype)
    return z, xbc, dt, prm, y, xh


def phase_ssm_pointwise(device):
    """The SSM mixer's two passes (``ssm_conv_prep_kernel``,
    ``ssm_gated_norm_kernel``) against their plain versions over
    ``PW_CASES`` in float32 and bf16, on views of an in-projection output.
    ``pre``: xh, B and C within one rounding of the same sums in float64
    (bf16 rtol 2^-7, atol 1e-5; float32 1e-5), a within rtol 1e-5, and the
    largest difference from the plain chain (which rounds each product and
    sum) printed; ``post`` in both of its instantiations, norm then gate
    (mamba2's) and gate first (granite's): within one rounding of the plain
    version in the same order (same tolerances). Each launch counted. Then
    in bf16, in turns, each kernel and its plain version beside the byte
    bound: ``pre`` and ``post`` at mamba2-2.7b's one-shot shape,
    ``post_gate_first`` at granite-4.0-h-small's. Returns {"pre": numbers,
    "post": numbers, "post_gate_first": numbers}."""
    from repro_torch.kernels import ssm_pointwise as SP
    F = torch.nn.functional
    err = {"pre": 0.0, "pre_vs_chain": 0.0, "a": 0.0, "post": 0.0, "post_gate_first": 0.0}
    # the cpu rehearsal keeps to the small widths (plain versions against themselves)
    cases = PW_CASES if device.type == "cuda" else [c for c in PW_CASES if c[2] * c[3] <= 512]
    _reset_counts()
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = dict(rtol=2 ** -7, atol=1e-5) if dtype == torch.bfloat16 else \
            dict(rtol=1e-5, atol=1e-5)
        for (b, s, h, p, n, k, extra) in cases:
            z, xbc, dt, prm, y, xh_in = _pw_inputs(device, b, s, h, p, n, k, extra, dtype)
            args = (prm["conv_w"], prm["conv_b"], prm["dt_bias"], prm["A_log"])
            got = SP.conv_prep(xbc, dt, *args, head_dim=p)
            want = SP.conv_prep_ref(xbc, dt, *args, head_dim=p)
            xp = F.pad(xbc.double(), (0, 0, k - 1, 0))
            taps = [xp[:, i:i + s] * prm["conv_w"][i].double() for i in range(k)]
            exact = F.silu(sum(taps) + prm["conv_b"].double()).to(dtype)
            flat = lambda ts: torch.cat([t.reshape(b, s, -1) for t in ts], -1)
            if device.type == "cuda":       # on the cpu the plain chain stands in
                torch.testing.assert_close(flat(got[:3]).float(), exact.float(), **tol)
            # the plain chain rounds K products and K sums: within 1.1 (2K + 2) u
            # (sum_i |w_i x_i| + |b|) + 2 u |exact| of the kernel, u the unit roundoff
            u = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
            bound = 1.1 * (2 * k + 2) * u * (sum(t.abs() for t in taps)
                                               + prm["conv_b"].double().abs()) \
                + 2 * u * exact.double().abs()
            if not bool(((flat(got[:3]).double() - flat(want[:3]).double()).abs()
                         <= bound).all()):
                raise AssertionError(f"ssm pre {(b, s, h, p, n, k, extra)} {dtype}: beyond the "
                                     "plain chain's rounding")
            torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=0)
            for gate_first, key in ((False, "post"), (True, "post_gate_first")):
                out = SP.gated_norm(y, xh_in, z, prm["D"], prm["scale"], eps=1e-5,
                                    gate_first=gate_first)
                out_w = SP.gated_norm_ref(y, xh_in, z, prm["D"], prm["scale"], 1e-5,
                                          gate_first=gate_first)
                torch.testing.assert_close(out.float(), out_w.float(), **tol)
                err[key] = max(err[key], _max_err(out, out_w))
            err["pre"] = max(err["pre"], _max_err(flat(got[:3]), exact))
            err["pre_vs_chain"] = max(err["pre_vs_chain"], _max_err(flat(got[:3]),
                                                                    flat(want[:3])))
            err["a"] = max(err["a"], _max_err(got[3], want[3]))
            n_cases += 1
    counts = _counts()
    if device.type == "cuda" and (counts["ssm_pre"], counts["ssm_post"]) != (n_cases,
                                                                             2 * n_cases):
        raise AssertionError(f"ssm passes: launches {counts}, not {n_cases} pre and "
                             f"{2 * n_cases} post (both orders)")
    print(f"ssm passes check: {n_cases} cases (mamba2's and granite's one-shot shapes, jamba's "
          f"widths, the reduced config, S < K - 1, S 37, K 1, unaligned views; float32 and "
          f"bf16; post in both orders): max abs "
          + ", ".join(f"{k} {v:.3e}" for k, v in err.items()) + f"; launches {counts}")

    b, s, h, p, n, k, extra = PW_CASES[0] if device.type == "cuda" else cases[0]
    dtype = torch.bfloat16
    z, xbc, dt, prm, y, xh_in = _pw_inputs(device, b, s, h, p, n, k, extra, dtype)
    args = (prm["conv_w"], prm["conv_b"], prm["dt_bias"], prm["A_log"])
    calls = {"pre": (lambda: SP.conv_prep(xbc, dt, *args, head_dim=p), "ssm_conv_prep_kernel"),
             "pre_plain": (lambda: SP.conv_prep_ref(xbc, dt, *args, head_dim=p), None),
             "post": (lambda: SP.gated_norm(y, xh_in, z, prm["D"], prm["scale"], eps=1e-5),
                      "ssm_gated_norm_kernel"),
             "post_plain": (lambda: SP.gated_norm_ref(y, xh_in, z, prm["D"], prm["scale"],
                                                      1e-5), None)}
    t = _turns(device, f"ssm passes at Bb={b} S={s} H={h} P={p} N={n} K={k} bf16", calls)
    es, c, rows = 2, h * p + 2 * n, b * s
    # y, xh and z read once, the output written once (4 planes of rows x H P)
    post_bytes = lambda rows, h, p: rows * h * p * es * 4 + h * 4 + h * p * es
    nbytes = {"pre": rows * (c * es + h * es) + rows * (c * es + h * 4)
              + (k + 1) * c * es + 2 * h * 4,
              "post": post_bytes(rows, h, p)}

    b, s, h, p, n, k, extra = PW_CASES[1] if device.type == "cuda" else cases[0]
    z, xbc, dt, prm, y, xh_in = _pw_inputs(device, b, s, h, p, n, k, extra, dtype)
    calls = {"post_gate_first": (lambda: SP.gated_norm(y, xh_in, z, prm["D"], prm["scale"],
                                                       eps=1e-5, gate_first=True),
                                 "ssm_gated_norm_kernel"),
             "post_gate_first_plain": (lambda: SP.gated_norm_ref(
                 y, xh_in, z, prm["D"], prm["scale"], 1e-5, gate_first=True), None)}
    t.update(_turns(device, f"ssm post gate first at Bb={b} S={s} H={h} P={p} bf16", calls))
    nbytes["post_gate_first"] = post_bytes(b * s, h, p)
    out = {}
    for name in ("pre", "post", "post_gate_first"):
        row = _bounds(f"ssm {name}", dtype, nbytes[name], 0, t, (name,))
        out[name] = dict(row, max_abs_err=err[name], ms=t[name], plain_ms=t[f"{name}_plain"],
                         library_ms=None)
    return out


# the MoE kernels' shapes (B, S, E, k, C, d, f, dtype, rows alike): granite-4.0-h-small's
# and mixtral-8x7b's one-shot shapes (C = int(1.25 S k / E)), every token choosing
# the same experts at granite's, then small odd widths (4- and 2-byte accesses)
MOE_CASES = [(16, 256, 72, 10, 44, 4096, 768, torch.bfloat16, False),
             (4, 256, 8, 2, 80, 4096, 14336, torch.bfloat16, False),
             (16, 256, 72, 10, 44, 4096, 768, torch.bfloat16, True),
             (3, 70, 16, 4, 6, 33, 20, torch.float32, False),
             (2, 40, 6, 2, 13, 33, 7, torch.bfloat16, False)]
MOE_KEYS = ("moe_route", "moe_gather", "moe_glu", "moe_combine")


def _moe_inputs(device, b, s, e, k, c, d, f, dtype, alike, seed=31):
    """Router logits (B, S, E) float32 (every token's the same where
    ``alike``), x (B, S, d), the up and gate products (E, B C, f), the
    experts' outputs (E, B C, d) and a shared addend (B, S, d), from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *sh: torch.randn(sh, generator=gen, device=device)
    logits = r(1, 1, e).expand(b, s, e).contiguous() if alike else r(b, s, e)
    return (logits, r(b, s, d).to(dtype), (r(e, b * c, f) * 2).to(dtype),
            (r(e, b * c, f) * 2).to(dtype), r(e, b * c, d).to(dtype), r(b, s, d).to(dtype))


def phase_moe_dispatch(device):
    """The MoE layer's four kernels (``kernels/moe_dispatch.py``) against
    their plain versions over ``MOE_CASES``: ``moe_route``'s choices, places,
    slots, table and kept counts bitwise, its gates, gate sums and
    logsumexps within float32 rounding (rtol 1e-5); ``moe_gather`` bitwise;
    ``moe_glu`` within one rounding of its dtype (the share bitwise
    printed); ``moe_combine``, with and without the shared addend, within
    one rounding of its plain version's float32 sum. Each launch counted.
    Then in bf16 at granite-4.0-h-small's one-shot shape, in turns, each
    kernel and its plain version beside its byte bound. Returns {kernel:
    numbers}."""
    from repro_torch.kernels import moe_dispatch as MD
    cases = MOE_CASES if device.type == "cuda" else [c for c in MOE_CASES if c[5] < 64]
    _reset_counts()
    err = dict.fromkeys(("gate_vals", "gather", "glu", "combine"), 0.0)
    same = []
    for (b, s, e, k, c, d, f, dtype, alike) in cases:
        logits, x, h, g, out_e, add = _moe_inputs(device, b, s, e, k, c, d, f, dtype, alike)
        r, rw = MD.route(logits, top_k=k, cap=c), MD.route_ref(logits, top_k=k, cap=c)
        for key in ("gate_idx", "pos", "slot", "table", "kept"):
            if not torch.equal(r[key], rw[key]):
                raise AssertionError(f"moe_route {(b, s, e, k, c)}: {key} differs from the "
                                     "plain version's")
        for key in ("gate_vals", "gate_sum", "lse"):
            torch.testing.assert_close(r[key], rw[key], rtol=1e-5, atol=1e-6)
        err["gate_vals"] = max(err["gate_vals"], _max_err(r["gate_vals"], rw["gate_vals"]))
        if not torch.equal(MD.gather(x, r["table"]), MD.gather_ref(x, r["table"])):
            raise AssertionError(f"moe_gather {(b, e, c, d, dtype)}: not bitwise")
        one = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -21   # one unit in the last place
        a, aw = MD.glu(h, g), MD.glu_ref(h, g)
        torch.testing.assert_close(a.float(), aw.float(), rtol=one, atol=1e-30)
        same.append((a == aw).float().mean().item())
        err["glu"] = max(err["glu"], _max_err(a, aw))
        for extra in (add, None):
            o = MD.combine(out_e, r["slot"], r["gate_vals"], extra)
            ow = MD.combine_ref(out_e, r["slot"], r["gate_vals"], extra)
            torch.testing.assert_close(o.float(), ow.float(), rtol=one,
                                       atol=1e-5 * out_e.abs().max().item())
            err["combine"] = max(err["combine"], _max_err(o, ow))
    counts = _counts()
    want = dict(moe_route=len(cases), moe_gather=len(cases), moe_glu=len(cases),
                moe_combine=2 * len(cases))
    if device.type == "cuda" and {key: counts[key] for key in MOE_KEYS} != want:
        raise AssertionError(f"moe kernels: launches {counts}, not {want}")
    print(f"moe kernels check: {len(cases)} cases (granite's and mixtral's one-shot shapes, "
          f"every token on the same experts, odd widths; float32 and bf16): route bitwise in "
          f"its choices, places, slots and table; gather bitwise; glu bitwise in "
          f"{min(same):.4f}-{max(same):.4f} of its outputs; max abs "
          + ", ".join(f"{key} {v:.3e}" for key, v in err.items()) + f"; launches {counts}")

    b, s, e, k, c, d, f, dtype, alike = cases[0]
    logits, x, h, g, out_e, add = _moe_inputs(device, b, s, e, k, c, d, f, dtype, alike)
    r = MD.route(logits, top_k=k, cap=c)
    calls = {"moe_route": (lambda: MD.route(logits, top_k=k, cap=c), "moe_route_kernel"),
             "moe_route_plain": (lambda: MD.route_ref(logits, top_k=k, cap=c), None),
             "moe_gather": (lambda: MD.gather(x, r["table"]), "moe_gather_kernel"),
             "moe_gather_plain": (lambda: MD.gather_ref(x, r["table"]), None),
             "moe_glu": (lambda: MD.glu(h, g), "moe_glu_kernel"),
             "moe_glu_plain": (lambda: MD.glu_ref(h, g), None),
             "moe_combine": (lambda: MD.combine(out_e, r["slot"], r["gate_vals"], add),
                             "moe_combine_kernel"),
             "moe_combine_plain": (lambda: MD.combine_ref(out_e, r["slot"], r["gate_vals"],
                                                          add), None)}
    t = _turns(device, f"moe kernels at B={b} S={s} E={e} k={k} C={c} d={d} f={f} "
               f"{str(dtype)[6:]}", calls)
    es, slots, pairs = x.element_size(), e * b * c, b * s * k
    kept = int(r["kept"].sum())
    # each input read once and each output written once; the combine reads
    # only the kept slots' rows, plus the shared addend
    nbytes = {"moe_route": b * s * e * 4 + pairs * 20 + slots * 4 + b * e * 8 + b * s * 4,
              "moe_gather": slots * d * es + b * s * d * es + slots * 4,
              "moe_glu": 3 * slots * f * es,
              "moe_combine": kept * d * es + pairs * 8 + 2 * b * s * d * es}
    names = {"moe_route": "gate_vals", "moe_gather": "gather", "moe_glu": "glu",
             "moe_combine": "combine"}
    out = {}
    for name in MOE_KEYS:
        row = _bounds(name, dtype, nbytes[name], 0, t, (name,))
        out[name] = dict(row, max_abs_err=err[names[name]], ms=t[name],
                         plain_ms=t[f"{name}_plain"], library_ms=None)
    return out


def phase_scaling(device, routes=("wgmma", "mma_sync"), reps=3):
    """The bf16 K2 and K3 kernels of ``routes`` at the main paths' widths
    and at larger grids, in turns: K2 at B 4, 8, 16, 32 of gemma's (MQA 8/1,
    D 256) and whisper's (6/6, D 64) shapes, K3 at Bb 4, 8, 16 of mamba2's.
    Each kernel's device time per launch and its ratio to B 4 beside the
    work's: a ratio well under the work's means a thin grid at B 4
    (latency, not throughput). Returns {(kernel, route, (model, B)): ms}."""
    if device.type != "cuda":
        print("scaling: skipped on the cpu (no device times)")
        return {}
    fa, ss = _routed(device, "flash_attention"), _routed(device, "ssd_scan")
    gen = torch.Generator(device=device).manual_seed(21)
    rnd = lambda *sh: torch.randn(sh, generator=gen, device=device).to(torch.bfloat16)
    out = {}
    for model, (h, kv, d) in (("gemma", (8, 1, 256)), ("whisper", (6, 6, 64))):
        for b in (4, 8, 16, 32):
            q, k, v = rnd(b, 256, h, d), rnd(b, 256, kv, d), rnd(b, 256, kv, d)
            t = _turns(device, f"scaling K2 at {model}'s shape B {b}", {
                r: ((lambda r=r: fa(q, k, v, False, 0, r)), KERNEL_NAMES["K2", r])
                for r in routes}, reps)
            out.update({("K2", r, (model, b)): ms for r, ms in t.items()})
    for b in (4, 8, 16):
        x, B, C = rnd(b, 256, 80, 64), rnd(b, 256, 128), rnd(b, 256, 128)
        a = torch.rand((b, 256, 80), generator=gen, device=device) * 0.299 + 0.7
        t = _turns(device, f"scaling K3 at mamba2's shape Bb {b}", {
            r: ((lambda r=r: ss(x, a, B, C, 256, r)), KERNEL_NAMES["K3", r]) for r in routes}, reps)
        out.update({("K3", r, ("mamba2", b)): ms for r, ms in t.items()})
    for (kernel, r, (model, b)), ms in out.items():
        base = out[kernel, r, (model, 4)]
        print(f"scaling {kernel} ({r}) at {model}'s shape, B {b}: {ms:.4f} ms; x{ms / base:.2f} "
              f"the time of B 4 for x{b / 4:.0f} the work")
    return out


def phase_stress(device, counts=(("wgmma", 6000), ("tf32x3", 2000)), seed=24):
    """Each route of ``counts`` of K3 and K2 launched that many times over
    the stress tool's shapes in turn, a sync after each, every output
    bitwise the first launch's at its shape. Raises on a fault or a wrong
    output (a fault leaves the CUDA context unusable: the run ends there).
    Returns {(kernel, route): the tool's numbers}."""
    if device.type != "cuda":
        print("stress: skipped on the cpu (no kernels)")
        return {}
    sys.path.insert(0, str(ROOT / "tools"))
    import kernel_stress
    t0 = time.perf_counter()
    out = {}
    for route, n in counts:
        for kernel in ("ssd_scan", "flash_attention"):
            r = kernel_stress.stress(kernel, route, n, seed)
            bad = r["fault"] or r["wrong"]
            print(f"stress {kernel} {route}: {r['launches']} launches clean of {n} in "
                  f"{r['seconds']:.2f} s ({r['rate']:.0f} launches/s; shapes "
                  f"{list(kernel_stress.SHAPES[kernel])} in turn)" + (f"; {bad}" if bad else ""))
            if bad:
                raise AssertionError(f"stress {kernel} {route}: {bad}")
            out[kernel, route] = r
    print(f"stress: {sum(r['launches'] for r in out.values())} launches in "
          f"{time.perf_counter() - t0:.1f} s (phase wall)")
    return out


def _requests(Request):
    """Wave 1 and wave 2 of the served mix: ddim, tab3, dpm2m, sndeis2,
    seeds2 (stochastic) and rho_heun (rk); NFE 6-10, seq_len 96-256. The
    ddim rows carry no error pair, so they never exit early: request 1
    finishes at its own 6th step while request 0 runs on, and request 7
    (wave 2, same family and bucket) joins their group."""
    wave1 = [Request(uid=0, solver="ddim", nfe=8, seq_len=100, seed=10),
             Request(uid=1, solver="ddim", nfe=6, seq_len=128, seed=11),
             Request(uid=2, solver="tab3", nfe=8, seq_len=256, seed=12),
             Request(uid=3, solver="dpm2m", nfe=8, seq_len=256, seed=13),
             Request(uid=4, solver="sndeis2", nfe=10, seq_len=200, seed=14),
             Request(uid=5, solver="seeds2", nfe=8, seq_len=256, seed=15),
             Request(uid=6, solver="rho_heun", nfe=8, seq_len=128, seed=16)]
    wave2 = [Request(uid=7, solver="ddim", nfe=6, seq_len=96, seed=17),
             Request(uid=8, solver="tab3", nfe=6, seq_len=240, seed=18)]
    return wave1, wave2


def _serve_waves(eng, Request, methods):
    """Wave 1 at once; wave 2 right after request 1's Result comes back, so
    request 7 reaches the next boundary while request 1's row is free (a
    join). Returns (results, ab group steps, wall seconds)."""
    wave1, wave2 = _requests(Request)
    ab_steps = [0]

    def on_step(ev):
        if methods[ev.uids[0]] == "ab":
            ab_steps[0] += 1

    t0 = time.perf_counter()
    for q in wave1:
        eng.submit(q)
    results, sent2 = [], False
    while eng.busy:
        results += eng.tick(on_step=on_step)
        if not sent2 and any(r.uid == 1 for r in results):
            for q in wave2:
                eng.submit(q)
            sent2 = True
    _sync(eng.device)
    return results, ab_steps[0], time.perf_counter() - t0


def phase_serve(device, cfg, params):
    """The served mix through ``DiffusionServeEngine`` on the given model:
    two staggered waves (a join), a warm replay that adds no executor, K1's
    launches against the ``ab`` group steps. Returns (sde, K1 launches of
    the cold run)."""
    from repro_torch.core import RetirePolicy, VPSDE
    from repro_torch.kernels import deis_step as K
    from repro_torch.serving.engine import DiffusionServeEngine, Request

    sde = VPSDE()
    wave1, wave2 = _requests(Request)
    methods = _methods(sde, Request)
    retire = RetirePolicy(tol=0.05, min_k=3, norm="rel")
    eng = DiffusionServeEngine(params, cfg, sde=sde, retire=retire,
                               seq_len_buckets=(128, 256), device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    K.fused_ab_step.launches = 0
    cold, ab_steps, cold_s = _serve_waves(eng, Request, methods)
    launches = K.fused_ab_step.launches
    by_uid = {q.uid: q for q in wave1 + wave2}
    for res in cold:
        q = by_uid[res.uid]
        if res.tokens.shape != (q.seq_len,) or res.tokens.min() < 0 \
                or res.tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"request {res.uid}: bad tokens {res.tokens.shape}")
    if sorted(r.uid for r in cold) != sorted(by_uid):
        raise AssertionError("not every request completed")
    snap = eng.metrics.snapshot()
    if snap["serve_submitted_total"] != snap["serve_completed_total"]:
        raise AssertionError("submitted != completed")
    print(f"serve {cfg.name} (cold): {len(cold)} requests of {len(set(q.solver for q in by_uid.values()))} "
          f"solvers in {cold_s:.3f} s; joins {eng.joined_requests}, "
          f"early exits {int(snap['serve_early_exit_total'])}, "
          f"executors {eng.num_executors}, ab group steps {ab_steps}, "
          f"K1 launches {launches}")
    print("results: " + "; ".join(
        f"{r.uid}:{by_uid[r.uid].solver} nfe {r.nfe} early {r.early_exit}"
        for r in sorted(cold, key=lambda r: r.uid)))
    if eng.joined_requests < 1:
        raise AssertionError("the staggered waves produced no join")
    if device.type == "cuda" and not (launches == ab_steps > 0):
        raise AssertionError(f"K1 launches {launches} != ab group steps {ab_steps}")

    h_cold = snap["serve_step_seconds"]
    misses0 = snap["serve_compile_cache_misses_total"]
    K.fused_ab_step.launches = 0
    warm, ab_warm, warm_s = _serve_waves(eng, Request, methods)
    warm_launches = K.fused_ab_step.launches
    new_misses = eng.metrics.snapshot()["serve_compile_cache_misses_total"] - misses0
    same = all(np.array_equal(a.tokens, b.tokens) for a, b in zip(
        sorted(cold, key=lambda r: r.uid), sorted(warm, key=lambda r: r.uid)))
    lat = sorted(r.latency_s for r in warm)
    n_tok = sum(len(r.tokens) for r in warm)
    print(f"serve {cfg.name} (warm replay): {warm_s:.3f} s, {n_tok} tokens ({n_tok / warm_s:.1f} "
          f"tokens/s), request solve latency p50 {lat[len(lat) // 2]:.3f} s max "
          f"{lat[-1]:.3f} s; new executors {int(new_misses)}, tokens equal to the "
          f"cold run: {same}, ab group steps {ab_warm}, K1 launches {warm_launches}")
    if new_misses != 0:
        raise AssertionError(f"warm replay added {new_misses} executors")
    if device.type == "cuda" and warm_launches != ab_warm:
        raise AssertionError(f"warm K1 launches {warm_launches} != {ab_warm}")
    h = eng.metrics.snapshot()["serve_step_seconds"]
    n_warm = h["count"] - h_cold["count"]
    cold_ms = 1e3 * h_cold["sum"] / max(1, h_cold["count"])
    warm_ms = 1e3 * (h["sum"] - h_cold["sum"]) / max(1, n_warm)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else float("nan")
    print(f"group step of {cfg.name} (dispatch to done, mean over the served groups): cold "
          f"{cold_ms:.3f} ms over {h_cold['count']} steps, warm {warm_ms:.3f} ms "
          f"over {n_warm} steps; peak memory {peak / 2**30:.2f} GiB")
    return sde, launches


def _methods(sde, Request):
    """Each served request's plan method (K1 runs the ``ab`` steps)."""
    from repro_torch.core import get_timesteps, make_plan, solver_stages
    wave1, wave2 = _requests(Request)
    return {q.uid: make_plan(q.solver, sde, get_timesteps(
        sde, max(1, q.nfe // solver_stages(q.solver)))).method for q in wave1 + wave2}


@contextlib.contextmanager
def _one_rank_group(device):
    """A one-rank default process group in this process (NCCL on the card,
    gloo on the CPU) from a ``file://`` store under ``build/``, and the
    request mesh over it (the engine adds its gloo control group). Raises
    if the group does not come up; torn down on exit."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_request_mesh
    store = ROOT / "build" / f"dist_store_{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    kw = {}
    if device.type == "cuda":
        kw["device_id"] = torch.device("cuda", device.index if device.index is not None
                                       else torch.cuda.current_device())
    dist.init_process_group("nccl" if kw else "gloo", init_method=f"file://{store}",
                            rank=0, world_size=1, **kw)
    try:
        yield make_request_mesh()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def _tick_ms(eng, since):
    """Mean ``serve_tick_seconds`` in ms since the snapshot ``since``."""
    h = eng.metrics.snapshot()["serve_tick_seconds"]
    return 1e3 * (h["sum"] - since["sum"]) / max(1, h["count"] - since["count"]), \
        h["count"] - since["count"]


CLI_DP_REQUESTS = 6   # the sharded CLI's sync run: 6 x tab3, 10 NFE, seq 128


def phase_sharded_serve(device, cfg, params, sde):
    """The served mix of phase_serve through ``DiffusionServeEngine(mesh=)``
    on a one-rank data group (NCCL) plus its gloo control group: tokens,
    NFE, early exits and final errors bitwise equal to the unsharded
    engine's on the card (at one rank the local shapes are the unsharded
    ones), a warm replay that adds no executor, K1's launches equal to the
    ``ab`` group steps; warm ms per tick, sharded against unsharded, in
    turns; then a ``ServeDriver`` over the sharded engine. Returns (K1
    launches of the sharded cold run, the unsharded tokens of the sharded
    CLI's requests, keyed by uid)."""
    from repro_torch.core import RetirePolicy
    from repro_torch.kernels import deis_step as K
    from repro_torch.serving.driver import ServeDriver
    from repro_torch.serving.engine import DiffusionServeEngine, Request

    methods = _methods(sde, Request)
    kw = dict(sde=sde, retire=RetirePolicy(tol=0.05, min_k=3, norm="rel"),
              seq_len_buckets=(128, 256), device=device)
    with _one_rank_group(device) as mesh:
        plain = DiffusionServeEngine(params, cfg, **kw)
        sharded = DiffusionServeEngine(params, cfg, mesh=mesh, **kw)
        want, _, _ = _serve_waves(plain, Request, methods)
        K.fused_ab_step.launches = 0
        got, ab_steps, cold_s = _serve_waves(sharded, Request, methods)
        launches = K.fused_ab_step.launches
        key = lambda r: (r.uid, r.nfe, r.early_exit, r.final_err)
        want_by, got_by = {r.uid: r for r in want}, {r.uid: r for r in got}
        if sorted(want_by) != sorted(got_by):
            raise AssertionError("the sharded engine completed other requests")
        for uid, w in want_by.items():
            g = got_by[uid]
            if key(g) != key(w) or not np.array_equal(g.tokens, w.tokens):
                raise AssertionError(f"request {uid}: sharded {key(g)} != unsharded {key(w)}"
                                     " or other tokens")
        if device.type == "cuda" and not (launches == ab_steps > 0):
            raise AssertionError(f"sharded K1 launches {launches} != ab group steps {ab_steps}")
        print(f"sharded serve {cfg.name} (one-rank {'nccl' if device.type == 'cuda' else 'gloo'}"
              f" data group + gloo control): {len(got)} requests bitwise equal to the "
              f"unsharded engine (tokens, nfe, early exits, final errors) in {cold_s:.3f} s "
              f"cold; joins {sharded.joined_requests}, ab group steps {ab_steps}, K1 "
              f"launches {launches}")
        misses = sharded.metrics.snapshot()["serve_compile_cache_misses_total"]
        ms = {"unsharded": [], "sharded": []}
        for name in ("unsharded", "sharded", "sharded", "unsharded"):
            eng = plain if name == "unsharded" else sharded
            since = eng.metrics.snapshot()["serve_tick_seconds"]
            warm, _, _ = _serve_waves(eng, Request, methods)
            ms[name].append(_tick_ms(eng, since))
            if not all(np.array_equal(r.tokens, want_by[r.uid].tokens) for r in warm):
                raise AssertionError(f"warm {name} replay gave other tokens")
        new = sharded.metrics.snapshot()["serve_compile_cache_misses_total"] - misses
        if new != 0:
            raise AssertionError(f"warm sharded replays added {new} executors")
        (u1, n), (u2, _) = ms["unsharded"]
        (s1, _), (s2, _) = ms["sharded"]
        print(f"warm ms per tick ({n} ticks a replay; turns unsharded, sharded, sharded, "
              f"unsharded): unsharded {u1:.3f}, {u2:.3f}; sharded {s1:.3f}, {s2:.3f}; "
              f"control plane {(s1 + s2 - u1 - u2) / 2:.3f} ms a tick; new executors 0")
        # the driver over the sharded engine (its scheduler thread makes every
        # collective); the card's GEMMs depend on the batch the driver's
        # timing forms, so only completion and shapes are asserted here
        with ServeDriver(sharded) as drv:
            handles = [drv.submit(Request(uid=500 + i, seq_len=128, nfe=6, solver="ddim",
                                          seed=i)) for i in range(4)]
            res = [h.result(timeout=300) for h in handles]
        if [r.tokens.shape for r in res] != [(128,)] * 4 or \
                sharded.metrics.snapshot()["driver_crash_total"] != 0:
            raise AssertionError("the driver over the sharded engine failed")
        print("sharded driver: 4 requests completed, no crash")
        sharded.close()
    # the sharded CLI's requests through an engine configured as the CLI's
    cli = DiffusionServeEngine(params, cfg, sde=sde, device=device).serve(
        [Request(uid=i, seq_len=128, nfe=10, solver="tab3", seed=i)
         for i in range(CLI_DP_REQUESTS)])
    return launches, {r.uid: r.tokens for r in cli}


EP_TOL = 2e-2   # bf16 full width: |EP - moe| <= EP_TOL * max|moe| (a bf16 ulp is 2^-8)
EP_LB_TOL = 1e-3


def phase_expert_parallel(device, cfg, params, batch=4, seq=256, n=10):
    """``moe_expert_parallel`` on a one-rank group against ``layers.moe``
    (gather dispatch) on layer 0's MoE weights, capacity_factor 100 (no
    drops on either), x (batch, seq, d_model) from a seed in the model's
    dtype: the output within EP_TOL of max|moe|, the load-balance loss
    within EP_LB_TOL; both timed (CUDA events, in turns)."""
    from repro_torch.models import layers as L
    from repro_torch.sharding.expert_parallel import moe_expert_parallel
    moe_p = params["blocks"][0]["moe"]
    cf = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=100.0),
                   moe_dispatch="gather")
    gen = torch.Generator(device=device).manual_seed(21)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device=device).to(
        moe_p["w_up"].dtype)
    n_bytes = sum(t.numel() * t.element_size() for t in moe_p.values())
    with _one_rank_group(device) as mesh:
        out, aux = moe_expert_parallel(moe_p, cf, x, mesh)
        want, aux_w = L.moe(moe_p, cf, x)
        err = (out.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        d_lb = abs(aux["moe_lb"].item() - aux_w["moe_lb"].item())
        if not (np.isfinite(err) and err <= EP_TOL * scale and d_lb <= EP_LB_TOL):
            raise AssertionError(f"EP vs moe: {err:.3e} (max|moe| {scale:.3e}), lb {d_lb:.3e}")
        times = {"ep": [], "moe": []}
        if device.type == "cuda":
            timed = _timer(device)
            for name in ("moe", "ep", "ep", "moe"):
                fn = (lambda: moe_expert_parallel(moe_p, cf, x, mesh)) if name == "ep" \
                    else (lambda: L.moe(moe_p, cf, x))
                times[name].append(timed(fn, n=n, warm=2))
    ms = lambda k: "not measured (cpu)" if not times[k] else \
        ", ".join(f"{t:.3f}" for t in times[k]) + " ms"
    print(f"expert parallel {cfg.name} layer 0 ({cfg.moe.num_experts} experts, d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, {x.dtype}, {n_bytes / 1e9:.2f} GB of weights), "
          f"x {tuple(x.shape)}, one rank: max abs diff {err:.3e} against layers.moe "
          f"(gather, capacity_factor 100; max|moe| {scale:.3e}, tol {EP_TOL} x it), lb "
          f"{aux['moe_lb'].item():.6f} vs {aux_w['moe_lb'].item():.6f}; time EP {ms('ep')}, "
          f"layers.moe {ms('moe')} (turns moe, ep, ep, moe)")


_CPU_RANKS_CHILD = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(2)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_request_mesh
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import DiffusionServeEngine, Request
cfg = get_config("gemma_2b").reduced().with_(objective="diffusion")
params = init_params(cfg, 0, "cpu")
reqs = [Request(uid=i, seq_len=16, nfe=[3, 7][i % 2], solver="ddim", seed=i) for i in range(8)]
reqs += [Request(uid=100 + i, seq_len=12, nfe=4, solver=s, seed=50 + i)
         for i, s in enumerate(["em", "tab3", "seeds2"])]
eng = DiffusionServeEngine(params, cfg, max_group=8, seq_len_buckets=(16,),
                           mesh=make_request_mesh(), device="cpu")
if rank == 0:
    for r in reqs[:4]:
        eng.submit(r)
    eng.heartbeat()          # the followers take these submits without a tick
    got = {r.uid: r.tokens for r in eng.serve(list(reqs[4:]))}
    eng.close()
    want = {r.uid: r.tokens for r in DiffusionServeEngine(
        params, cfg, max_group=8, seq_len_buckets=(16,), device="cpu").serve(list(reqs))}
    assert got.keys() == want.keys()
    for uid in want:
        assert np.array_equal(got[uid], want[uid]), uid
    print(f"CPU_RANKS_OK {world} ranks, {len(want)} requests, torch {torch.__version__}, "
          f"batches {sorted({k[1] for k in eng._compiled})}, compactions "
          f"{int(eng.metrics.snapshot()['serve_compactions_total'])}")
else:
    eng.follow()
dist.barrier()
dist.destroy_process_group()
"""


def start_cpu_ranks(world=2):
    """The sharded engine over ``world`` gloo ranks on this machine's CPU
    (reduced float32 gemma-2b, ragged NFE, compaction, three families), as
    subprocesses; rank 0 holds every token against the unsharded CPU engine."""
    tmp = ROOT / "build" / f"cpu_ranks_{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    script = tmp / "child.py"
    script.write_text(_CPU_RANKS_CHILD)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(SRC)] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(r), str(world), str(tmp / "store")],
                stdout=f, stderr=subprocess.STDOUT, env=env))
    atexit.register(_stop, procs)     # a phase that fails before they finish
    return procs, logs, time.perf_counter()


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_cpu_ranks(procs, logs, t0):
    for p in procs:
        p.wait(timeout=300)
    text = [log.read_text() for log in logs]
    ok = [ln for ln in text[0].splitlines() if ln.startswith("CPU_RANKS_OK")]
    if any(p.returncode for p in procs) or not ok:
        raise AssertionError("the CPU ranks failed:\n" + "\n".join(
            f"--- rank {r}\n{t[-3000:]}" for r, t in enumerate(text)))
    print(f"cpu ranks: {ok[0][len('CPU_RANKS_OK '):]}; tokens bitwise equal to the "
          f"unsharded CPU engine; {time.perf_counter() - t0:.1f} s")


def start_dp_cli(device, reduced):
    """``torchrun --standalone --nproc_per_node=1 -m repro_torch.launch.serve
    --arch gemma_2b --data-parallel`` (sync transport: the tokens of a batch
    that does not depend on timing) as a subprocess."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
           "-m", "repro_torch.launch.serve", "--arch", "gemma_2b", "--data-parallel",
           "--requests", str(CLI_DP_REQUESTS), "--seq-len", "128"]
    if device.type != "cuda":
        cmd += ["--device", "cpu"]
    if reduced:
        cmd += ["--reduced"]
    # torchrun would set one CPU thread; the same count as this process keeps
    # the CPU rehearsal's GEMM summation order (and so its tokens) the same
    env = dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()),
               PYTHONPATH=os.pathsep.join([str(SRC)] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    print("cli: " + " ".join(cmd[1:]))
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env), time.perf_counter()


def finish_dp_cli(proc, t0, want):
    """Exit 0, the mesh line, and the first four results' tokens equal to
    the unsharded engine's on the same weights and batch."""
    out, err = proc.communicate(timeout=600)
    mesh = [ln for ln in out.splitlines() if ln.startswith("request-parallel mesh: 1 ")]
    lines = {int(m.group(1)): m.group(2) for m in
             re.finditer(r"^req (\d+): .*tokens\[:10\]=(\[[^\]]*\])", out, re.M)}
    expect = {uid: f"{want[uid][:10]}" for uid in sorted(want)[:4]}
    if proc.returncode != 0 or not mesh or f"served {CLI_DP_REQUESTS} requests" not in out \
            or lines != expect:
        raise AssertionError(f"the data-parallel launcher exited {proc.returncode} "
                             f"(tokens {lines} vs {expect}):\n{out[-2000:]}\n{err[-2000:]}")
    print(f"cli --data-parallel: exit 0 after {time.perf_counter() - t0:.1f} s; {mesh[0]}; "
          f"served {CLI_DP_REQUESTS} requests, tokens of the 4 printed equal to the unsharded "
          "engine's")


def _local_open(url, data=None):
    """urlopen for the server on 127.0.0.1, never through a proxy."""
    import urllib.request
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    return opener.open(urllib.request.Request(url, data=data), timeout=600)


def _http_call(url, body=None, stream=False):
    """(status, parsed body, client seconds) of one request to the port's
    HTTP transport: JSON, or the list of NDJSON lines when ``stream``."""
    import urllib.error
    data = None if body is None else json.dumps(dict(body, stream=stream)).encode()
    t0 = time.perf_counter()
    try:
        with _local_open(url, data) as r:
            code, text = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        code, text = e.code, e.read().decode()
    dt = time.perf_counter() - t0
    if url.endswith("/metrics"):
        return code, text, dt
    parsed = [json.loads(ln) for ln in text.strip().split("\n")] if stream and code == 200 \
        else json.loads(text)
    return code, parsed, dt


def _parallel(fn, args):
    """fn(*a) for every a in args, each on its own client thread; results in order."""
    import threading
    out = [None] * len(args)

    def run(i):
        out[i] = fn(*args[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(args))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("an HTTP client thread did not finish in 600 s")
    return out


def phase_http(device, cfg, params, sde, reduced):
    """The launcher's HTTP transport in-process on 127.0.0.1 over the served
    weights: ``ServeDriver(engine, stream_decode=True, max_pending=9)`` and
    ``make_http_server``, clients on threads with urllib. A lone request
    equal bitwise to its solo solve through the sync engine; 8 concurrent
    requests of 5 solvers, streamed and not; a burst over
    ``max_pending`` answered 429; a long streamed request cancelled through
    ``/v1/cancel``; 400 and 404; ``/metrics`` and ``/stats`` that add up;
    no driver crash; K1's launches equal to the ``ab`` group steps served.
    Returns the numbers reported."""
    import threading
    from repro_torch.core import get_timesteps, make_plan, solver_stages
    from repro_torch.kernels import deis_step as K
    from repro_torch.launch.serve import make_http_server
    from repro_torch.serving.driver import ServeDriver
    from repro_torch.serving.engine import DiffusionServeEngine, Request

    seq = 32 if reduced else 128
    lone = dict(seq_len=seq, nfe=8, solver="tab3", seed=21)
    mix = [dict(seq_len=seq, nfe=8, solver="tab3", seed=30),
           dict(seq_len=seq, nfe=6, solver="ddim", seed=31),
           dict(seq_len=seq, nfe=8, solver="rho_heun", seed=32),
           dict(seq_len=seq, nfe=8, solver="seeds2", seed=33),
           dict(seq_len=seq, nfe=10, solver="dpm2m", seed=34),
           dict(seq_len=seq // 2, nfe=6, solver="tab3", seed=35),
           dict(seq_len=seq, nfe=8, solver="ddim", seed=36),
           dict(seq_len=seq, nfe=8, solver="rho_heun", seed=37)]
    solvers = {q["solver"] for q in mix} | {"tab3"}
    method = {s: make_plan(s, sde, get_timesteps(sde, max(1, 8 // solver_stages(s)))).method
              for s in solvers}

    def solo(q):
        eng = DiffusionServeEngine(params, cfg, sde=sde, device=device)
        return eng.serve([Request(uid=0, **q)])[0].tokens

    want_lone, want_mix = solo(lone), [solo(q) for q in mix]
    eng = DiffusionServeEngine(params, cfg, sde=sde, device=device)
    drv = ServeDriver(eng, stream_decode=True, max_pending=9)
    group_uids = []     # the uids of every group step the engine ran
    fanout = drv._fanout
    drv._fanout = lambda ev: (group_uids.append(ev.uids), fanout(ev))
    server = make_http_server(drv, 0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    serve_thread = threading.Thread(target=server.serve_forever, daemon=True)
    solver_of = {}      # uid -> solver, from the answers
    posts = invalid = shed = 0
    K.fused_ab_step.launches = 0
    drv.start()
    serve_thread.start()
    try:
        # 1. one request alone: bitwise its solo solve through the sync engine
        code, res, lone_s = _http_call(f"{base}/v1/generate", lone)
        posts += 1
        if code != 200 or res["tokens"] != want_lone.tolist() or res["nfe"] != lone["nfe"]:
            raise AssertionError(f"lone request: {code}, tokens equal "
                                 f"{code == 200 and res['tokens'] == want_lone.tolist()}")
        solver_of[res["uid"]] = lone["solver"]

        # 2. a long streamed request, in flight from its first step line on
        long_body = dict(seq_len=seq, nfe=1000, solver="ddim", seed=40, stream=True)
        long_resp = _local_open(f"{base}/v1/generate", json.dumps(long_body).encode())
        posts += 1
        first = json.loads(long_resp.readline())
        if first["event"] != "step" or first["k"] != 1:
            raise AssertionError(f"long request's first line {first}")
        solver_of[first["uid"]] = "ddim"

        # 3. 8 concurrent requests, even ones streamed
        t0 = time.perf_counter()
        answers = _parallel(lambda i, q: _http_call(f"{base}/v1/generate", q, stream=i % 2 == 0),
                            list(enumerate(mix)))
        wall = time.perf_counter() - t0
        posts += len(mix)
        lat, toks = [], {}
        for i, (q, (code, res, dt)) in enumerate(zip(mix, answers)):
            if code != 200:
                raise AssertionError(f"concurrent request {i} ({q['solver']}): {code} {res}")
            if i % 2 == 0:
                steps, last = res[:-1], res[-1]
                n = steps[-1]["n_steps"] if steps else 0
                if last["event"] != "result" or [ln["k"] for ln in steps] != list(range(1, n + 1)) \
                        or any(ln["event"] != "step" or ln["n_steps"] != n for ln in steps) \
                        or any(len(ln["tokens"]) != q["seq_len"] for ln in steps):
                    raise AssertionError(f"stream {i} ({q['solver']}): "
                                         f"{[(ln['event'], ln.get('k')) for ln in res]}")
                res = last
            if res["nfe"] != q["nfe"] or len(res["tokens"]) != q["seq_len"]:
                raise AssertionError(f"request {i}: nfe {res['nfe']} of {q['nfe']}, "
                                     f"{len(res['tokens'])} tokens of {q['seq_len']}")
            solver_of[res["uid"]] = q["solver"]
            lat.append(dt)
            toks[i] = res["tokens"]
        eq = [np.mean(np.asarray(toks[i]) == want_mix[i]) for i in range(len(mix))]

        # 4. a burst over max_pending (the long request holds one slot)
        burst = _parallel(lambda q: _http_call(f"{base}/v1/generate", q),
                          [(dict(seq_len=seq // 2, nfe=6, solver="ddim", seed=50 + i),)
                           for i in range(16)])
        posts += len(burst)
        codes = sorted(c for c, _, _ in burst)
        shed = codes.count(429)
        if shed < 1 or codes.count(200) + shed != len(burst):
            raise AssertionError(f"burst answered {codes}")
        for c, res, _ in burst:
            if c == 200:
                solver_of[res["uid"]] = "ddim"
            elif "max_pending" not in res["error"]:
                raise AssertionError(f"429 without the backpressure message: {res}")

        # 5. cancel the long request: cancelled, and its stream ends in an error event
        code, res, _ = _http_call(f"{base}/v1/cancel", {"uid": first["uid"]})
        if code != 200 or res != {"uid": first["uid"], "cancelled": True}:
            raise AssertionError(f"cancel answered {code} {res}")
        rest = [json.loads(ln) for ln in long_resp.read().decode().strip().split("\n")]
        long_resp.close()
        if rest[-1]["event"] != "error" or "cancelled" not in rest[-1]["error"] \
                or any(ln["event"] != "step" for ln in rest[:-1]):
            raise AssertionError(f"cancelled stream ended with {rest[-1]}")
        long_steps = len(rest)   # its first step line, then the rest's step lines

        # 6. bad input
        code, res, _ = _http_call(f"{base}/v1/generate", dict(lone, solver="nope"))
        posts += 1
        invalid += 1
        if code != 400 or "unknown solver" not in res["error"]:
            raise AssertionError(f"unknown solver answered {code} {res}")
        if _http_call(f"{base}/v1/nope", lone)[0] != 404 or _http_call(f"{base}/nope")[0] != 404:
            raise AssertionError("an unknown route did not answer 404")

        # 7. /metrics and /stats
        code, text, _ = _http_call(f"{base}/metrics")
        metrics = {}
        for ln in text.splitlines():
            if ln and not ln.startswith("#") and "{" not in ln:
                name, val = ln.split()
                metrics[name] = float(val)
        code_s, stats, _ = _http_call(f"{base}/stats")
    finally:
        server.shutdown()
        server.server_close()
        drv.stop(timeout=600)
    launches = K.fused_ab_step.launches
    m = metrics
    completed = 1 + len(mix) + (len(burst) - shed)
    want_counts = {"driver_submitted_total": posts - shed, "driver_shed_total": shed,
                   "serve_completed_total": completed, "serve_cancelled_total": 1,
                   "serve_submitted_total": posts - shed - invalid,
                   "serve_deadline_evicted_total": 0, "driver_crash_total": 0}
    got_counts = {k: int(m.get(k, -1)) for k in want_counts}
    if got_counts != want_counts:
        raise AssertionError(f"/metrics counts {got_counts} != {want_counts}")
    if m["serve_submitted_total"] != m["serve_completed_total"] + m["serve_cancelled_total"] \
            + m["serve_deadline_evicted_total"] or \
            m["driver_submitted_total"] != m["serve_submitted_total"] + invalid:
        raise AssertionError(f"/metrics do not add up: {got_counts}")
    if code_s != 200 or (stats["submitted"], stats["shed"], stats["completed"],
                         stats["cancelled"], stats["in_flight"]) != \
            (posts - shed, shed, completed, 1, 0):
        raise AssertionError(f"/stats {stats}")
    if "driver_loop_seconds_count" not in m or "serve_step_seconds_count" not in m:
        raise AssertionError("/metrics lacks the driver_* or serve_* histograms")
    ab_steps = sum(method[solver_of[u[0]]] == "ab" for u in group_uids)
    if device.type == "cuda" and launches != ab_steps:
        raise AssertionError(f"HTTP path: K1 launches {launches} != ab group steps {ab_steps}")
    lat = sorted(lat)
    n_tok = sum(len(t) for t in toks.values())
    loop = m["driver_loop_seconds_sum"] / max(1.0, m["driver_loop_seconds_count"])
    print(f"http: lone request {lone_s:.3f} s, tokens bitwise its solo solve; 8 concurrent "
          f"requests of {len({q['solver'] for q in mix})} solvers ({len(mix) // 2} streamed) in "
          f"{wall:.3f} s: latency p50 {lat[len(lat) // 2]:.3f} s max {lat[-1]:.3f} s, "
          f"{n_tok / wall:.1f} tokens/s; equal tokens against solo solves "
          f"{float(np.mean(eq)):.4f} (per request {[round(float(e), 4) for e in eq]})")
    print(f"http: burst of {len(burst)} over max_pending 9: {shed} answered 429; the long "
          f"request cancelled after {long_steps} streamed steps; 400 and 404 as asked; "
          f"/metrics {got_counts}; /stats agrees; driver loop mean {loop * 1e3:.3f} ms over "
          f"{int(m['driver_loop_seconds_count'])} iterations; group steps {len(group_uids)}, "
          f"ab {ab_steps}, K1 launches {launches}"
          f"{'' if device.type == 'cuda' else ' (not counted on the cpu)'}")
    return dict(p50=lat[len(lat) // 2], max=lat[-1], tok_s=n_tok / wall,
                eq=float(np.mean(eq)), ab_steps=ab_steps, launches=launches)


AR_TOL = 5e-2    # bf16 full width: |decode - full| <= AR_TOL * (|full| + max|full|)


@contextlib.contextmanager
def _routing_log(log):
    """Append the ``gate_idx`` (B, S, k) of every ``moe_route`` call to
    ``log`` while the context is open (measurement only)."""
    from repro_torch.models import layers as L
    route = L.moe_route

    def logged(*args, **kw):
        r = route(*args, **kw)
        log.append(r["gate_idx"])
        return r
    L.moe_route = logged
    try:
        yield
    finally:
        L.moe_route = route


@contextlib.contextmanager
def _pinned_routing(choices):
    """Each ``moe_route`` call takes the next of ``choices`` (gate_idx (B,
    S, k), in call order) for its top-k, its gates and queues computed as
    usual (measurement only)."""
    from repro_torch.models import layers as L
    route, it = L.moe_route, iter(choices)

    def pinned(params, cfg, x):
        r = route(params, cfg, x)
        return L.moe_queue(cfg, r["logits"], r["gates"], next(it).to(x.device))
    L.moe_route = pinned
    try:
        yield
    finally:
        L.moe_route = route


def _full_sequence_choices(dec, n_moe):
    """The cached path's choices (the prefill's, then each decode step's,
    ``n_moe`` calls each) as one full forward's: per MoE layer, gate_idx
    over the whole sequence."""
    calls = [dec[i:i + n_moe] for i in range(0, len(dec), n_moe)]
    return [torch.cat([c[j] for c in calls], dim=1) for j in range(n_moe)]


def _ar_decode_logits(cfg, params, seq, n_prompt, cond=None):
    """Prefill ``seq[:, :n_prompt]`` (with ``cond``: a vlm's ``prefix`` of
    P positions or an encdec's ``frames``) into a cache of P + ``seq``'s
    length (``init_cache``, the prefilled layers copied in, an encdec's
    cross k and v as prefill made them), then decode the rest of ``seq``
    one token at a time at ``cache_index`` P + i. Returns the logits of the
    last prompt position and of each decoded position, (B, L - n_prompt +
    1, vocab)."""
    from repro_torch.models import transformer as T
    from repro_torch.training.steps import make_decode_step, make_prefill_step
    cond = cond or {}
    b, L = seq.shape
    p = cond["prefix"].shape[1] if "prefix" in cond else 0
    with torch.no_grad():
        logits, pf = make_prefill_step(cfg)(params, dict(cond, tokens=seq[:, :n_prompt]))
        cache = T.init_cache(cfg, b, p + L, device=seq.device)
        for dst, src in zip(cache["blocks"], pf["blocks"]):
            for name, t in src.items():
                dst[name][:, :t.shape[1]].copy_(t)
        if "cross" in pf:
            cache["cross"] = pf["cross"]
        out = [logits]
        decode = make_decode_step(cfg)
        for i in range(n_prompt, L):
            logits, cache = decode(params, cache, seq[:, i:i + 1], p + i)
            out.append(logits)
    return torch.stack(out, dim=1)


def phase_ar(device, cfg, params, reduced, n_new=16, vs_f32=True):
    """``ARServeEngine`` greedy decode over the given weights (the AR head of
    the same backbone): 4 requests with prompts of 8-64 tokens and 16 new
    tokens each. For each request, the logits of prefill-then-decode,
    teacher-forced on its greedy tokens, against one full forward over the
    same sequence within AR_TOL (asserted), and both against a float32
    forward of the same weights (reported; ``vs_f32=False`` skips it where
    a float32 copy of the weights does not fit beside them). Under MoE a
    bf16 near-tie can send a token to other experts on the two paths (a
    discrete change, not rounding, which then spreads to later tokens and
    layers): the full forward is run on the experts the cached path chose
    (pinned) and held within AR_TOL; the pairs it would have routed
    otherwise, and its difference then, are reported. Reports prefill ms,
    ms per decoded token, the device's
    idle share during decode, peak memory and the share of greedy tokens
    equal to the no-cache greedy choice on the same prefix (the argmax of
    the full forward at each position)."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ARServeEngine, Request
    cfg = cfg.with_(objective="ar")
    lens = [8, 24, 40, 64]
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in lens]
    eng = ARServeEngine(params, cfg, max_len=max(lens) + n_new, device=device)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    eng.serve([dataclasses.replace(reqs[0], max_new_tokens=2)])     # warm-up
    res = eng.serve(reqs)
    _sync(device)
    peak = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else float("nan")
    pre = eng.serve([dataclasses.replace(q, max_new_tokens=1) for q in reqs])
    prefill_ms = [1e3 * r.latency_s for r in pre]
    tok_ms = [1e3 * (r.latency_s - p.latency_s) / (n_new - 1) for r, p in zip(res, pre)]

    p32 = _to(params, device, torch.float32) if vs_f32 else None
    cfg32 = cfg.with_(dtype="float32")
    worst, vs32, eq = 0.0, dict.fromkeys(("decode", "full"), 0.0 if vs_f32 else float("nan")), []
    flips, n_route, first_flip, worst_free = 0, 0, 10**9, 0.0
    for q, r in zip(reqs, res):
        if r.tokens.shape != (n_new,) or r.tokens.min() < 0 or r.tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"{cfg.name} AR request {q.uid}: bad tokens {r.tokens}")
        seq = torch.as_tensor(np.concatenate([q.prompt, r.tokens[:-1]]), device=device)[None]
        n = len(q.prompt)
        log_dec, log_full = [], []
        with _routing_log(log_dec):
            got = _ar_decode_logits(cfg, params, seq, n)[0]
        with torch.no_grad(), _routing_log(log_full):
            full = T.forward(params, cfg, tokens=seq, mode="train")["logits"][0, n - 1:]
        if log_full:    # MoE: the full forward again, on the cached path's experts
            dec = _full_sequence_choices(log_dec, len(log_full))
            for d, f in zip(dec, log_full):
                diff = (d.sort(-1).values != f.sort(-1).values).any(-1)[0]
                flips += int(diff.sum())
                first_flip = min([first_flip] + diff.nonzero()[:, 0].tolist())
            n_route += len(log_full) * seq.shape[1]
            worst_free = max(worst_free, ((got - full).abs().max() / full.abs().max()).item())
            with torch.no_grad(), _pinned_routing(dec):
                full = T.forward(params, cfg, tokens=seq, mode="train")["logits"][0, n - 1:]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{cfg.name}: decode logits not finite")
        top = full.abs().max().item()
        err = (got - full).abs()
        worst = max(worst, (err.max() / top).item())
        if not bool((err <= AR_TOL * (full.abs() + top)).all()):
            raise AssertionError(f"{cfg.name} request {q.uid}: decode logits differ from the "
                                 f"full forward by {err.max().item():.3e} (max |logit| {top:.3e})")
        if p32 is not None:
            with torch.no_grad():
                ref32 = T.forward(p32, cfg32, tokens=seq, mode="train")["logits"][0, n - 1:]
            top32 = ref32.abs().max().item()
            for name, lg in (("decode", got), ("full", full)):
                vs32[name] = max(vs32[name], ((lg - ref32).abs().max() / top32).item())
        eq.append(float((torch.argmax(full, -1).cpu().numpy() == r.tokens).mean()))
    del p32

    busy = ""
    if device.type == "cuda":
        one = [dataclasses.replace(reqs[-1], uid=9, max_new_tokens=4)]
        dev4 = sum(_device_kernel_us(lambda: eng.serve(one), 1).values()) / 1e3
        one[0] = dataclasses.replace(one[0], max_new_tokens=1)
        dev1 = sum(_device_kernel_us(lambda: eng.serve(one), 1).values()) / 1e3
        busy_tok = (dev4 - dev1) / 3
        busy = (f"; device busy per decoded token {busy_tok:.3f} ms of {tok_ms[-1]:.3f} ms "
                f"(64-token prompt; idle share {1 - busy_tok / tok_ms[-1]:.4f})")
    print(f"ar {cfg.name}: 4 requests, prompts {lens}, {n_new} new tokens each: prefill "
          f"{', '.join(f'{t:.3f}' for t in prefill_ms)} ms; per decoded token "
          f"{', '.join(f'{t:.3f}' for t in tok_ms)} ms (mean {np.mean(tok_ms):.3f}){busy}; "
          f"peak memory {peak:.2f} GiB")
    routed = "" if cfg.moe is None else (
        f" with the full forward on the cached path's experts (left to route itself, it chose "
        f"other experts for {flips} of {n_route} (layer, token) pairs, the first at position "
        f"{first_flip if flips else '-'}, and then differs by {worst_free:.3e})")
    print(f"ar {cfg.name}: prefill-then-decode logits vs one full forward: max abs err / max "
          f"|logit| {worst:.3e}{routed} within {AR_TOL} (rtol and atol x max|logit|); against a "
          f"float32 forward of the same weights: "
          + (f"decode {vs32['decode']:.3e}, full forward {vs32['full']:.3e}" if vs_f32 else
             "not run (float32 weights do not fit beside the bf16 ones)")
          + "; greedy tokens equal to the no-cache choice on the same prefix "
          f"{float(np.mean(eq)):.4f} (per request {[round(e, 4) for e in eq]})")
    return dict(prefill_ms=prefill_ms, tok_ms=float(np.mean(tok_ms)), worst=worst,
                eq=float(np.mean(eq)), peak=peak, vs32=vs32, flips=(flips, n_route))


def phase_ar_cond(device, cfg, params, cond, n_prompt=16, n_new=16):
    """AR decode of a conditioned model (a vlm's ``prefix`` or an encdec's
    ``frames``, batch 4) over the given weights with the AR head: prefill
    ``n_prompt`` tokens with ``cond``, then ``n_new - 1`` decode steps
    (``n_new`` new positions, the first from the prefill; teacher-forced on
    tokens drawn from a seed) against the self-attention cache and, for
    encdec, the cross cache (the encoder does not run in decode); the
    logits against one full forward over the same sequence with ``cond``
    within AR_TOL (asserted). Reports prefill ms, ms per decoded token
    (host clock around synchronised work: the whole run less one
    prefill), the first ``cache_index`` (it counts a prefix), peak memory
    and the share of argmax tokens equal between the two."""
    from repro_torch.models import transformer as T
    from repro_torch.training.steps import make_prefill_step
    cfg = cfg.with_(objective="ar")
    b = next(iter(cond.values())).shape[0]
    p = cond["prefix"].shape[1] if "prefix" in cond else 0
    seq = torch.as_tensor(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (b, n_prompt + n_new - 1)), device=device)
    prefill = make_prefill_step(cfg)
    with torch.no_grad():
        _ar_decode_logits(cfg, params, seq[:, :n_prompt + 2], n_prompt, cond)     # warm-up
        _sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prefill(params, dict(cond, tokens=seq[:, :n_prompt]))
        _sync(device)
        t1 = time.perf_counter()
        got = _ar_decode_logits(cfg, params, seq, n_prompt, cond)
        _sync(device)
        t2 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else float("nan")
        full = T.forward(params, cfg, tokens=seq, mode="train", **cond)["logits"][:, p + n_prompt - 1:]
    if got.shape != full.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{cfg.name}: decode logits {tuple(got.shape)} not finite or not "
                             f"of the full forward's shape {tuple(full.shape)}")
    top = full.abs().max().item()
    err = (got - full).abs()
    worst = (err.max() / top).item()
    if not bool((err <= AR_TOL * (full.abs() + top)).all()):
        raise AssertionError(f"{cfg.name}: decode logits differ from the full forward by "
                             f"{err.max().item():.3e} (max |logit| {top:.3e})")
    eq = (got.argmax(-1) == full.argmax(-1)).float().mean().item()
    prefill_ms = 1e3 * (t1 - t0)
    tok_ms = 1e3 * ((t2 - t1) - (t1 - t0)) / (n_new - 1)
    what = "frames " if "frames" in cond else f"a {p}-token prefix "
    print(f"ar {cfg.name} with {what}{tuple(next(iter(cond.values())).shape)}: batch {b}, "
          f"prefill {n_prompt} tokens {prefill_ms:.3f} ms, then {n_new - 1} decode steps from "
          f"cache_index {p + n_prompt}: {tok_ms:.3f} ms per decoded token; peak memory "
          f"{peak:.2f} GiB")
    print(f"ar {cfg.name}: prefill-then-decode logits vs one full forward: max abs err / max "
          f"|logit| {worst:.3e} within {AR_TOL} (rtol and atol x max|logit|); argmax tokens "
          f"equal {eq:.4f}")
    return dict(prefill_ms=prefill_ms, tok_ms=tok_ms, worst=worst, eq=eq, peak=peak)


REF_AR_TOL = 2e-3   # float32: the reference's own cache test (tests/test_arch_smoke.py)


def phase_ar_f32(device, cfg, params, n_layers=2):
    """The cached decode of a MoE model in float32 at its full widths: the
    first ``n_layers`` layers of the given weights cast to float32 (a
    float32 copy of them all does not fit beside them), prompts of 8-64
    tokens and 15 more teacher-forced. Prefill-then-decode logits against
    one full forward on the cached path's experts within REF_AR_TOL (rtol,
    and atol x max|logit|); the (layer, token) pairs the full forward would
    route otherwise are counted."""
    from repro_torch.models import transformer as T
    cfg32 = cfg.with_(n_layers=n_layers, dtype="float32", objective="ar")
    p32 = _to(dict(params, blocks=params["blocks"][:n_layers]), device, torch.float32)
    rng = np.random.RandomState(1)
    worst, flips, n_route = 0.0, 0, 0
    for n in (8, 24, 40, 64):
        seq = torch.as_tensor(rng.randint(0, cfg.vocab_size, n + 15), device=device)[None]
        log_dec, log_full = [], []
        with _routing_log(log_dec):
            got = _ar_decode_logits(cfg32, p32, seq, n)[0]
        with torch.no_grad(), _routing_log(log_full):
            T.forward(p32, cfg32, tokens=seq, mode="train")
        dec = _full_sequence_choices(log_dec, len(log_full))
        for d, f in zip(dec, log_full):
            flips += int((d.sort(-1).values != f.sort(-1).values).any(-1).sum())
        n_route += len(log_full) * seq.shape[1]
        with torch.no_grad(), _pinned_routing(dec):
            full = T.forward(p32, cfg32, tokens=seq, mode="train")["logits"][0, n - 1:]
        top = full.abs().max().item()
        err = (got - full).abs()
        worst = max(worst, (err.max() / top).item())
        if not torch.isfinite(got).all() or not bool((err <= REF_AR_TOL * (full.abs() + top)).all()):
            raise AssertionError(f"{cfg.name} float32, {n}-token prompt: decode logits differ "
                                 f"from the full forward by {err.max().item():.3e} (max |logit| "
                                 f"{top:.3e})")
    del p32
    print(f"ar {cfg.name} in float32, its first {n_layers} layers at full width: prefill (8-64 "
          f"tokens) then 15 decode steps vs one full forward: max abs err / max |logit| "
          f"{worst:.3e} within {REF_AR_TOL}; the full forward left to route itself chose other "
          f"experts for {flips} of {n_route} (layer, token) pairs")
    return worst, flips


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_step_breakdown(device, cfg, params, sde, k1):
    """Eps-forward time per NFE and one full stacked tab3 step at the
    main path's shape; K1's share of that step."""
    from repro_torch.core import get_timesteps, init_state, make_plan, stack_plans, step
    from repro_torch.diffusion import lm as DLM
    R, S = 8, 256
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.randn((R, S, cfg.d_model), generator=gen, device=device)
    t = torch.full((R,), 0.5, device=device)
    eps_fn = DLM.make_eps_fn(params, cfg)
    timed = _timer(device)
    n = 10 if device.type == "cuda" else 1
    with torch.no_grad():
        eps_ms = timed(lambda: eps_fn(x, t), n=n, warm=2)
        plan = make_plan("tab2", sde, get_timesteps(sde, 8), error_estimate=True)
        plan = stack_plans([plan] * R).to(device, torch.float32)
        plan = dataclasses.replace(plan, fused=True)
        st = init_state(plan, x)
        step_ms = timed(lambda: step(plan, [3] * R, st, eps_fn), n=n, warm=2)
    k1_ms = k1["ms"]
    print(f"eps forward per NFE at B={R} S={S}: {eps_ms:.3f} ms; one stacked "
          f"fused tab2 step (r=3, err): {step_ms:.3f} ms; K1 share of the step "
          f"{k1_ms / step_ms:.5f} ({k1_ms:.4f} ms)")
    if device.type != "cuda":
        return
    with torch.no_grad():
        dev = _device_kernel_us(lambda: step(plan, [3] * R, st, eps_fn), 3)
    if not dev:
        print("step breakdown: the profiler saw no device time")
        return
    groups = {"matmul": ("gemm", "nvjet", "xmma", "cutlass"), "K1": ("fused_ab_kernel",),
              "softmax": ("softmax",)}
    share = {g: 0.0 for g in list(groups) + ["other"]}
    for name, us in dev.items():
        g = next((g for g, keys in groups.items()
                  if any(k in name.lower() for k in keys)), "other")
        share[g] += us
    busy = sum(dev.values()) / 1e3
    print(f"step breakdown (torch.profiler, device time per step): busy "
          f"{busy:.3f} ms of {step_ms:.3f} ms (idle share {1 - busy / step_ms:.4f}); "
          + ", ".join(f"{g} {us / 1e3:.3f} ms" for g, us in share.items()))
    for name, us in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / 1e3:8.3f} ms  {name[:110]}")


def phase_batch_invariance(device, cfg, params, sde):
    """A stack of 4 vs each row alone through sample_tokens_stream on the
    card (reported, not asserted: cuBLAS may pick another algorithm for
    another batch)."""
    from repro_torch.core import get_timesteps, make_plan, stack_plans
    from repro_torch.diffusion import lm as DLM
    plan = make_plan("tab3", sde, get_timesteps(sde, 6))
    seeds = [101, 102, 103, 104]
    S = 128
    toks, x0 = DLM.sample_tokens_stream(
        params, cfg, stack_plans([plan] * 4), DLM.request_generators(seeds, device),
        seq_len=S, prior_std=sde.prior_std())
    diffs, eq = [], []
    for i, s in enumerate(seeds):
        t1, x1 = DLM.sample_tokens_stream(
            params, cfg, stack_plans([plan]), DLM.request_generators([s], device),
            seq_len=S, prior_std=sde.prior_std())
        diffs.append((x1[0] - x0[i]).abs().max().item())
        eq.append((t1[0] == toks[i]).float().mean().item())
    print(f"batch invariance (eps-net, stack of 4 vs solo, tab3 6 steps, seq {S}): "
          f"max abs x0 diff {max(diffs):.3e} (max |x0| {x0.abs().max().item():.3e}), "
          f"equal tokens {np.mean(eq):.4f}, bitwise {max(diffs) == 0.0}")


def _reset_counts():
    from repro_torch.kernels import (deis_step, flash_attention, moe_dispatch, ssd_scan,
                                     ssm_pointwise)
    for fn in (deis_step.fused_ab_step, flash_attention.flash_attention,
               ssd_scan.ssd_scan, ssm_pointwise.conv_prep, ssm_pointwise.gated_norm,
               moe_dispatch.route, moe_dispatch.gather, moe_dispatch.glu,
               moe_dispatch.combine):
        fn.launches = 0
    for fn in (flash_attention.flash_attention, ssd_scan.ssd_scan):
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)


def _counts():
    from repro_torch.kernels import (deis_step, flash_attention, moe_dispatch, ssd_scan,
                                     ssm_pointwise)
    return dict(K1=deis_step.fused_ab_step.launches,
                K2=flash_attention.flash_attention.launches,
                K3=ssd_scan.ssd_scan.launches,
                ssm_pre=ssm_pointwise.conv_prep.launches,
                ssm_post=ssm_pointwise.gated_norm.launches,
                moe_route=moe_dispatch.route.launches,
                moe_gather=moe_dispatch.gather.launches,
                moe_glu=moe_dispatch.glu.launches,
                moe_combine=moe_dispatch.combine.launches)


def _init_model(arch, device, reduced, n_layers=None):
    """The arch's diffusion model at its published widths (``reduced``: the
    reduced float32 config), random weights from seed 0; ``n_layers`` cuts
    the depth (printed as such)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch).with_(objective="diffusion")
    published = cfg.n_layers
    if reduced:
        cfg = cfg.reduced()
    elif n_layers is not None:
        cfg = cfg.with_(n_layers=n_layers)
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device)
    _sync(device)
    n_params = sum(p.numel() for p in _leaves(params))
    n_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    ssm = (f", ssm {cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim} heads of "
           f"{cfg.ssm.head_dim}, state {cfg.ssm.state_dim}, chunk {cfg.ssm.chunk_size}"
           if cfg.ssm else f", heads {cfg.n_heads}/{cfg.n_kv_heads} x "
           f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}")
    if cfg.moe is not None:
        ssm += (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k} (capacity factor "
                f"{cfg.moe.capacity_factor}, {cfg.moe_dispatch} dispatch)")
    if cfg.sliding_window:
        ssm += f", window {cfg.sliding_window}"
    if cfg.arch_type == "encdec":
        ssm += f", encoder {cfg.encoder_layers} layers over {cfg.encoder_seq} frames"
    if cfg.arch_type == "vlm":
        ssm += f", image prefix {cfg.prefix_tokens} tokens"
    depth = f" (depth cut: {cfg.n_layers} of {published} layers)" if cfg.n_layers != published \
        and not reduced else ""
    print(f"model: {cfg.name} {cfg.n_layers} layers{depth}, d_model {cfg.d_model}{ssm}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}, {n_params / 1e9:.3f} B params "
          f"({n_bytes / 1e9:.2f} GB), "
          f"init {time.perf_counter() - t0:.1f} s")
    return cfg, params


def _cond(cfg, device, batch=4, seed=13):
    """A conditioned arch's inputs drawn from a seed, float32 N(0, 1):
    ``{"frames": (batch, encoder_seq, d_model)}`` (encdec) or ``{"prefix":
    (batch, prefix_tokens, d_model)}`` (vlm); {} for any other arch."""
    n = {"encdec": ("frames", cfg.encoder_seq), "vlm": ("prefix", cfg.prefix_tokens)}
    if cfg.arch_type not in n:
        return {}
    name, length = n[cfg.arch_type]
    gen = torch.Generator(device=device).manual_seed(seed)
    return {name: torch.randn((batch, length, cfg.d_model), generator=gen, device=device)}


def phase_one_shot(device, cfg, params, reduced, nfe=10, batch=4, cond=None, x0_rel_tol=None):
    """sample_tokens(use_kernels=True) with a fused tab3 plan of ``nfe``
    steps (``cond``: a vlm's ``prefix`` or an encdec's ``frames``, passed
    to every evaluation): the launch counts of this run (K2 once an
    attention layer and NFE, K3 and the SSM mixer's two passes once an SSM
    layer and NFE, each on its wgmma route), its tokens and x0 against the
    same call on the plain route (the relative L2 distance of the x0s held
    within ``x0_rel_tol`` where one is given), the eps forward per NFE on
    both routes and the kernel route's device time by kernel (and, for
    encdec, the encoder's share of it)."""
    cond = cond or {}
    from repro_torch.core import VPSDE, get_timesteps, make_plan
    from repro_torch.diffusion import lm as DLM
    from repro_torch.models import transformer as T
    seq = 64 if reduced else 256
    sde = VPSDE()
    plan = dataclasses.replace(make_plan("tab3", sde, get_timesteps(sde, nfe)), fused=True)
    kinds = [T._layer_kind(cfg, i)[0] for i in range(cfg.n_layers)]
    want = {"K1": plan.n_steps, "K2": kinds.count("attn") * nfe,
            "K3": kinds.count("ssm") * nfe}
    # the SSM mixer's two pointwise passes, once an SSM layer and NFE; each
    # MoE kernel once a MoE layer and NFE
    want["ssm_pre"] = want["ssm_post"] = want["K3"]
    n_moe = [T._layer_kind(cfg, i)[1] for i in range(cfg.n_layers)].count("moe")
    want.update(dict.fromkeys(MOE_KEYS, n_moe * nfe))
    mixers = [k for k in ("K2", "K3") if want[k]]
    runs = {}
    with torch.no_grad():
        for use_kernels in (True, False):
            gens = DLM.request_generators([7], device)[0]
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            toks, x0 = DLM.sample_tokens(params, cfg, plan, gens, batch=batch, seq_len=seq,
                                         prior_std=sde.prior_std(), use_kernels=use_kernels,
                                         **cond)
            _sync(device)
            wall = time.perf_counter() - t0
            counts, routes = _counts(), _route_counts()
            peak = (torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda"
                    else float("nan"))
            if tuple(toks.shape) != (batch, seq) or not torch.isfinite(x0).all() \
                    or toks.min() < 0 or toks.max() >= cfg.vocab_size:
                raise AssertionError(f"{cfg.name}: bad one-shot output {tuple(toks.shape)}")
            print(f"one-shot {cfg.name} use_kernels={use_kernels}: tab3 {nfe} NFE, batch "
                  f"{batch}, seq {seq} in {wall:.3f} s (first call of the route, builds "
                  f"included); launches {counts}, by route "
                  f"{ {k: routes[k] for k in mixers} }; peak memory {peak:.2f} GiB")
            runs[use_kernels] = (toks, x0, counts, routes)
    counts, routes = runs[True][2], runs[True][3]
    if device.type == "cuda" and counts != want:
        raise AssertionError(f"{cfg.name}: kernel-route launches {counts} != {want}")
    for k in mixers:
        if device.type == "cuda" and routes[k] != {"cuda_cores": 0, "mma_sync": 0,
                                                   "wgmma": want[k], "tf32x3": 0}:
            raise AssertionError(f"{cfg.name}: {k} took the routes {routes[k]}, not wgmma "
                                 f"{want[k]} times")
    if device.type == "cuda" and runs[False][2] != dict(want, K2=0, K3=0, ssm_pre=0,
                                                        ssm_post=0,
                                                        **dict.fromkeys(MOE_KEYS, 0)):
        raise AssertionError(f"{cfg.name}: plain route launched {runs[False][2]}")
    (tk, xk, _, _), (tp, xp, _, _) = runs[True], runs[False]
    eq = (tk == tp).float().mean().item()
    dx = (xk - xp).abs().max().item()
    rel = ((xk.float() - xp.float()).norm() / xp.float().norm()).item()
    if x0_rel_tol is not None and not rel <= x0_rel_tol:
        raise AssertionError(f"{cfg.name}: kernel-route x0 {rel:.4e} (relative L2) from the "
                             f"plain route's, beyond {x0_rel_tol}")
    print(f"one-shot {cfg.name}: kernel route vs plain route on this device: equal tokens "
          f"{eq:.4f}, max abs x0 diff {dx:.3e} (max |x0| {xp.abs().max().item():.3e}), "
          f"relative L2 {rel:.4e}"
          + (f" within {x0_rel_tol}" if x0_rel_tol is not None else "") + "; "
          f"expected launches {want}, all of {' and '.join(mixers)}'s on the wgmma route, "
          f"{'held' if device.type == 'cuda' else '(not counted on the cpu)'}")

    gen = torch.Generator(device=device).manual_seed(11)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device=device)
    t = torch.full((batch,), 0.5, device=device)
    timed = _timer(device)
    n = 5 if device.type == "cuda" else 1
    eps_ms = {}
    with torch.no_grad():
        for use_kernels in (True, False):
            eps_fn = DLM.make_eps_fn(params, cfg, use_kernels=use_kernels, **cond)
            eps_ms[use_kernels] = timed(lambda: eps_fn(x, t), n=n, warm=1)
        print(f"eps forward per NFE of {cfg.name} at B={batch} S={seq}"
              + (f" (+ prefix {cond['prefix'].shape[1]})" if "prefix" in cond else "")
              + (f" (+ encoder over {cond['frames'].shape[1]} frames)" if "frames" in cond
                 else "")
              + f": kernel route {eps_ms[True]:.3f} ms, plain route {eps_ms[False]:.3f} ms")
        if device.type == "cuda":
            eps_fn = DLM.make_eps_fn(params, cfg, use_kernels=True, **cond)
            dev = _device_kernel_us(lambda: eps_fn(x, t), 2)
            groups = {"K2": ("flash_fwd_wgmma_kernel", "flash_fwd_mma_kernel",
                             "flash_fwd_tf32x3_kernel", "flash_fwd_kernel"),
                      "K3": ("ssd_scan_wgmma_kernel", "ssd_scan_mma_kernel",
                             "ssd_scan_tf32x3_kernel", "ssd_scan_kernel"),
                      "matmul": ("gemm", "nvjet", "xmma", "cutlass")}
            share = {g: 0.0 for g in list(groups) + ["other"]}
            for name, us in dev.items():
                g = next((g for g, keys in groups.items()
                          if any(key in name.lower() for key in keys)), "other")
                share[g] += us
            busy = sum(dev.values()) / 1e3
            print(f"eps forward breakdown of {cfg.name} (torch.profiler, device time per "
                  f"forward): busy {busy:.3f} ms of {eps_ms[True]:.3f} ms (idle share "
                  f"{1 - busy / eps_ms[True]:.4f}); "
                  + ", ".join(f"{g} {us / 1e3:.3f} ms" for g, us in share.items()))
            if "frames" in cond:
                from repro_torch.models import transformer as T
                enc, total = _range_us(lambda: eps_fn(x, t), 2, T, "_run_encoder", "encoder")
                print(f"encoder of {cfg.name} (plain route, {cond['frames'].shape[1]} frames, "
                      f"run at every NFE as in the reference): {enc / 1e3:.3f} ms of "
                      f"{total / 1e3:.3f} ms device busy per forward (share {enc / total:.4f})")
    return dict(counts=counts, routes=routes, eq=eq, dx=dx, eps_ms=eps_ms)


GEMM_KEYS = ("gemm", "nvjet", "xmma", "cutlass")


@contextlib.contextmanager
def _layer_ranges(labels, module=None):
    """``torch.profiler.record_function`` ranges around functions of
    ``module`` (default ``repro_torch.models.layers``; ``labels``: attribute
    -> range name), so that the profiler can tell whose kernels are whose;
    the functions are put back on exit. Used for measurement only: the main
    path runs without them."""
    if module is None:
        from repro_torch.models import layers as module
    saved = {attr: getattr(module, attr) for attr in labels}

    def wrap(fn, label):
        def wrapped(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return wrapped
    for attr, label in labels.items():
        setattr(module, attr, wrap(saved[attr], label))
    try:
        yield
    finally:
        for attr, fn in saved.items():
            setattr(module, attr, fn)


def _range_us(fn, n, module, attr, label):
    """Device microseconds per call of fn: those of the kernels launched
    inside ``module.attr`` (in a range ``label`` for the measurement, see
    :func:`_layer_ranges`), and all of them."""
    from torch.profiler import ProfilerActivity, profile
    with _layer_ranges({attr: label}, module):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    inside = 0.0
    for ev in prof.events():
        up = ev
        while up is not None and up.name != label:
            up = up.cpu_parent
        if up is not None:
            inside += sum(k.duration for k in ev.kernels) / n
    total = sum(e.self_device_time_total / n for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.key != label)
    return inside, total


def _moe_parts_us(fn, n):
    """Device microseconds per call of fn by part of a MoE eps forward, from
    torch.profiler: each kernel is charged to the innermost of the ranges
    "experts" (the expert products and silu·h), "moe" (routing: router
    product, softmax, top-k, cumsum; dispatch: one-hot and the dispatch and
    combine products, or scatter and gathers) and "attention" (K2 apart)
    that launched it. Returns ({part: us}, busy us from the kernel table)."""
    from torch.profiler import ProfilerActivity, profile
    with _layer_ranges({"attention": "attention", "moe": "moe", "_experts": "experts",
                        "_expert_glu": "experts"}):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    ranges = ("attention", "moe", "experts")
    parts = dict.fromkeys(("expert GEMMs", "expert silu*h", "MoE routing and dispatch",
                           "attention GEMMs", "K2", "attention other", "other"), 0.0)
    for ev in prof.events():
        label = ev
        while label is not None and label.name not in ranges:
            label = label.cpu_parent
        label = None if label is None else label.name
        for kern in ev.kernels:
            name = kern.name.lower()
            gemm = any(key in name for key in GEMM_KEYS)
            if "flash_fwd" in name:
                continue            # K2 launches through ctypes: read from the kernel table
            if label == "experts":
                part = "expert GEMMs" if gemm else "expert silu*h"
            elif label == "moe":
                part = "MoE routing and dispatch"
            elif label == "attention":
                part = "attention GEMMs" if gemm else "attention other"
            else:
                part = "other"
            parts[part] += kern.duration / n
    # the device kernels by name; the ranges' own spans on the device timeline
    # are not kernels
    table = {e.key: e.self_device_time_total / n for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in ranges}
    parts["K2"] = sum(us for name, us in table.items() if "flash_fwd" in name)
    return parts, sum(table.values())


def phase_moe_parts(device, cfg, params, reduced, batch=4):
    """The MoE eps forward at the one-shot shape (batch 4, seq 256): its
    time per NFE on both routes for both dispatch modes, then, on the
    kernel route, the device time by part, the idle share and the peak
    memory of each dispatch mode."""
    from repro_torch.diffusion import lm as DLM
    seq = 64 if reduced else 256
    gen = torch.Generator(device=device).manual_seed(12)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device=device)
    t = torch.full((batch,), 0.5, device=device)
    timed = _timer(device)
    n = 5 if device.type == "cuda" else 1
    ms = {}
    with torch.no_grad():
        for dispatch in ("einsum", "gather"):
            c = cfg.with_(moe_dispatch=dispatch)
            for use_kernels in (True, False):
                eps_fn = DLM.make_eps_fn(params, c, use_kernels=use_kernels)
                ms[dispatch, use_kernels] = timed(lambda: eps_fn(x, t), n=n, warm=1)
        print(f"eps forward per NFE of {cfg.name} at B={batch} S={seq}: "
              + "; ".join(f"{d} dispatch: kernel route {ms[d, True]:.3f} ms, plain route "
                          f"{ms[d, False]:.3f} ms" for d in ("einsum", "gather")))
        if device.type != "cuda":
            return ms
        for dispatch in ("einsum", "gather"):
            eps_fn = DLM.make_eps_fn(params, cfg.with_(moe_dispatch=dispatch), use_kernels=True)
            torch.cuda.reset_peak_memory_stats()
            parts, busy = _moe_parts_us(lambda: eps_fn(x, t), 2)
            peak = torch.cuda.max_memory_allocated() / 2**30
            wall = ms[dispatch, True]
            print(f"eps forward parts of {cfg.name}, {dispatch} dispatch, kernel route "
                  f"(torch.profiler, device ms per forward): busy {busy / 1e3:.3f} of "
                  f"{wall:.3f} ms (idle share {1 - busy / 1e3 / wall:.4f}); "
                  + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in parts.items())
                  + f"; not attributed {(busy - sum(parts.values())) / 1e3:.3f}; peak memory "
                  f"{peak:.2f} GiB")
    return ms


TRAIN_LR = 3e-4
GRAD_TOL = 1e-3     # card vs cpu grads: |diff| <= GRAD_TOL x the leaf's max |grad|
UPDATE_TOL = dict(rtol=1e-5, atol=1e-7)   # one AdamW update from the same grads
NLL_TOL = 0.02      # bits/dim at 32 kutta3 steps (tests/test_likelihood.py's bound)


def _train_parts_us(step_fn, n):
    """Device microseconds per call of ``step_fn`` (one train step) by part,
    from torch.profiler: kernels launched inside ``AdamW.update`` (in a
    range "optimizer" for the measurement) are the optimizer's, kernels of
    ops that autograd's engine runs (``autograd::engine::evaluate_function``)
    the backward's, the rest the forward's. Returns ({part: us}, busy us)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.optimizer import AdamW
    with _layer_ranges({"update": "optimizer"}, AdamW):
        step_fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step_fn()
            torch.cuda.synchronize()
    parts = dict.fromkeys(("forward", "backward", "optimizer"), 0.0)
    for ev in prof.events():
        if not ev.kernels:
            continue
        part, up = "forward", ev
        while up is not None:
            if up.name == "optimizer":
                part = "optimizer"
                break
            if up.name.startswith("autograd::engine::evaluate_function"):
                part = "backward"
                break
            up = up.cpu_parent
        parts[part] += sum(k.duration for k in ev.kernels) / n
    busy = sum(e.self_device_time_total / n for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key != "optimizer")
    return parts, busy


def _train_run(device, cfg, params, batch_n, seq, steps, opt, tag, gen_seed=1, mesh=None,
               fsdp=False, hooks=False, keep=False):
    """``steps`` train steps of ``make_train_step(cfg, opt)`` from a fresh
    optimizer state on the Markov corpus, each step timed with a device
    sync; then one more step under torch.profiler (device time by part).
    No kernel may launch (the train step runs the plain route, as the
    reference's). ``mesh``: the sharded step, params placed by
    ``param_specs`` (``fsdp``), the moments as their params, each batch by
    ``batch_specs``; ``hooks``: every step under the ZeRO-3 saved-tensor
    hooks (``tensor_parallel.regather_saved``) whatever it gathers. ``keep``:
    a copy of the params after the last timed step (before the profiled
    one). Returns the losses, grad norms and timings."""
    import statistics
    from repro_torch.data.pipeline import MarkovTextSource, device_put_sharded, make_batch
    from repro_torch.sharding import rules as R
    from repro_torch.sharding import tensor_parallel as TP
    from repro_torch.training.steps import make_train_step
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30 if device.type == "cuda" else float("nan")
    if mesh is not None:
        params = R.device_put(params, R.to_shardings(R.param_specs(params, mesh, fsdp=fsdp),
                                                     mesh))
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    if hooks:
        plain_step = step

        def step(*a):
            with TP.regather_saved():
                return plain_step(*a)
    src = MarkovTextSource(cfg.vocab_size, 0)
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    losses, gnorms, times = [], [], []
    _reset_counts()
    for i in range(steps):
        host = make_batch(cfg, src, i, batch_n, seq)
        if mesh is None:
            batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        else:
            batch = device_put_sharded(host, R.to_shardings(R.batch_specs(host, mesh), mesh),
                                       device)
        _sync(device)
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch, gen)
        _sync(device)
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    counts = _counts()
    if any(counts.values()):
        raise AssertionError(f"{tag}: the train step launched kernels {counts}; it runs "
                             "the plain route")
    if not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"{tag}: losses {losses} or grad norms {gnorms} not finite")
    med = statistics.median(times[1:] if len(times) > 1 else times) * 1e3
    peak = (torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda"
            else float("nan"))
    line = (f"train {tag}: {steps} steps at batch {batch_n}, seq {seq}: median step "
            f"{med:.3f} ms (first {times[0] * 1e3:.1f} ms), "
            f"{batch_n * seq / med * 1e3:.1f} tokens/s, peak memory {peak:.2f} GiB "
            f"({held:.2f} GiB held before the run); losses "
            + " ".join(f"{v:.4f}" for v in losses) + "; grad norms "
            + " ".join(f"{v:.3f}" for v in gnorms))
    out = dict(losses=losses, gnorms=gnorms, ms=med, peak=peak, state=state)
    if keep:
        from repro_torch.training.optimizer import tree_leaves
        out["after"] = [(p.full_tensor() if mesh is not None else p).clone()
                        for p in tree_leaves(params)]
    if device.type == "cuda":
        parts, busy = _train_parts_us(lambda: step(params, state, batch, gen), 1)
        line += (f"; device time per step (torch.profiler): busy {busy / 1e3:.3f} of "
                 f"{med:.3f} ms (idle share {1 - busy / 1e3 / med:.4f}), "
                 + ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in parts.items()))
        out.update(parts=parts, busy=busy)
    print(line)
    return out


def phase_sharded_train(device, cfg, params, reduced, steps=3):
    """The model-parallel train step at the model's width on a one-rank
    (NCCL on the card) host mesh {'data': 1, 'model': 1}: params, moments
    and batches as DTensors, every product on the local shards. First the
    unsharded step (``phase_train``'s: the same init, corpus and draws) on
    a copy of the weights, then the sharded step, the same under the
    ZeRO-3 saved-tensor hooks (forced on: their host cost), then the
    sharded step with ``fsdp`` (the port's ZeRO-3), each ``steps``
    diffusion steps at batch 4, seq 256 from the same weights: the losses
    and grad norms per step and the params after the last bitwise equal
    to the unsharded run's (largest differences printed); ms per
    step, tokens/s, device busy and idle share and the optimizer's device
    time (torch.profiler), peak memory. The weights are left as they were."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.convert import tree_map
    from repro_torch.sharding.rules import axis_sizes
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    batch_n, seq = (2, 16) if reduced else (4, 256)
    cfg = cfg.with_(objective="diffusion")
    opt = lambda: AdamW(cosine_schedule(TRAIN_LR, 1, 10))
    base = _train_run(device, cfg, tree_map(torch.clone, params), batch_n, seq, steps, opt(),
                      f"{cfg.name} unsharded (the sharded runs' reference)", keep=True)
    want = base.pop("after")
    del base["state"]
    runs = {"unsharded": base}
    with _one_rank_group(device):
        mesh = make_host_mesh(model=1)
        for tag, kw in (("sharded", {}), ("sharded hooks", dict(hooks=True)),
                        ("sharded fsdp", dict(fsdp=True))):
            run = _train_run(device, cfg, params, batch_n, seq, steps, opt(),
                             f"{cfg.name} {tag} on {axis_sizes(mesh)}", mesh=mesh, keep=True,
                             **kw)
            got = run.pop("after")
            del run["state"]
            d_loss = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], base["losses"]))
            d_gnorm = max(abs(a - b) / abs(b) for a, b in zip(run["gnorms"], base["gnorms"]))
            d_param = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            bitwise = run["losses"] == base["losses"] and run["gnorms"] == base["gnorms"] \
                and all(torch.equal(a, b) for a, b in zip(got, want))
            del got
            print(f"sharded train {tag}: against the unsharded run, losses rel {d_loss:.3e}, "
                  f"grad norms rel {d_gnorm:.3e}, params after step {steps} max abs "
                  f"{d_param:.3e} ({'bitwise' if bitwise else 'not bitwise'}); "
                  f"{run['ms']:.3f} ms a step against {base['ms']:.3f} "
                  f"({run['ms'] / base['ms']:.3f}x)")
            if not bitwise:     # one rank: the unsharded local shapes and products
                raise AssertionError(f"sharded train {tag} differs from the unsharded step")
            runs[tag] = run
    del want
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return runs


def phase_train(device, cfg, params, reduced, n_diffusion=5, n_ar=3):
    """The training path at the model's width (full-width gemma-2b on the
    card, on the weights of the earlier phases, which it then changes): a
    few train steps with the diffusion objective, then a few with the ar
    objective, each from a fresh AdamW state (cosine schedule, lr 3e-4), at
    batch 4, seq 256 of the Markov corpus. Prints ms per step (median,
    synchronised), tokens/s, peak memory and the device time by part."""
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    batch_n, seq = (2, 16) if reduced else (4, 256)
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"train {cfg.name}: {n_params / 1e9:.3f} B params ({cfg.dtype}), AdamW float32 "
          f"moments {2 * 4 * n_params / 1e9:.2f} GB, no remat")
    runs = {}
    for objective, steps in (("diffusion", n_diffusion), ("ar", n_ar)):
        opt = AdamW(cosine_schedule(TRAIN_LR, 1, 10))
        runs[objective] = _train_run(device, cfg.with_(objective=objective), params,
                                     batch_n, seq, steps, opt, f"{cfg.name} {objective}")
        del runs[objective]["state"]
    return runs


def phase_train_scorenet(device):
    """cifar10-scorenet at its published widths (4 layers, d_model 256,
    float32; vocab 256 as the reference's training test sets it), 30 steps
    of the diffusion objective at batch 16, seq 32, constant lr 3e-4 (the
    reference's ``test_loss_decreases_on_synthetic_corpus``): the loss must
    fall (the mean of the last 5 below the first 5). Then the
    ``(params, opt_state)`` checkpoint round trip at this width, bitwise."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training.optimizer import AdamW, constant_schedule
    cfg = get_config("cifar10_scorenet").with_(objective="diffusion", vocab_size=256)
    params = init_params(cfg, 0, device)
    opt = AdamW(constant_schedule(TRAIN_LR))
    run = _train_run(device, cfg, params, 16, 32, 30, opt, cfg.name)
    first, last = np.mean(run["losses"][:5]), np.mean(run["losses"][-5:])
    if not last < first:
        raise AssertionError(f"{cfg.name}: the loss did not fall: {run['losses']}")
    print(f"train {cfg.name}: loss fell from {first:.4f} (mean of steps 0-4) to {last:.4f} "
          "(steps 25-29)")
    state = run["state"]
    with tempfile.TemporaryDirectory() as d:
        CKPT.save(d, 30, (params, state), {"next_step": 30})
        like = (init_params(cfg, 1, device), opt.init(params))
        (p2, s2), meta = CKPT.restore(d, like)
    same = all(torch.equal(a, b) for a, b in zip(_leaves([params, state.m, state.v]),
                                                 _leaves([p2, s2.m, s2.v])))
    if not same or int(s2.step) != 30 or meta != {"next_step": 30}:
        raise AssertionError(f"{cfg.name}: the (params, opt_state) checkpoint did not "
                             "round-trip")
    print(f"checkpoint {cfg.name}: (params, opt_state) saved and restored bitwise (step 30)")


def phase_paper(device, reduced):
    """The paper's headline on this device (the port's examples/quickstart):
    an MLP score net trained on the 8-mode GMM in 2-D (1500 steps, batch
    512), then 1024 samples from one prior draw with ddim, tab1, tab2,
    tab3, rho_heun and ipndm3 at NFE 5/10/20/50 (quadratic steps), each
    against rho_rk4 on 400 log_rho steps; every ``ab`` plan fused, so K1
    runs one launch a step at x (1, 1024, 2) (counted from 0 before the
    table and asserted). Asserts tAB3@10 < DDIM@10, holds K1 at this shape
    against its plain version (direct calls, r 1..3, and the fused tab3
    solve against the unfused one), then the GMM likelihood at 8/16/32
    kutta3 steps (error falls, under 0.02 bits/dim at 32) and one
    ``AdaptiveRK23`` solve. Returns K1's launches, error and times."""
    from repro_torch.core import (AdaptiveRK23, VPSDE, get_timesteps, make_plan,
                                  nll_bits_per_dim, sample)
    from repro_torch.diffusion.analytic import default_gmm
    from repro_torch.diffusion.score_net import train_score_net
    from repro_torch.kernels import deis_step as K
    from repro_torch.kernels import ref
    sde = VPSDE()
    gmm = default_gmm(sde, d=2)
    steps = 300 if reduced else 1500
    t0 = time.perf_counter()
    model = train_score_net(sde, gmm.sample_data, 2, steps=steps, log_every=steps // 5,
                            device=device)
    _sync(device)
    print(f"paper: score net trained on the 8-mode GMM, {steps} steps of batch 512 in "
          f"{time.perf_counter() - t0:.1f} s")
    eps = model.eps_fn()
    gen = torch.Generator(device=device).manual_seed(0)
    x_T = torch.randn((1024, 2), generator=gen, device=device) * sde.prior_std()

    def plan(name, n, kind="quadratic", fused=True):
        p = make_plan(name, sde, get_timesteps(sde, n, kind)).to(device)
        return dataclasses.replace(p, fused=True) if fused and p.method == "ab" else p

    rms = lambda a, b: float(torch.sqrt(torch.mean((a - b) ** 2)))
    names, nfes = ("ddim", "tab1", "tab2", "tab3", "rho_heun", "ipndm3"), (5, 10, 20, 50)
    with torch.no_grad():
        ref_x = sample(plan("rho_rk4", 400, "log_rho"), eps, x_T)
        want_k1, errs = 0, {}
        _reset_counts()
        t0 = time.perf_counter()
        for name in names:
            for n in nfes:
                p = plan(name, n)
                want_k1 += p.n_steps if p.fused else 0
                errs[name, n] = rms(sample(p, eps, x_T), ref_x)
        _sync(device)
        wall = time.perf_counter() - t0
        counts = _counts()
        fused_tab3 = sample(plan("tab3", 10), eps, x_T)
        plain_tab3 = sample(plan("tab3", 10, fused=False), eps, x_T)
    print(f"paper: error table, RMS against rho_rk4 on 400 log_rho steps, 1024 samples "
          f"({wall:.2f} s for the table):")
    print(f"  {'solver':10s}" + "".join(f"  NFE={n:<4d}" for n in nfes))
    for name in names:
        print(f"  {name:10s}" + "".join(f"  {errs[name, n]:8.4f}" for n in nfes))
    if device.type == "cuda" and counts != {"K1": want_k1, "K2": 0, "K3": 0, "ssm_pre": 0,
                                            "ssm_post": 0, **dict.fromkeys(MOE_KEYS, 0)}:
        raise AssertionError(f"paper: the table launched {counts}, not K1 {want_k1}")
    if not errs["tab3", 10] < errs["ddim", 10]:
        raise AssertionError(f"paper: tAB3@10 {errs['tab3', 10]:.4f} did not beat DDIM@10 "
                             f"{errs['ddim', 10]:.4f}")
    counted = (f"K1 launches {counts['K1']} (= the fused ab steps {want_k1})"
               if device.type == "cuda" else "K1 not counted on the cpu")
    print(f"paper: @10 NFE tAB3 {errs['tab3', 10]:.4f} < DDIM {errs['ddim', 10]:.4f} "
          f"(the paper's headline) held; {counted} at x (1, 1024, 2)")
    # K1 at this shape against its plain version
    max_err = _max_err(fused_tab3, plain_tab3)
    torch.testing.assert_close(fused_tab3, plain_tab3, rtol=1e-5, atol=1e-5)
    kgen = torch.Generator(device=device).manual_seed(77)
    for r in (1, 2, 3):
        args, kw = _k1_inputs(kgen, device, 1, 1024, 2, r, False, r == 3)
        out, e = K.fused_ab_step(*args, **kw)
        want, want_e = ref.fused_ab_step_ref(*args, **kw)
        torch.testing.assert_close(out, want, rtol=K1_TOL, atol=K1_TOL)
        max_err = max(max_err, _max_err(out, want))
        if r == 3:
            torch.testing.assert_close(e, want_e, rtol=K1_TOL, atol=K1_TOL)
    args, kw = _k1_inputs(kgen, device, 1, 1024, 2, 3, False, False)
    nbytes = 5 * 1024 * 2 * 4 + 4 * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ms, plain_ms, _ = _kernel_times(device, "K1 at R=1 M=1024 D=2 r=3 (the score net's)",
                                    "fused_ab_kernel", lambda: K.fused_ab_step(*args, **kw),
                                    lambda: ref.fused_ab_step_ref(*args, **kw),
                                    n=200 if device.type == "cuda" else 5)
    print(f"K1 at (1, 1024, 2), r 1..3, within {K1_TOL}; fused vs unfused tab3@10 solve "
          f"max abs diff {_max_err(fused_tab3, plain_tab3):.3e} (limit 1e-5); byte bound "
          f"{bound_ms:.3e} ms ({nbytes} B)")
    # likelihood and adaptive stepping
    with torch.no_grad():
        x0 = gmm.sample_data(gen, 24, dtype=torch.float64)
        exact = float(-gmm.log_prob(x0).mean() / 2 / np.log(2.0))
        nll = {}
        t0 = time.perf_counter()
        for n in (8, 16, 32):
            nll[n] = abs(float(nll_bits_per_dim(sde, gmm.eps_fn(), x0, n_steps=n,
                                                method="kutta3").mean()) - exact)
        _sync(device)
        nll_s = time.perf_counter() - t0
        if not (nll[32] < nll[8] and nll[32] < NLL_TOL):
            raise AssertionError(f"paper: NLL errors {nll} do not fall below {NLL_TOL}")
        print(f"paper: GMM NLL, exact {exact:.4f} bits/dim; |error| at 8/16/32 kutta3 steps "
              + " ".join(f"{nll[n]:.5f}" for n in (8, 16, 32))
              + f" (limit {NLL_TOL} at 32) in {nll_s:.2f} s")
        res = AdaptiveRK23(sde).solve(eps, x_T)
        if not torch.isfinite(res.x0).all():
            raise AssertionError("paper: AdaptiveRK23 gave a non-finite x0")
        print(f"paper: AdaptiveRK23 (rtol = atol = 1e-2): NFE {res.nfe}, accepted "
              f"{res.n_accepted}, rejected {res.n_rejected}; RMS against rho_rk4 "
              f"{rms(res.x0, ref_x):.4f} (tAB3 at 10 NFE {errs['tab3', 10]:.4f})")
    return dict(launches=counts["K1"], max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms)


DRYRUN_KINDS = ("deis", "train")   # the card check's steps (B 4, S 256, full-width gemma-2b)
DRYRUN_PAIR = "gemma_deis"


def _dryrun_workload(kind, device, reduced, mesh):
    """The card check's step through the dry run's own workload on ``mesh``:
    one DEIS NFE (``make_deis_sample_step``) or the model-parallel train step
    of ``phase_sharded_train`` (no remat), gemma-2b at batch 4, seq 256."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun as D
    cfg = get_config("gemma_2b")
    cfg = (cfg.reduced() if reduced else cfg).with_(objective="diffusion")
    batch_n, seq = (2, 16) if reduced else (4, 256)
    return D.make_workload(cfg, ShapeConfig(f"card_{kind}", seq, batch_n, kind), mesh,
                           remat=False, device=device)


def dryrun_count_child(kind, device, reduced) -> int:
    """``chip_smoke.py --dryrun-count KIND``: the card check's step counted
    on fake tensors of ``device`` over a fake one-rank group (this process's
    only default group), printed as one JSON line."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    D.init_fake_world(1)
    try:
        mesh = make_host_mesh(model=1, device_type=device.type)
        with FakeTensorMode():
            fn, args, _ = _dryrun_workload(kind, device, reduced, mesh)
            costs = D.count_costs(fn, args, mesh)
        print(json.dumps(dict(costs, roofline=D.roofline(costs, mesh))))
    finally:
        dist.destroy_process_group()
    return 0


def _dryrun_cli(args, out):
    return _popen([sys.executable, "-m", *args, "--out", str(out)])


def _finish(proc, what, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}:\n{out[-3000:]}\n{err[-3000:]}")
    return out


def phase_dryrun(device, reduced, n=5):
    """The dry runs (``launch.dryrun`` / ``launch.hillclimb``), whose
    fake-process-group work runs in subprocesses (a process has one default
    group; this one's phases use NCCL and gloo groups):

    (a) the counts against the card: one DEIS NFE and one model-parallel
    train step of full-width gemma-2b at batch 4, seq 256, each built by
    ``make_workload`` on a one-rank NCCL mesh and counted on the card
    (``count_costs``) in this process, and on fake CUDA tensors over a fake
    one-rank group in a child: FLOPs, bytes and the collectives (counts
    and bytes per kind and axis) must be equal. Beside the modelled terms
    (``compute_s``, ``memory_s``, ``collective_s``: H100 SXM spec constants)
    the step's median device-synchronised ms (CUDA events, ``n`` runs after
    the counted one) and the fake ``peak_bytes`` beside
    ``torch.cuda.max_memory_allocated`` of the counted run.

    (b) the production mesh: ``python -m repro_torch.launch.dryrun --arch
    gemma_2b`` at ``deis_4k`` and ``train_4k`` over a fake 256-rank group
    (16 x 16) and ``python -m repro_torch.launch.hillclimb --pair
    gemma_deis``: status ok, FLOPs > 0, collectives counted, every variant
    present. Returns the phase's wall seconds."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import hillclimb as H
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    out = ROOT / "build" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    dev = ["--device", device.type]
    flags = dev + (["--reduced"] if reduced else [])
    children = {kind: _popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-count",
                              kind, *flags]) for kind in DRYRUN_KINDS}
    clis = {shape: _dryrun_cli(["repro_torch.launch.dryrun", "--arch", "gemma_2b", "--shape",
                                shape, *dev], out / f"{shape}.jsonl")
            for shape in ("deis_4k", "train_4k")}
    clis["hillclimb"] = _dryrun_cli(["repro_torch.launch.hillclimb", "--pair", DRYRUN_PAIR,
                                     *dev], out / "hillclimb.json")
    atexit.register(_stop, list(children.values()) + list(clis.values()))
    real = {}
    with _one_rank_group(device):
        mesh = make_host_mesh(model=1)
        for kind in DRYRUN_KINDS:
            fn, args, _ = _dryrun_workload(kind, device, reduced, mesh)
            if device.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            costs = D.count_costs(fn, args, mesh)
            peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
            times = []
            if device.type == "cuda":
                for _ in range(n):
                    start, end = torch.cuda.Event(enable_timing=True), \
                        torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn(*args)
                    end.record()
                    torch.cuda.synchronize()
                    times.append(start.elapsed_time(end))
            real[kind] = dict(costs, roofline=D.roofline(costs, mesh), peak=peak,
                              ms=float(np.median(times)) if times else None)
            del fn, args
            if device.type == "cuda":
                torch.cuda.empty_cache()
    for kind in DRYRUN_KINDS:
        fake = json.loads(_finish(children[kind], f"the fake {kind} count").strip()
                          .splitlines()[-1])
        got = real[kind]
        for key in ("flops", "bytes", "collectives"):
            if fake[key] != got[key]:
                raise AssertionError(f"dry run {kind}: fake {key} {fake[key]} differs from "
                                     f"the real step's {got[key]}")
        terms = fake["roofline"]
        modelled = sum(v for v in terms.values() if v is not None) * 1e3
        ms = "not measured (cpu)" if got["ms"] is None else f"{got['ms']:.3f} ms"
        peak = ("not measured (cpu)" if got["peak"] is None
                else f"{got['peak'] / 2**30:.3f} GiB")
        print(f"dryrun card check {kind}: flops {got['flops']:.6e}, bytes "
              f"{got['bytes']:.6e}, collectives {got['collectives']['counts']} "
              f"({got['collectives']['total']:.0f} bytes, by axis "
              f"{got['collectives']['by_axis']}): fake == real; measured median {ms} "
              f"(CUDA events, {n} runs) beside modelled compute_s "
              f"{terms['compute_s'] * 1e3:.3f} ms, memory_s {terms['memory_s'] * 1e3:.3f} "
              f"ms, collective_s {terms['collective_s'] * 1e3:.3f} ms (sum {modelled:.3f} "
              f"ms); fake peak_bytes {fake['memory']['peak_bytes'] / 2**30:.3f} GiB beside "
              f"max_memory_allocated {peak}")
    for shape, proc in clis.items():
        _finish(proc, f"dryrun {shape}")
    for shape in ("deis_4k", "train_4k"):
        (rec,) = [json.loads(line) for line in (out / f"{shape}.jsonl").read_text().splitlines()]
        if rec["status"] != "ok" or not rec["flops_per_device"] > 0 or \
                not sum(rec["collectives"]["counts"].values()) or rec["devices"] != 256:
            raise AssertionError(f"dryrun gemma_2b {shape}: {rec}")
        print(f"dryrun gemma_2b {shape} on {rec['mesh']} ({rec['devices']} fake ranks): "
              f"flops/device {rec['flops_per_device']:.4e}, bytes/device "
              f"{rec['bytes_per_device']:.4e}, collectives {rec['collectives']['counts']} "
              f"by axis {rec['collectives']['by_axis']}, peak "
              f"{rec['memory']['peak_bytes'] / 1e9:.1f} GB, roofline {rec['roofline']} "
              f"(modelled), bottleneck {rec['bottleneck']}; {rec['compile_s']} s")
    hc = json.loads((out / "hillclimb.json").read_text())
    names = [it["name"] for it in hc["iterations"]]
    want = [v[0] for v in H.PAIRS[DRYRUN_PAIR]["variants"]]
    if names != want or hc["baseline"]["status"] != "ok" or \
            any(it["result"]["status"] != "ok" for it in hc["iterations"]):
        raise AssertionError(f"hillclimb {DRYRUN_PAIR}: variants {names}, want {want}")
    print(f"hillclimb {DRYRUN_PAIR}: " + "; ".join(
        f"{it['name']} {it['ratio_vs_baseline']}" for it in hc["iterations"]))
    secs = time.perf_counter() - t0
    print(f"dryrun phase: {secs:.1f} s")
    return secs


def _analysis(*args):
    """``python -m repro_torch.analysis ARGS --json``: (exit code, report)."""
    proc = _popen([sys.executable, "-m", "repro_torch.analysis", *args, "--json"])
    out, err = proc.communicate(timeout=300)
    if proc.returncode not in (0, 1):
        raise AssertionError(f"the analyzer exited {proc.returncode}:\n{err[-3000:]}")
    return proc.returncode, json.loads(out)


def phase_analysis():
    """The port's static analyzer, in subprocesses (see the module
    docstring, phase 17)."""
    t0 = time.perf_counter()
    pkg = SRC / "repro_torch"
    out = ROOT / "build" / "analysis"
    out.mkdir(parents=True, exist_ok=True)
    bench_path = out / "BENCH_static.json"
    code, rep = _analysis(str(pkg), "--bench", str(bench_path))
    files = len(list(pkg.rglob("*.py")))
    active = {r: n for r, n in rep["counts"].items() if n}
    rec = json.loads(bench_path.read_text())
    assert code == 0 and not active, f"analysis of {pkg}: exit {code}, active {active}"
    assert rep["files"] == rec["metrics"]["static.files"]["value"] == files, \
        (rep["files"], rec["metrics"]["static.files"], files)
    for name, (rule, n) in ANALYSIS_CASES.items():
        code, bad = _analysis(str(ANALYSIS_FIXTURES / name))
        fired = {r: k for r, k in bad["counts"].items() if k}
        assert code == 1 and fired == {rule: n}, f"{name}: exit {code}, {fired}, want {rule} x {n}"
    print(f"analysis: {files} files, 0 active, allowed by rule {rep['allowed_counts']}; "
          f"{len(ANALYSIS_CASES)} bad fixtures fire their rules exactly "
          f"({time.perf_counter() - t0:.2f} s)")


def _train_step_card_vs_cpu(device):
    """One train step of each arch type (dense gemma, ssm mamba2, moe
    mixtral, hybrid jamba, encdec whisper with frames, vlm paligemma with a
    prefix; the diffusion objective, and the ar objective on gemma) at the
    reduced float32 config, from the same params, batch and t / eps on the
    card and on the CPU: the loss (rtol 1e-5), every grad (within GRAD_TOL
    of the leaf's max |grad|), and the AdamW update of the card's grads
    on the card against the same update on the CPU (UPDATE_TOL); then one
    ``train_step`` on the card, finite."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovTextSource, make_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.training import optimizer as O
    from repro_torch.training.steps import make_loss_fn, make_train_step
    cases = [(a, "diffusion") for a in ("gemma_2b", "mamba2_2p7b", "mixtral_8x7b",
                                        "jamba_1p5_large", "whisper_tiny", "paligemma_3b")]
    for arch, objective in cases + [("gemma_2b", "ar")]:
        cfg = get_config(arch).reduced().with_(objective=objective)
        p_cpu = init_params(cfg, 6, "cpu")
        p_dev = _to(p_cpu, device)
        b_cpu = {k: torch.from_numpy(v) for k, v in
                 make_batch(cfg, MarkovTextSource(cfg.vocab_size, 0), 0, 2, 16).items()}
        b_dev = {k: v.to(device) for k, v in b_cpu.items()}
        g = torch.Generator().manual_seed(8)
        draws = {} if objective == "ar" else {
            "t": torch.rand((2,), generator=g) * 0.999 + 1e-3,
            "eps": torch.randn((2, 16, cfg.d_model), generator=g)}
        loss_fn = make_loss_fn(cfg)
        (l_cpu, _), g_cpu = O.value_and_grad(loss_fn, p_cpu, b_cpu, has_aux=True, **draws)
        (l_dev, _), g_dev = O.value_and_grad(loss_fn, p_dev, b_dev, has_aux=True,
                                             **{k: v.to(device) for k, v in draws.items()})
        np.testing.assert_allclose(float(l_dev), float(l_cpu), rtol=1e-5)
        worst = 0.0
        for a, b in zip(O.tree_leaves(g_dev), O.tree_leaves(g_cpu)):
            scale = max(b.abs().max().item(), 1e-30)
            worst = max(worst, (a.cpu() - b).abs().max().item() / scale)
        if worst > GRAD_TOL:
            raise AssertionError(f"{arch} {objective}: card grads differ by {worst:.3e} of "
                                 f"the leaf's max |grad|")
        opt = O.AdamW(O.cosine_schedule(1e-3, 1, 10))
        u_cpu = O.tree_map(torch.clone, p_cpu)
        u_dev = O.tree_map(torch.clone, p_dev)
        opt.update(O.tree_map(lambda t: t.cpu(), g_dev), opt.init(u_cpu), u_cpu)
        opt.update(g_dev, opt.init(u_dev), u_dev)
        upd = 0.0
        for a, b in zip(O.tree_leaves(u_dev), O.tree_leaves(u_cpu)):
            torch.testing.assert_close(a.cpu(), b, **UPDATE_TOL)
            upd = max(upd, (a.cpu() - b).abs().max().item())
        _, _, m = make_train_step(cfg, opt)(p_dev, opt.init(p_dev), b_dev,
                                            **{k: v.to(device) for k, v in draws.items()})
        if not all(torch.isfinite(v) for v in m.values()):
            raise AssertionError(f"{arch} {objective}: card train step not finite: {m}")
        cond = "".join(f", {k} {tuple(v.shape)}" for k, v in b_cpu.items() if k != "tokens")
        print(f"card vs cpu (reduced float32 {cfg.name}, one {objective} train step, batch "
              f"(2, 16){cond}): loss {float(l_dev):.6f} vs {float(l_cpu):.6f}; grads within "
              f"{worst:.3e} of each leaf's max |grad| (limit {GRAD_TOL}); AdamW update of "
              f"the same grads max abs diff {upd:.3e}")


def _cld_card_vs_cpu(device):
    """CLD's matrix tAB-DEIS (order 2, 16 steps) and its fine RK4 reference
    (200 steps) on the exactly-scored Gaussian problem, float64 on the card
    against the CPU (rtol 1e-10: matrix products in another order)."""
    from repro_torch.core.matrix_sde import (CLD, CLDGaussianOracle, cld_reference,
                                             cld_sample)
    cld = CLD()
    orc = CLDGaussianOracle(cld, mean=1.0, var=0.25)
    m_t, s_t = orc._moments(1.0)
    z_T = torch.from_numpy(m_t + np.random.RandomState(0).randn(128, 2)
                           @ np.linalg.cholesky(s_t).T)
    ts = np.linspace(cld.T, cld.t0, 17)
    out = {}
    for dev in ("cpu", device):
        z = z_T.to(dev)
        out[str(dev)] = (cld_sample(cld, ts, 2, orc.eps_fn(), z).cpu(),
                         cld_reference(cld, orc.eps_fn(), z, n_steps=200).cpu())
    (s_cpu, r_cpu), (s_dev, r_dev) = out["cpu"], out[str(device)]
    for a, b in ((s_dev, s_cpu), (r_dev, r_cpu)):
        if not torch.isfinite(a).all():
            raise AssertionError("CLD on the card: not finite")
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
    print(f"card vs cpu (CLD matrix tAB-DEIS order 2, 16 steps, z (128, 2) float64): max abs "
          f"diff {(s_dev - s_cpu).abs().max().item():.3e}, its RK4 reference (200 steps) "
          f"{(r_dev - r_cpu).abs().max().item():.3e} (rtol 1e-10); RMS of the 16-step "
          f"sample against the reference {float(torch.sqrt(((s_cpu - r_cpu) ** 2).mean())):.4f}")


def _train_cli_cmd(device, reduced, sharded=False):
    """``python -m repro_torch.launch.train --arch gemma_2b --steps 3 --batch 4
    --seq 256`` (full width on the card); ``sharded``: the same under
    ``torchrun --standalone --nproc_per_node=1`` with ``--model-parallel 1``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gemma_2b",
           "--steps", "3"]
    if sharded:
        cmd[1:3] = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
                    "-m", "repro_torch.launch.train"]
        cmd += ["--model-parallel", "1"]
    cmd += ["--batch", "2", "--seq", "16"] if reduced else ["--batch", "4", "--seq", "256"]
    if device.type != "cuda":
        cmd += ["--device", "cpu"]
    if reduced:
        cmd += ["--reduced"]
    return cmd


def _popen(cmd, **env):
    env = dict(os.environ, **env, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    print("cli: " + " ".join(cmd[1:]))
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)


def start_train_clis(device, reduced):
    """The train launcher as a subprocess; once it has exited (the two
    would not fit the card together), the same run under torchrun on a
    one-rank mesh (the sharded launcher), from a thread."""
    import threading
    t0 = time.perf_counter()
    first = _popen(_train_cli_cmd(device, reduced))
    got = {"procs": [first]}
    # torchrun would set one CPU thread; the same count as this process keeps
    # the CPU rehearsal's summation order (and so its loss lines) the same
    threads = str(torch.get_num_threads())

    def chain():
        got["first"] = first.communicate(timeout=600) + (time.perf_counter() - t0,)
        got["t1"] = time.perf_counter()
        got["procs"].append(_popen(_train_cli_cmd(device, reduced, sharded=True),
                                   OMP_NUM_THREADS=threads))
    thread = threading.Thread(target=chain, daemon=True)
    thread.start()
    return thread, got


def _step_lines(out):
    return re.findall(r"^(step +\d+ loss=\S+ gnorm=\S+)", out, re.M)


def finish_train_clis(thread, got):
    """The train launcher: exit 0, a finite loss on each of its 3 step
    lines, and its summary line. The sharded launcher after it: exit 0, the
    one-rank mesh line, and the same step lines (loss and grad norm as
    printed)."""
    thread.join(timeout=660)
    out, err, secs = got["first"]
    first = got["procs"][0]
    losses = [float(v) for v in re.findall(r"^step +\d+ loss=(\S+)", out, re.M)]
    done = [ln for ln in out.splitlines() if ln.startswith("trained ")]
    if first.returncode != 0 or len(losses) != 3 or not np.isfinite(losses).all() or not done:
        raise AssertionError(f"the train launcher exited {first.returncode}:\n{out[-2000:]}\n"
                             f"{err[-2000:]}")
    print(f"cli: train exit 0 after {secs:.1f} s (process start, init and 3 steps, beside "
          f"the card-vs-cpu phase and the serving cli); losses {losses}; {done[-1]}")
    proc = got["procs"][1]
    out2, err2 = proc.communicate(timeout=600)
    mesh = "mesh={'data': 1, 'model': 1}"
    done2 = [ln for ln in out2.splitlines() if ln.startswith("trained ")]
    if proc.returncode != 0 or mesh not in out2 or not done2 or \
            _step_lines(out2) != _step_lines(out):
        raise AssertionError(f"the sharded train launcher exited {proc.returncode} (step lines "
                             f"{_step_lines(out2)} vs {_step_lines(out)}):\n{out2[-2000:]}\n"
                             f"{err2[-2000:]}")
    print(f"cli: torchrun train --model-parallel 1 exit 0 after "
          f"{time.perf_counter() - got['t1']:.1f} s (after the train cli); {mesh}; its 3 "
          f"step lines equal to the unsharded launcher's; {done2[-1]}")


CPU_TRAIN_TOL = {"loss": 1.5e-4, "gnorm": 1.5e-3}   # one unit of the printed digit


def start_cpu_train_ranks():
    """``torchrun --standalone --nproc_per_node=4 -m repro_torch.launch.train
    --arch gemma_2b --device cpu --reduced --model-parallel 2`` (a (2, 2)
    mesh of gloo ranks on this machine's CPU) and the unsharded CPU
    launcher with the same flags, as subprocesses."""
    flags = ["--arch", "gemma_2b", "--device", "cpu", "--reduced", "--steps", "3",
             "--batch", "4", "--seq", "16"]
    env = dict(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [_popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc_per_node=4", "-m", "repro_torch.launch.train", *flags,
                     "--model-parallel", "2"], **env),
             _popen([sys.executable, "-m", "repro_torch.launch.train", *flags], **env)]
    atexit.register(_stop, procs)
    return procs, time.perf_counter()


def finish_cpu_train_ranks(procs, t0):
    """Both exit 0; the sharded run prints the (2, 2) mesh and step lines
    within one printed digit of the unsharded run's."""
    (sharded, out, err), (_, want, err_w) = [(p,) + p.communicate(timeout=600) for p in procs]
    num = lambda text: [tuple(map(float, m)) for m in
                        re.findall(r"^step +\d+ loss=(\S+) gnorm=(\S+)", text, re.M)]
    got, ref = num(out), num(want)
    ok = len(got) == len(ref) == 3 and all(
        abs(a[0] - b[0]) <= CPU_TRAIN_TOL["loss"] and abs(a[1] - b[1]) <= CPU_TRAIN_TOL["gnorm"]
        for a, b in zip(got, ref))
    if any(p.returncode for p in procs) or "mesh={'data': 2, 'model': 2}" not in out or not ok:
        raise AssertionError(f"the CPU train ranks: {got} vs {ref}:\n{out[-2000:]}\n"
                             f"{err[-3000:]}\n{err_w[-1000:]}")
    print(f"cpu train ranks: 4 gloo ranks on a (2, 2) mesh (torch {torch.__version__}), "
          f"losses and grad norms {got} within {CPU_TRAIN_TOL} of the unsharded CPU "
          f"launcher's {ref}; {time.perf_counter() - t0:.1f} s")


def phase_card_vs_cpu(device):
    """The reduced float32 models on the card against the same models on the
    CPU (plain versions): finite x0 of the right shape that agree (gemma's
    served stream; the one-shot route of gemma, mamba2, jamba, mixtral,
    whisper (frames), paligemma (a prefix) and the published-width
    float32 cifar10-scorenet on the kernels, grok on the plain route), and
    the AR decode of gemma, mamba2, h2o (the ring), jamba (a mixed cache),
    whisper (a cross cache) and paligemma (a prefix). The float32 one-shot
    kernel route is the 3xTF32 kernels' path (every launch asserted on
    tf32x3): returns the launches there by route ({"K2": {route: n}, "K3":
    {route: n}})."""
    from repro_torch.kernels import flash_attention, ssd_scan
    f32_launches = {"K2": dict.fromkeys(flash_attention.ROUTES, 0),
                    "K3": dict.fromkeys(ssd_scan.ROUTES, 0)}
    if device.type != "cuda":
        return f32_launches
    from repro_torch.configs import get_config
    from repro_torch.core import VPSDE, get_timesteps, make_plan, stack_plans
    from repro_torch.diffusion import lm as DLM
    from repro_torch.models.transformer import init_params
    cfg = get_config("gemma_2b").reduced().with_(objective="diffusion")
    sde = VPSDE()
    p_cpu = init_params(cfg, 3, "cpu")
    p_dev = {k: _to(v, device) for k, v in p_cpu.items()}
    plan = make_plan("tab3", sde, get_timesteps(sde, 8), error_estimate=True)
    plan = stack_plans([dataclasses.replace(plan, fused=True)] * 2)
    x_T = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(5))
    _, x_cpu = DLM.sample_tokens_stream(p_cpu, cfg, plan, None, seq_len=16,
                                        prior_std=1.0, x_T=x_T)
    _, x_dev = DLM.sample_tokens_stream(p_dev, cfg, plan, None, seq_len=16,
                                        prior_std=1.0, x_T=x_T.to(device))
    x_dev = x_dev.cpu()
    if x_dev.shape != (2, 16, cfg.d_model) or not torch.isfinite(x_dev).all():
        raise AssertionError("card x0 has the wrong shape or is not finite")
    diff = (x_dev - x_cpu).abs().max().item()
    torch.testing.assert_close(x_dev, x_cpu, rtol=CARD_VS_CPU_TOL, atol=CARD_VS_CPU_TOL)
    print(f"card vs cpu (reduced float32 gemma, fused tab3, 8 steps): max abs x0 "
          f"diff {diff:.3e} within {CARD_VS_CPU_TOL}")
    # the one-shot route: K2 / K3 and K1 on the card, plain versions on the cpu;
    # grok (logit softcap, which K2 lacks) on the plain route
    from repro_torch.models.transformer import _layer_kind
    for arch, use_kernels, dispatch, reduced in (
            ("gemma_2b", True, "einsum", True), ("mamba2_2p7b", True, "einsum", True),
            ("jamba_1p5_large", True, "einsum", True), ("mixtral_8x7b", True, "einsum", True),
            ("mixtral_8x7b", True, "gather", True), ("grok_1_314b", False, "einsum", True),
            ("whisper_tiny", True, "einsum", True), ("paligemma_3b", True, "einsum", True),
            ("cifar10_scorenet", True, "einsum", False)):
        cfg = get_config(arch)
        cfg = (cfg.reduced() if reduced else cfg).with_(objective="diffusion",
                                                         moe_dispatch=dispatch)
        p_cpu = init_params(cfg, 4, "cpu")
        p_dev = _to(p_cpu, device)
        plan = dataclasses.replace(make_plan("tab3", sde, get_timesteps(sde, 6)), fused=True)
        x_T = torch.randn((2, 40, cfg.d_model), generator=torch.Generator().manual_seed(6))
        c_cpu = _cond(cfg, "cpu", batch=2)
        c_dev = {k: v.to(device) for k, v in c_cpu.items()}
        _reset_counts()
        t_dev, x_dev = DLM.sample_tokens(p_dev, cfg, plan, None, batch=2, seq_len=40,
                                         prior_std=1.0, use_kernels=use_kernels,
                                         x_T=x_T.to(device), **c_dev)
        counts, routes = _counts(), _route_counts()
        t_cpu, x_cpu = DLM.sample_tokens(p_cpu, cfg, plan, None, batch=2, seq_len=40,
                                         prior_std=1.0, use_kernels=use_kernels, x_T=x_T,
                                         **c_cpu)
        x_dev = x_dev.cpu()
        kinds = [_layer_kind(cfg, i)[0] for i in range(cfg.n_layers)]
        want = {"K1": 6, "K2": 6 * kinds.count("attn") * use_kernels,
                "K3": 6 * kinds.count("ssm") * use_kernels}
        want["ssm_pre"] = want["ssm_post"] = want["K3"]
        n_moe = [_layer_kind(cfg, i)[1] for i in range(cfg.n_layers)].count("moe")
        want.update(dict.fromkeys(MOE_KEYS, 6 * n_moe * use_kernels))
        mixers = [m for m in ("K2", "K3") if want[m]]
        if not torch.isfinite(x_dev).all() or counts != want:
            raise AssertionError(f"{arch}: card route not finite or launched {counts}, "
                                 f"not {want}")
        for m in mixers:
            if routes[m] != {"cuda_cores": 0, "mma_sync": 0, "wgmma": 0, "tf32x3": counts[m]}:
                raise AssertionError(f"{arch}: float32 {m} took the routes {routes[m]}, not "
                                     f"tf32x3 {counts[m]} times")
            for r, n in routes[m].items():
                f32_launches[m][r] += n
        torch.testing.assert_close(x_dev, x_cpu, rtol=CARD_VS_CPU_TOL, atol=CARD_VS_CPU_TOL)
        what = (f"{dispatch} dispatch, " if cfg.moe else "") + \
            ("kernel route" if use_kernels else "plain route (logit softcap)") + \
            "".join(f", {k} {tuple(v.shape)}" for k, v in c_cpu.items())
        size = "reduced" if reduced else "published-width"
        print(f"card vs cpu ({size} float32 {cfg.name}, one-shot {what}, fused tab3, "
              f"6 steps, seq 40; launches {counts}"
              + "".join(f", {m} by route {routes[m]}" for m in mixers)
              + f"): max abs x0 diff {(x_dev - x_cpu).abs().max().item():.3e} within "
              f"{CARD_VS_CPU_TOL}, equal tokens {(t_dev.cpu() == t_cpu).float().mean().item():.4f}")
    # autoregressive decode: prefill, then teacher-forced decode steps
    from repro_torch.serving.engine import ARServeEngine, Request
    for arch in ("gemma_2b", "mamba2_2p7b", "h2o_danube_3_4b", "jamba_1p5_large",
                 "whisper_tiny", "paligemma_3b"):
        cfg = get_config(arch).reduced().with_(objective="ar")
        p_cpu = init_params(cfg, 5, "cpu")
        p_dev = _to(p_cpu, device)
        seq = torch.from_numpy(np.random.RandomState(8).randint(0, cfg.vocab_size, (2, 48)))
        c_cpu = _cond(cfg, "cpu", batch=2)
        c_dev = {k: v.to(device) for k, v in c_cpu.items()}
        lg_cpu = _ar_decode_logits(cfg, p_cpu, seq, 40, c_cpu)
        lg_dev = _ar_decode_logits(cfg, p_dev, seq.to(device), 40, c_dev).cpu()
        if lg_dev.shape != (2, 9, cfg.vocab_size) or not torch.isfinite(lg_dev).all():
            raise AssertionError(f"{arch}: card AR logits {tuple(lg_dev.shape)} not finite or "
                                 "of the wrong shape")
        torch.testing.assert_close(lg_dev, lg_cpu, rtol=CARD_VS_CPU_TOL, atol=CARD_VS_CPU_TOL)
        ring = f", a ring of {cfg.sliding_window} slots" if cfg.sliding_window else ""
        if cfg.arch_type == "hybrid":
            ring = ", a cache of 7 ssm layers and 1 attention layer"
        ring += "".join(f", {k} {tuple(v.shape)}" for k, v in c_cpu.items())
        engine = "the engines take no frames"
        if cfg.arch_type != "encdec":
            reqs = [Request(uid=0, prompt=seq[0, :40].numpy(), max_new_tokens=8)]
            t_dev = ARServeEngine(p_dev, cfg, max_len=48, device=device).serve(reqs)[0].tokens
            t_cpu = ARServeEngine(p_cpu, cfg, max_len=48, device="cpu").serve(reqs)[0].tokens
            engine = f"ARServeEngine greedy tokens equal {float(np.mean(t_dev == t_cpu)):.4f}"
        print(f"card vs cpu (reduced float32 {cfg.name}, AR: prefill 40 tokens{ring}, 8 "
              f"decode steps): max abs logit diff {(lg_dev - lg_cpu).abs().max().item():.3e} "
              f"within {CARD_VS_CPU_TOL}; {engine}")
    _train_step_card_vs_cpu(device)
    _cld_card_vs_cpu(device)
    return f32_launches


def _to(tree, device, dtype=None):
    """The tree on ``device``; floating leaves cast to ``dtype`` when given."""
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device, dtype) for v in tree]
    return tree.to(device, dtype) if dtype is not None and tree.is_floating_point() \
        else tree.to(device)


def start_cli(device, reduced):
    """``python -m repro_torch.launch.serve --arch gemma_2b --transport driver
    --requests 6 --seq-len 128`` as a subprocess (full width on the card)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma_2b",
           "--transport", "driver", "--requests", "6", "--seq-len", "128"]
    if device.type != "cuda":
        cmd += ["--device", "cpu"]
    if reduced:
        cmd += ["--reduced"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    print("cli: " + " ".join(cmd[1:]))
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env), time.perf_counter()


def finish_cli(proc, t0):
    """Wait for the launcher: exit 0 and its ``served 6 requests`` line."""
    out, err = proc.communicate(timeout=600)
    served = [ln for ln in out.splitlines() if ln.startswith("served ")]
    if proc.returncode != 0 or not served or not served[-1].startswith("served 6 requests"):
        raise AssertionError(f"the launcher exited {proc.returncode}:\n{out[-2000:]}\n"
                             f"{err[-2000:]}")
    stats = served[-1].split("stats=")[-1]
    print(f"cli: exit 0 after {time.perf_counter() - t0:.1f} s (process start, init and "
          f"serve); {served[-1].split(';')[0]}; stats {stats}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced float32 model (rehearsal)")
    ap.add_argument("--dryrun-count", choices=DRYRUN_KINDS, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    if args.dryrun_count:
        return dryrun_count_child(args.dryrun_count, torch.device(args.device), args.reduced)

    device = torch.device(args.device)
    t_start = time.perf_counter()
    t_phase = [t_start]

    def lap(name):
        now = time.perf_counter()
        print(f"[{name}: {now - t_phase[0]:.1f} s]")
        t_phase[0] = now
    kind, count = phase_device(device)
    phase_build(device)
    lap("device and build")
    k1 = phase_k1(device)
    k2 = phase_k2(device)
    k3 = phase_k3(device)
    pw = phase_ssm_pointwise(device)
    md = phase_moe_dispatch(device)
    phase_scaling(device)
    phase_stress(device)
    lap("kernels")
    # each path's launches: the counts are set to 0 just before it and read after
    cfg, params = _init_model("gemma_2b", device, args.reduced)
    sde, launches = phase_serve(device, cfg, params)
    phase_step_breakdown(device, cfg, params, sde, k1)
    phase_batch_invariance(device, cfg, params, sde)
    lap("serve")
    sharded_launches, dp_cli_tokens = phase_sharded_serve(device, cfg, params, sde)
    lap("sharded serve")
    phase_http(device, cfg, params, sde, args.reduced)
    lap("http")
    gemma = phase_one_shot(device, cfg, params, args.reduced)
    lap("one-shot gemma")
    phase_ar(device, cfg, params, args.reduced)
    lap("ar gemma")
    phase_sharded_train(device, cfg, params, args.reduced)
    lap("sharded train gemma")
    phase_train(device, cfg, params, args.reduced)    # trains these weights: last on gemma
    lap("train gemma")
    del params
    cfg, params = _init_model("mamba2_2p7b", device, args.reduced)
    mamba = phase_one_shot(device, cfg, params, args.reduced)
    lap("one-shot mamba2")
    phase_ar(device, cfg, params, args.reduced)
    lap("ar mamba2")
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # mixtral-8x7b at its published widths, 8 of its 32 layers (11.9 B
    # parameters, 23.8 GB in bf16; all 32 would be 93 GB)
    cfg, params = _init_model("mixtral_8x7b", device, args.reduced, n_layers=8)
    _, served = phase_serve(device, cfg, params)
    launches += served
    phase_batch_invariance(device, cfg, params, sde)
    lap("serve mixtral")
    mixtral = phase_one_shot(device, cfg, params, args.reduced)
    phase_moe_parts(device, cfg, params, args.reduced)
    lap("one-shot mixtral")
    phase_expert_parallel(device, cfg, params)
    lap("expert parallel mixtral")
    cf100 = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
    print(f"ar {cfg.name} at capacity_factor 100: no (token, choice) pair drops on either "
          "path (at 1.25 the full forward would drop pairs that a decode step keeps)")
    phase_ar(device, cf100, params, args.reduced, vs_f32=args.reduced)
    phase_ar_f32(device, cf100, params)
    lap("ar mixtral")
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # granite-4.0-h-small whole (40 layers, 32.2 B parameters, 64.5 GB in
    # bf16): K2 on its 4 NoPE attention layers, K3 and both SSM passes
    # (the norm gate-first) on its 36 mixers
    # its kernel route is held to its plain route's x0 within the x0_rel limit
    # that the benchmark's cell holds it to against the float32 reference
    cell = json.loads((ROOT / "chipbench/cells/granite-4.0-h-small.oneshot_tab3.json").read_text())
    cfg, params = _init_model("granite_4p0_h_small", device, args.reduced)
    granite = phase_one_shot(device, cfg, params, args.reduced,
                             x0_rel_tol=cell["check"]["limits"]["x0_rel"])
    lap("one-shot granite")
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # whisper-tiny and paligemma-3b at their published widths, conditioned on
    # frames and an image prefix drawn from a seed
    cond_paths = {}
    for arch in ("whisper_tiny", "paligemma_3b"):
        cfg, params = _init_model(arch, device, args.reduced)
        cond = _cond(cfg, device)
        cond_paths[arch] = phase_one_shot(device, cfg, params, args.reduced, cond=cond)
        lap(f"one-shot {cfg.name}")
        phase_ar_cond(device, cfg, params, cond)
        lap(f"ar {cfg.name}")
        del params, cond
        if device.type == "cuda":
            torch.cuda.empty_cache()
    phase_train_scorenet(device)
    lap("train cifar10-scorenet")
    paper = phase_paper(device, args.reduced)
    lap("paper")
    phase_dryrun(device, args.reduced)
    lap("dry run")
    phase_analysis()
    lap("analysis")
    # the CPU ranks start here, beside the card-vs-cpu phase: earlier they
    # would share the host with the timed serving phases
    cpu_ranks = start_cpu_ranks()
    cpu_train = start_cpu_train_ranks()
    clis = [start_cli(device, args.reduced), start_dp_cli(device, args.reduced)]
    train_clis = start_train_clis(device, args.reduced)
    try:
        f32_path = phase_card_vs_cpu(device)
        lap("card vs cpu")
        finish_cli(*clis[0])
        finish_dp_cli(*clis[1], dp_cli_tokens)
        finish_cpu_ranks(*cpu_ranks)
        finish_cpu_train_ranks(*cpu_train)
        finish_train_clis(*train_clis)
        lap("clis and cpu ranks (after card vs cpu)")
    finally:
        train_clis[0].join(timeout=660)
        _stop([proc for proc, _ in clis] + cpu_ranks[0] + cpu_train[0] +
              train_clis[1]["procs"])
    print(f"total {time.perf_counter() - t_start:.1f} s")
    # launches: K1 on the served paths (gemma's, gemma's sharded and mixtral's) and the paper
    # path's fused ab solves (the score net, x (1, 1024, 2)); the wgmma and
    # mma_sync kernels on the bf16 one-shot paths (K2: gemma's, mixtral's,
    # whisper's and paligemma's); the 3xTF32 and CUDA-core kernels on the
    # float32 one-shot paths (the card-vs-cpu phase: every launch takes
    # tf32x3), each counted from 0 just before its path. K2's times are at
    # gemma's shape (the other models' are printed by phase_k2); a float32
    # row's bound is at 165 TFLOP/s, bound_cuda_cores_ms at 67
    k2_paths = [gemma, mixtral, granite] + list(cond_paths.values())
    k3_paths = [mamba, granite]
    k1 = dict(k1, max_abs_err=max(k1["max_abs_err"], paper["max_abs_err"]))
    rows = [("fused_ab_step", "triton", "deis_step.py", "deis_step.py:45",
             launches + sharded_launches + paper["launches"], k1)]
    for route in ("wgmma", "mma_sync"):
        rows += [(f"flash_attention_{route}", "cuda", "csrc/flash_attention.cu",
                  "flash_attention.py:41", sum(run["routes"]["K2"][route] for run in k2_paths),
                  k2["gemma"][route]),
                 (f"ssd_scan_{route}", "cuda", "csrc/ssd_scan.cu", "ssd_scan.py:40",
                  sum(run["routes"]["K3"][route] for run in k3_paths), k3[route])]
    for route in ("tf32x3", "cuda_cores"):
        rows += [(f"flash_attention_{route}", "cuda", "csrc/flash_attention.cu",
                  "flash_attention.py:41", f32_path["K2"][route], k2["gemma"][route]),
                 (f"ssd_scan_{route}", "cuda", "csrc/ssd_scan.cu", "ssd_scan.py:40",
                  f32_path["K3"][route], k3[route])]
    # the SSM mixer's passes replace no TPU kernel: their launches on mamba2's
    # and granite's bf16 one-shot paths, the norm's two instantiations apart
    # (norm then gate: mamba2's; gate first: granite's)
    rows += [("ssm_pre", "cuda", "csrc/ssm_pointwise.cu", None,
              sum(run["counts"]["ssm_pre"] for run in k3_paths), pw["pre"]),
             ("ssm_post", "cuda", "csrc/ssm_pointwise.cu", None, mamba["counts"]["ssm_post"],
              pw["post"]),
             ("ssm_post_gate_first", "cuda", "csrc/ssm_pointwise.cu", None,
              granite["counts"]["ssm_post"], pw["post_gate_first"])]
    # the MoE's kernels replace no TPU kernel: their launches on mixtral's and
    # granite's bf16 one-shot paths; times at granite's shape
    rows += [(name, "cuda", "csrc/moe_dispatch.cu", None,
              mixtral["counts"][name] + granite["counts"][name], md[name]) for name in MOE_KEYS]
    print(json.dumps({"kernels": [{
        "name": name, "route": route, "source": f"src/repro_torch/kernels/{src}",
        "replaces": site and f"src/repro/kernels/{site}", "launches": n,
        "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k.get("bound_by", "bytes"),
        "library_ms": k.get("library_ms"),
        **({"bound_cuda_cores_ms": k["bound_cuda_cores_ms"]} if "bound_cuda_cores_ms" in k
           else {})} for name, route, src, site, n, k in rows]}))
    if device.type != "cuda":
        print("rehearsal ok (cpu): no device result")
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
