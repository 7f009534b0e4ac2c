#!/usr/bin/env python3
"""Build the port's hand-written kernels on one CUDA card, hold each to its
plain version and time it at the main paths' shapes (the instrument behind
the kernel table of ``PERF.md`` §6), then count the launches of the
benchmark's one-shot cells and of the served engine at full width.

    python3 chip_smoke.py          # on a machine with a CUDA card

The kernels over every other shape, and the card's runs of the models, the
engine and the training step against the CPU, are the card tests
(``tests/test_torch_cuda.py``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Phases (any failure raises and the script exits non-zero):

1. Device: the card's name, count, ``nvidia-smi`` name and power limit;
   TF32 off for float32 matmuls and convolutions.
2. Build: the CUDA C++ kernels (``src/repro_torch/kernels/csrc``: K2, K3,
   the SSM mixer's passes and the MoE's four kernels) compiled by nvcc for
   sm_90a into ``build/kernels``, one nvcc per source, started together.
   K2's and K3's sources hold four kernels each, one per route: wgmma
   (bf16 that TMA can describe), mma_sync (other bf16), tf32x3 (float32
   with 16-byte aligned bases; K3: P and N multiples of 8) and cuda_cores
   (other float32). For every kernel, ptxas's registers and spills, and
   its HMMA (mma.sync), HGMMA (wgmma) and UTMALDG (TMA load) counts in
   SASS (``cuobjdump -sass``); an mma_sync or tf32x3 kernel without HMMA,
   a wgmma kernel without HGMMA or UTMALDG, any of them with spills, or a
   setmaxnreg that ptxas dropped, fails the phase.
3. Kernels: each kernel launched once at the shapes below and held to its
   plain version at the card tests' tolerances (K1 and ``moe_gather``
   bitwise; K2 ``ref.K2_TOL``; K3 ``ref.K3_TOL``, float32 with
   ``ref.K3_F32_SCALE`` x max|want|; the SSM passes and the other MoE
   kernels as their docstrings say), K2 and K3 also on views one element
   past a 16-byte line, which take mma_sync (bf16) and cuda_cores
   (float32); every launch counted on its route. Then its own device time
   (torch.profiler), in turns with
   its plain version (K2: and ``scaled_dot_product_attention``, the
   yardstick only; the port never calls it), median of three, beside the
   least time of its work (``chipbench.bounds``: bytes at 3.35 TB/s or
   operations at 989 TFLOP/s in bf16, at 165 in float32 (3xTF32 on the
   tensor cores) and, beside it, at 67 (the CUDA cores)):
   - K1 ``fused_ab_step`` (Triton, built into ``build/triton``) at a
     served group's shape (R 8, M 256, D 2048, r 3, the error pair);
   - K2 ``flash_attention``, bidirectional, at the full widths of
     gemma-2b, mixtral-8x7b, whisper-tiny's decoder, paligemma-3b (S 512),
     glm4-9b, granite-4.0-h-small (B 16, softmax scale 1/128) and
     cifar10-scorenet: bf16 on wgmma and float32 on tf32x3 (cifar10 in
     float32 only);
   - K3 ``ssd_scan`` at mamba2-2.7b's (Bb 4, S 256, H 80, P 64, N 128,
     chunk 256): bf16 on wgmma and float32 on tf32x3;
   - the SSM mixer's passes in bf16: ``pre`` and ``post`` at
     mamba2-2.7b's one-shot shape (Bb 16, S 256, H 80), ``post`` gate
     first at granite-4.0-h-small's (H 128);
   - the MoE's four kernels in bf16 at granite-4.0-h-small's one-shot
     shape (B 16, S 256, E 72, k 10, C 44, d 4096, f 768).
   The mma_sync and cuda_cores kernels are checked, not timed: no main
   path makes operands that select them.
4. Stress (``phase_stress``, ``tools/kernel_stress.py``): the wgmma
   kernels (mbarrier rings) launched 6000 times each with a sync after
   each, K3 at mamba2's widths with Bb 4 and 16 in turn, K2 at gemma-2b's
   heads at B 4 and at B 1, S 1024 (key tiles split between the
   warpgroups) and B 16 (not split) in turn; the tf32x3 kernels 2000 times
   each at the same shapes in float32. Every output bitwise the first
   launch's at its shape; a fault or a wrong output fails the run.
5. Main paths (``phase_main_paths``): one ``sample_tokens`` call of each
   of ``MAIN_CELLS`` (mamba2-2.7b and granite-4.0-h-small at full width
   in bf16, the cell's batch, length and tab3 plan) on each route, its
   launches counted from 0 by layer kind, every K2 and K3 launch on
   wgmma, the kernel route's x0 within the cell's ``x0_rel`` of the plain
   route's.
6. Serve (``phase_serve``): the engine over gemma-2b at full width in
   bf16, two staggered waves of six solvers (a join), K1 once an ``ab``
   group step, no new executor on a warm replay.

The line before the last is the kernel JSON, one row per timed kernel and
shape; the last line is ``{"ok": true, "device": {...}}``. Exits 2
without a CUDA device.
"""
from __future__ import annotations

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

from chipbench.bounds import (BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S, TF32X3_FLOPS, bound_s,
                              k1_bytes, k3_work)

ROOT = Path(__file__).resolve().parent
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
# K2 at each model's full width: (B, S, H, KV, D, window, softmax scale or
# None for 1/sqrt(D)), bidirectional as the one-shot path runs it
K2_SHAPES = {"gemma-2b": (4, 256, 8, 1, 256, 0, None),
             "mixtral-8x7b": (4, 256, 32, 8, 128, 4096, None),
             "whisper-tiny": (4, 256, 6, 6, 64, 0, None),
             "paligemma-3b": (4, 512, 8, 1, 256, 0, None),
             "glm4-9b": (4, 256, 32, 2, 128, 0, None),
             "granite-4.0-h-small": (16, 256, 32, 8, 128, 0, 1 / 128),
             "cifar10-scorenet": (4, 256, 4, 4, 64, 0, None)}
FLOAT32_MODELS = ("cifar10-scorenet",)
K3_SHAPE = (4, 256, 80, 64, 128, 256)   # mamba2-2.7b: (Bb, S, H, P, N, chunk)
# the SSM mixer's passes: (Bb, S, H, P, N, K) at mamba2-2.7b's and
# granite-4.0-h-small's one-shot shapes
PW_SHAPES = {"mamba2-2.7b": (16, 256, 80, 64, 128, 4),
             "granite-4.0-h-small": (16, 256, 128, 64, 128, 4)}
# the MoE's kernels at granite-4.0-h-small's one-shot shape: (B, S, E, k, C, d, f)
MOE_SHAPE = (16, 256, 72, 10, 44, 4096, 768)
# the benchmark's one-shot cells whose calls ``phase_main_paths`` counts
MAIN_CELLS = ("mamba2-2.7b.oneshot_tab3", "granite-4.0-h-small.oneshot_tab3")


def _event_ms(fn, n=50, warm=5):
    """ms per call of fn over n back-to-back calls after warm-up (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


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


def _turns(tag, calls, reps=3):
    """ms per call of each of ``calls`` ({name: (fn, kernel name or None)}),
    timed in turns (the order reversed every other round), median of
    ``reps``: the named kernel's own device time, or the sum of a call's
    kernels where no name is given (torch.profiler; CUDA events over 50
    back-to-back calls where the profiler sees none)."""
    got = {k: [] for k in calls}
    names = list(calls)
    for i in range(reps):
        for k in (names if i % 2 == 0 else names[::-1]):
            fn, kname = calls[k]
            us = [v for name, v in _device_kernel_us(fn, 20).items()
                  if kname is None or kname in name]
            got[k].append(sum(us) / 1e3 if us else _event_ms(fn))
    out = {k: float(np.median(v)) for k, v in got.items()}
    print(f"{tag} per call (device time, torch.profiler; in turns, median of {reps}): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()))
    return out


def _kernels():
    """{key: wrapper} of each hand-written kernel's launch counter."""
    from repro_torch.kernels import (deis_step, flash_attention, moe_dispatch, ssd_scan,
                                     ssm_pointwise)
    return {"K1": deis_step.fused_ab_step, "K2": flash_attention.flash_attention,
            "K3": ssd_scan.ssd_scan, "ssm_pre": ssm_pointwise.conv_prep,
            "ssm_post": ssm_pointwise.gated_norm, "moe_route": moe_dispatch.route,
            "moe_gather": moe_dispatch.gather, "moe_glu": moe_dispatch.glu,
            "moe_combine": moe_dispatch.combine}


def _counts():
    """({key: launches}, {"K2"/"K3": launches by route})."""
    fns = _kernels()
    return ({k: fn.launches for k, fn in fns.items()},
            {k: dict(fns[k].route_launches) for k in ("K2", "K3")})


def _reset_counts():
    for fn in _kernels().values():
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)


def _once(key, route, call):
    """call(), raising unless it launched kernel ``key`` once (K2, K3: on
    ``route``) and nothing else."""
    (counts, routes) = _counts()
    out = call()
    torch.cuda.synchronize()
    counts[key] += 1
    if route is not None:
        routes[key][route] += 1
    if _counts() != (counts, routes):
        raise AssertionError(f"{key}: launches {_counts()}, not {(counts, routes)}")
    return out


def _close(tag, got, want, **tol):
    """The largest difference of got from want; raises, naming ``tag``,
    unless it is within ``tol`` (``torch.testing.assert_close``), or
    bitwise where no tolerance is given."""
    err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
    if not tol:
        if not torch.equal(got, want):
            raise AssertionError(f"{tag}: not bitwise its plain version (max abs diff {err:.3e})")
        return err
    try:
        torch.testing.assert_close(got.float(), want.float(), **tol)
    except AssertionError as e:
        raise AssertionError(f"{tag}: {e}") from None
    return err


def _row(name, route, source, site, shape, dtype, nbytes, flops, t, err):
    """The kernel table's row for one timed kernel (``t``: the times of
    ``_turns`` under "kernel", "plain" and, where there is one, "library";
    ``err``: its largest difference from the plain version at that shape):
    the least time of the work at the dtype's rate (bf16 989 TFLOP/s;
    float32 165, 3xTF32, and, where it has operations, 67 as
    ``bound_cuda_cores_ms``), printed with the kernel's share of it."""
    rates = {"bound": BF16_FLOPS if dtype == torch.bfloat16 else TF32X3_FLOPS}
    if flops and dtype == torch.float32:
        rates["bound_cuda_cores"] = FP32_FLOPS
    row = dict(name=name, route=route, source=f"src/repro_torch/kernels/{source}",
               replaces=site and f"src/repro/kernels/{site}", shape=shape,
               dtype=str(dtype).removeprefix("torch."), ms=t["kernel"], plain_ms=t["plain"],
               library_ms=t.get("library"), max_abs_err=err,
               bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / rates["bound"]
               else "operations")
    for key, rate in rates.items():
        row[f"{key}_ms"] = bound_s(nbytes, flops, rate) * 1e3
    print(f"{name} ({route}) at {shape}, {row['dtype']}: "
          + ", ".join(f"{key.replace('_', ' ')} {row[f'{key}_ms']:.5f} ms, share "
                      f"{row[f'{key}_ms'] / row['ms']:.3f}" for key in rates)
          + f" (by {row['bound_by']}: {nbytes} B at 3.35 TB/s, {flops} FLOP)")
    return row


def phase_device(device):
    name, count = torch.cuda.get_device_name(device), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"device: {name} (count {count}); torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for float32 matmuls and cuDNN convolutions")
    return name, count


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


def phase_build():
    """nvcc builds of the CUDA sources, started together; each kernel's
    registers and spills from ptxas's report and its HMMA, HGMMA and UTMALDG
    counts from its SASS. Raises if an mma.sync or 3xTF32 kernel has no
    HMMA, a wgmma kernel no HGMMA or no UTMALDG, or any of them spills.
    Returns {kernel: [registers, spill stores, spill loads, counts]}."""
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


def phase_k1(device):
    """K1 at a served group's shape (8 rows of seq 256 at gemma-2b's
    d_model, r 3, with the error pair): bitwise its plain version (no FMA
    contraction), then timed beside it."""
    from repro_torch.kernels import deis_step as K
    from repro_torch.kernels import ref
    gen = torch.Generator(device=device).manual_seed(1234)
    n = lambda *s: torch.randn(s, generator=gen, device=device)
    R, m, d, r = 8, 256, 2048, 3
    args = (n(R, m, d), n(r, R, m, d), torch.rand(R, generator=gen, device=device) * 0.5 + 0.5,
            n(R, r))
    kw = dict(err_coeffs=n(R, r) * 0.1)
    out, e = _once("K1", None, lambda: K.fused_ab_step(*args, **kw))
    want, want_e = ref.fused_ab_step_ref(*args, **kw)
    err = max(_close("K1", out, want), _close("K1 error", e, want_e))
    t = _turns(f"K1 at R={R} M={m} D={d} r={r} with err", {
        "kernel": (lambda: K.fused_ab_step(*args, **kw), "fused_ab_kernel"),
        "plain": (lambda: ref.fused_ab_step_ref(*args, **kw), None)})
    return [_row("fused_ab_step", "triton", "deis_step.py", "deis_step.py:45",
                 f"R {R} M {m} D {d} r {r}, err", torch.float32,
                 k1_bytes(R, m, d, r, err=True), 0, t, err)]


def phase_k2(device):
    """K2 at each model's full width (``K2_SHAPES``), in bf16 and float32:
    on its own route (wgmma, tf32x3) and on views one element past a
    16-byte line (mma_sync, cuda_cores), each launched once on that route
    and within ``ref.K2_TOL`` of the plain version; then the own route in
    turns with the plain version and SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ref
    from repro_torch.kernels.runtime import unaligned_copy
    gen = torch.Generator(device=device).manual_seed(2)
    rows = []
    for model, (b, s, h, kv, d, window, scale) in K2_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            if model in FLOAT32_MODELS and dtype == torch.bfloat16:
                continue
            rnd = lambda *sh: torch.randn(sh, generator=gen, device=device).to(dtype)
            q, k, v = rnd(b, s, h, d), rnd(b, s, kv, d), rnd(b, s, kv, d)
            route = K.route(q, k, v)
            main, other = ("wgmma", "mma_sync") if dtype == torch.bfloat16 else \
                ("tf32x3", "cuda_cores")
            if route != main:
                raise AssertionError(f"K2 at {model}'s shape: route {route}, not {main}")
            kw = dict(causal=False, window=window, scale=scale)
            want = ref.flash_attention_ref(q, k, v, **kw)
            tol = dict(rtol=ref.K2_TOL[dtype], atol=ref.K2_TOL[dtype])
            err = _close(f"K2 {model} {route}", _once("K2", route, lambda: K.flash_attention(
                q, k, v, **kw)), want, **tol)
            views = [unaligned_copy(t) for t in (q, k, v)]
            _close(f"K2 {model} {other}", _once("K2", other, lambda: K.flash_attention(
                *views, **kw)), want, **tol)
            # the window (4096 at most) spans the whole sequence of 512 keys at
            # most: SDPA computes the same function without it
            t = _turns(f"K2 at {model}'s shape B={b} S={s} H={h} KV={kv} D={d} "
                       f"{str(dtype).removeprefix('torch.')}", {
                           "kernel": (lambda: K.flash_attention(q, k, v, causal=False,
                                                                window=window, scale=scale),
                                      f"flash_fwd_{route}_kernel"),
                           "plain": (lambda: ref.flash_attention_ref(
                               q, k, v, causal=False, window=window, scale=scale), None),
                           "library": (lambda: F.scaled_dot_product_attention(
                               q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               enable_gqa=True, scale=scale), None)})
            # each input read once, the output written once; QK^T and PV over
            # every (query, key) pair (bidirectional)
            nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
            rows.append(_row("flash_attention", route, "csrc/flash_attention.cu",
                             "flash_attention.py:41", f"{model} B {b} S {s} H {h}/{kv} D {d}",
                             dtype, nbytes, 4 * b * h * s * s * d, t, err))
    return rows


def phase_k3(device):
    """K3 at mamba2-2.7b's shape (``K3_SHAPE``), in bf16 and float32: on
    its own route (wgmma, tf32x3) and with x, B and C as views one element
    past a 16-byte line (mma_sync, cuda_cores), each launched once on that
    route, y and the state within ``ref.K3_TOL`` of the plain version
    (float32: atol ``ref.K3_F32_SCALE`` x max|want| at these widths); then
    the own route in turns with the plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as K
    from repro_torch.kernels.runtime import unaligned_copy
    gen = torch.Generator(device=device).manual_seed(3)
    b, s, h, p, n, chunk = K3_SHAPE
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        rnd = lambda *sh: torch.randn(sh, generator=gen, device=device).to(dtype)
        x, B, C = rnd(b, s, h, p), rnd(b, s, n), rnd(b, s, n)
        a = torch.rand((b, s, h), generator=gen, device=device) * 0.299 + 0.7
        route = K.route(x, B, C)
        main, other = ("wgmma", "mma_sync") if dtype == torch.bfloat16 else \
            ("tf32x3", "cuda_cores")
        if route != main:
            raise AssertionError(f"K3 at mamba2's shape: route {route}, not {main}")
        want = ref.ssd_scan_ref(x, a, B, C, chunk=chunk)
        scale = ref.K3_F32_SCALE if dtype == torch.float32 else 0.0
        errs = {}
        for r, (xx, BB, CC) in ((route, (x, B, C)),
                                (other, [unaligned_copy(v) for v in (x, B, C)])):
            got = _once("K3", r, lambda: K.ssd_scan(xx, a, BB, CC, chunk=chunk))
            errs[r] = max(_close(f"K3 {r} {part}", g, w, rtol=ref.K3_TOL[dtype],
                                 atol=max(ref.K3_TOL[dtype], scale * w.abs().max().item()))
                          for part, g, w in zip(("y", "state"), got, want))
        t = _turns(f"K3 at mamba2's shape Bb={b} S={s} H={h} P={p} N={n} chunk {chunk} "
                   f"{str(dtype).removeprefix('torch.')}", {
                       "kernel": (lambda: K.ssd_scan(x, a, B, C, chunk=chunk),
                                  f"ssd_scan_{route}_kernel"),
                       "plain": (lambda: ref.ssd_scan_ref(x, a, B, C, chunk=chunk), None)})
        nbytes, flops = k3_work(b, s, h, p, n, chunk, x.element_size())
        rows.append(_row("ssd_scan", route, "csrc/ssd_scan.cu", "ssd_scan.py:40",
                         f"mamba2-2.7b Bb {b} S {s} H {h} P {p} N {n} chunk {chunk}", dtype,
                         nbytes, flops, t, errs[route]))
    return rows


def _pw_inputs(device, b, s, h, p, n, k, dtype, seed=29):
    """Views z, xBC, dt of an in-projection output drawn from a seed, and the
    mixer's parameters with y and xh for the norm."""
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *sh: torch.randn(sh, generator=gen, device=device)
    d_inner, c = h * p, h * p + 2 * n
    zx = r(b, s, d_inner + c + h).to(dtype)
    z, xbc, dt = zx[..., :d_inner], zx[..., d_inner:d_inner + c], zx[..., d_inner + c:]
    prm = dict(conv_w=(r(k, c) * 0.3).to(dtype), conv_b=(r(c) * 0.1).to(dtype),
               dt_bias=r(h), A_log=r(h) * 0.5, D=r(h), scale=(r(d_inner) * 0.1).to(dtype))
    y, xh = r(b, s, h, p).to(dtype), r(b, s, h, p).to(dtype)
    return z, xbc, dt, prm, y, xh


def phase_ssm_pointwise(device):
    """The SSM mixer's two passes in bf16, each launched once and held as
    the card tests hold them, then in turns with its plain version: ``pre``
    (``ssm_conv_prep_kernel``: xh, B and C within rtol 2^-7, atol 1e-5 of
    the same sums in float64, rounded once; the decay within rtol 1e-5 of
    the plain version) and ``post`` (``ssm_gated_norm_kernel``, norm then
    gate: within rtol 2^-7, atol 1e-5 of the plain version) at mamba2-2.7b's
    one-shot shape, ``post`` gate first at granite-4.0-h-small's."""
    import torch.nn.functional as F
    from repro_torch.kernels import ssm_pointwise as SP
    dtype, es = torch.bfloat16, 2
    tol = dict(rtol=2 ** -7, atol=1e-5)
    rows = []
    for model, gate_first in (("mamba2-2.7b", False), ("granite-4.0-h-small", True)):
        b, s, h, p, n, k = PW_SHAPES[model]
        z, xbc, dt, prm, y, xh = _pw_inputs(device, b, s, h, p, n, k, dtype)
        args = (prm["conv_w"], prm["conv_b"], prm["dt_bias"], prm["A_log"])
        rows_n, c = b * s, h * p + 2 * n
        tag = f"Bb {b} S {s} H {h} P {p} N {n} K {k}"
        post = {"kernel": (lambda: SP.gated_norm(y, xh, z, prm["D"], prm["scale"], eps=1e-5,
                                                 gate_first=gate_first),
                           "ssm_gated_norm_kernel"),
                "plain": (lambda: SP.gated_norm_ref(y, xh, z, prm["D"], prm["scale"], 1e-5,
                                                    gate_first=gate_first), None)}
        # y, xh and z read once, the output written once (4 planes of rows x H P)
        post_bytes = rows_n * h * p * es * 4 + h * 4 + h * p * es
        name = "ssm_post_gate_first" if gate_first else "ssm_post"
        post_err = _close(name, _once("ssm_post", None, post["kernel"][0]), post["plain"][0](),
                          **tol)
        if not gate_first:
            got = _once("ssm_pre", None, lambda: SP.conv_prep(xbc, dt, *args, head_dim=p))
            xp = F.pad(xbc.double(), (0, 0, k - 1, 0))
            exact = F.silu(sum(xp[:, i:i + s] * prm["conv_w"][i].double() for i in range(k))
                           + prm["conv_b"].double()).to(dtype)
            pre_err = _close("ssm_pre", torch.cat([v.reshape(b, s, -1) for v in got[:3]], -1),
                             exact, **tol)
            _close("ssm_pre decay", got[3], SP.conv_prep_ref(xbc, dt, *args, head_dim=p)[3],
                   rtol=1e-5, atol=0)
            t = _turns(f"ssm pre at {model}'s {tag} bf16", {
                "kernel": (lambda: SP.conv_prep(xbc, dt, *args, head_dim=p),
                           "ssm_conv_prep_kernel"),
                "plain": (lambda: SP.conv_prep_ref(xbc, dt, *args, head_dim=p), None)})
            # xBC and dt read, xh, B, C and the float32 decay written; the taps,
            # the bias and the two per-head vectors
            pre_bytes = rows_n * (c * es + h * es) + rows_n * (c * es + h * 4) \
                + (k + 1) * c * es + 2 * h * 4
            rows.append(_row("ssm_pre", "cuda", "csrc/ssm_pointwise.cu", None,
                             f"{model} {tag}", dtype, pre_bytes, 0, t, pre_err))
        t = _turns(f"{name} at {model}'s {tag} bf16", post)
        rows.append(_row(name, "cuda", "csrc/ssm_pointwise.cu", None, f"{model} {tag}", dtype,
                         post_bytes, 0, t, post_err))
    return rows


def phase_moe_dispatch(device):
    """The MoE's four kernels in bf16 at granite-4.0-h-small's one-shot
    shape (``MOE_SHAPE``), each launched once and held as the card tests
    hold them: ``moe_route``'s choices, places, slots, table and kept counts
    bitwise, its gates, gate sums and logsumexps within rtol 1e-5, atol
    1e-6; ``moe_gather`` bitwise; ``moe_glu`` within one unit in the last
    place; ``moe_combine`` within one unit in the last place, atol 1e-5 of
    the largest expert output. Then each in turns with its plain version."""
    from repro_torch.kernels import moe_dispatch as MD
    b, s, e, k, c, d, f = MOE_SHAPE
    dtype = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(31)
    r = lambda *sh: torch.randn(sh, generator=gen, device=device)
    logits = r(b, s, e)
    x, h, g = r(b, s, d).to(dtype), (r(e, b * c, f) * 2).to(dtype), (r(e, b * c, f) * 2).to(dtype)
    out_e, add = r(e, b * c, d).to(dtype), r(b, s, d).to(dtype)
    route = _once("moe_route", None, lambda: MD.route(logits, top_k=k, cap=c))
    want = MD.route_ref(logits, top_k=k, cap=c)
    for key in ("gate_idx", "pos", "slot", "table", "kept"):
        _close(f"moe_route {key}", route[key], want[key])
    err = {"moe_route": max(_close(f"moe_route {key}", route[key], want[key], rtol=1e-5,
                                   atol=1e-6) for key in ("gate_vals", "gate_sum", "lse"))}
    one = 2.0 ** -7     # one unit in the last place of bf16
    err["moe_gather"] = _close("moe_gather", _once("moe_gather", None, lambda: MD.gather(
        x, route["table"])), MD.gather_ref(x, route["table"]))
    err["moe_glu"] = _close("moe_glu", _once("moe_glu", None, lambda: MD.glu(h, g)),
                            MD.glu_ref(h, g), rtol=one, atol=1e-30)
    err["moe_combine"] = _close("moe_combine", _once("moe_combine", None, lambda: MD.combine(
        out_e, route["slot"], route["gate_vals"], add)), MD.combine_ref(
        out_e, route["slot"], route["gate_vals"], add), rtol=one,
        atol=1e-5 * out_e.abs().max().item())
    es, slots, pairs = x.element_size(), e * b * c, b * s * k
    kept = int(route["kept"].sum())
    # each input read once and each output written once; the combine reads
    # only the kept slots' rows, plus the shared addend
    kernels = {
        "moe_route": (lambda: MD.route(logits, top_k=k, cap=c),
                      lambda: MD.route_ref(logits, top_k=k, cap=c),
                      b * s * e * 4 + pairs * 20 + slots * 4 + b * e * 8 + b * s * 4),
        "moe_gather": (lambda: MD.gather(x, route["table"]),
                       lambda: MD.gather_ref(x, route["table"]),
                       slots * d * es + b * s * d * es + slots * 4),
        "moe_glu": (lambda: MD.glu(h, g), lambda: MD.glu_ref(h, g), 3 * slots * f * es),
        "moe_combine": (lambda: MD.combine(out_e, route["slot"], route["gate_vals"], add),
                        lambda: MD.combine_ref(out_e, route["slot"], route["gate_vals"], add),
                        kept * d * es + pairs * 8 + 2 * b * s * d * es)}
    rows = []
    for name, (call, plain, nbytes) in kernels.items():
        t = _turns(f"{name} at granite's B={b} S={s} E={e} k={k} C={c} d={d} f={f} bf16",
                   {"kernel": (call, f"{name}_kernel"), "plain": (plain, None)})
        rows.append(_row(name, "cuda", "csrc/moe_dispatch.cu", None,
                         f"granite-4.0-h-small B {b} S {s} E {e} k {k} C {c} d {d} f {f}",
                         dtype, nbytes, 0, t, err[name]))
    return rows


def phase_stress(counts=(("wgmma", 6000), ("tf32x3", 2000)), seed=24):
    """Each route of ``counts`` of K3 and K2 launched that many times over
    the stress tool's shapes in turn, a sync after each, every output
    bitwise the first launch's at its shape. Raises on a fault or a wrong
    output (a fault leaves the CUDA context unusable: the run ends there).
    Returns {(kernel, route): the tool's numbers}."""
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


def phase_main_paths(device):
    """Each cell of ``MAIN_CELLS`` at its configuration's full width, with
    the harness's weights (seed 0) and its mix's batch, length and plan,
    one ``sample_tokens`` call on each route, the counts set to 0 just
    before: on the kernel route K1 once a solver step, K2 once an attention
    layer and NFE, K3 and both SSM passes once an SSM layer and NFE, each
    MoE kernel once a MoE layer and NFE, every K2 and K3 launch on wgmma;
    on the plain route K1 alone. Tokens of the asked shape in the
    vocabulary and a finite x0 on both; the kernel route's x0 within the
    cell's ``x0_rel`` limit of the plain route's (relative L2)."""
    from chipbench import spec, weights
    from repro_torch.configs.base import config_from_dict
    from repro_torch.core import VPSDE, get_timesteps, make_plan, solver_stages
    from repro_torch.diffusion.lm import request_generators, sample_tokens
    from repro_torch.models.transformer import _layer_kind
    sde = VPSDE()
    for name in MAIN_CELLS:
        cell = spec.load_cell(name)
        model, mix = cell["config_data"]["model"], cell["mix_data"]
        cfg = config_from_dict(model)
        params = weights.make(model, 0, device, cell["arch_module"])
        solver, nfe, batch, seq = mix["solver"], int(mix["nfe"]), int(mix["batch"]), \
            int(mix["seq_len"])
        plan = make_plan(solver, sde, get_timesteps(sde, max(1, nfe // solver_stages(solver))),
                         **({"fused": True} if solver_stages(solver) == 1 else {}))
        kinds = [_layer_kind(cfg, i) for i in range(cfg.n_layers)]
        mixers, mlps = [m for m, _ in kinds], [f for _, f in kinds]
        want = dict.fromkeys(_kernels(), 0)
        want.update(K1=plan.n_steps, K2=mixers.count("attn") * nfe, K3=mixers.count("ssm") * nfe)
        want["ssm_pre"] = want["ssm_post"] = want["K3"]
        want.update({k: mlps.count("moe") * nfe for k in want if k.startswith("moe_")})
        want_routes = {k: dict(wgmma=want[k], mma_sync=0, tf32x3=0, cuda_cores=0)
                       for k in ("K2", "K3")}
        x0 = {}
        with torch.no_grad():
            for use_kernels in (True, False):
                _reset_counts()
                t0 = time.perf_counter()
                toks, x0[use_kernels] = sample_tokens(
                    params, cfg, plan, request_generators([7], device)[0], batch=batch,
                    seq_len=seq, prior_std=sde.prior_std(), use_kernels=use_kernels)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts, routes = _counts()
                print(f"{name} use_kernels={use_kernels}: {solver} {nfe} NFE, batch {batch}, "
                      f"seq {seq} in {wall:.3f} s (first call); launches {counts}, K2/K3 by "
                      f"route {routes}")
                if tuple(toks.shape) != (batch, seq) or toks.min() < 0 \
                        or toks.max() >= cfg.vocab_size or not torch.isfinite(x0[use_kernels]).all():
                    raise AssertionError(f"{name}: bad output on use_kernels={use_kernels}")
                plain = dict.fromkeys(want, 0) | {"K1": want["K1"]}
                if counts != (want if use_kernels else plain) or use_kernels and \
                        routes != want_routes:
                    raise AssertionError(f"{name} use_kernels={use_kernels}: launches {counts}, "
                                         f"routes {routes}; want {want}, {want_routes}")
        limit = cell["check"]["limits"]["x0_rel"]
        rel = ((x0[True].float() - x0[False].float()).norm() / x0[False].float().norm()).item()
        print(f"{name}: kernel route's x0 {rel:.4e} from the plain route's (relative L2; "
              f"limit {limit}); launches as expected, every K2 and K3 launch on wgmma")
        if not rel <= limit:
            raise AssertionError(f"{name}: x0 {rel:.4e} from the plain route's, beyond {limit}")
        del params, x0
        torch.cuda.empty_cache()


def phase_serve(device):
    """``DiffusionServeEngine`` over gemma-2b at its published widths in
    bf16 (weights from seed 0), seq_len buckets (128, 256) and a
    ``RetirePolicy``: two staggered waves of ddim, tab3, dpm2m, sndeis2,
    seeds2 and rho_heun requests, the second sent when request 1 comes back
    (a join). Every request completes with tokens of its length in the
    vocabulary; K1 launches once an ``ab`` group step; a warm replay of the
    waves adds no executor and again launches K1 once an ``ab`` step."""
    from repro_torch.configs import get_config
    from repro_torch.core import RetirePolicy, VPSDE, get_timesteps, make_plan, solver_stages
    from repro_torch.kernels import deis_step as K
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import DiffusionServeEngine, Request
    cfg = get_config("gemma_2b").with_(objective="diffusion")
    sde = VPSDE()
    eng = DiffusionServeEngine(init_params(cfg, 0, device), cfg, sde=sde,
                               retire=RetirePolicy(tol=0.05, min_k=3, norm="rel"),
                               seq_len_buckets=(128, 256), device=device)
    wave1 = [Request(uid=i, solver=sv, nfe=nfe, seq_len=sl, seed=10 + i) for i, (sv, nfe, sl)
             in enumerate([("ddim", 8, 100), ("ddim", 6, 128), ("tab3", 8, 256), ("dpm2m", 8, 256),
                           ("sndeis2", 10, 200), ("seeds2", 8, 256), ("rho_heun", 8, 128)])]
    wave2 = [Request(uid=7, solver="ddim", nfe=6, seq_len=96, seed=17),
             Request(uid=8, solver="tab3", nfe=6, seq_len=240, seed=18)]
    method = {q.uid: make_plan(q.solver, sde, get_timesteps(
        sde, max(1, q.nfe // solver_stages(q.solver)))).method for q in wave1 + wave2}

    def serve(tag):
        ab, results, sent = [0], [], False
        on_step = lambda ev: ab.__setitem__(0, ab[0] + (method[ev.uids[0]] == "ab"))
        K.fused_ab_step.launches = 0
        t0 = time.perf_counter()
        for q in wave1:
            eng.submit(q)
        while eng.busy:
            results += eng.tick(on_step=on_step)
            if not sent and any(r.uid == 1 for r in results):
                for q in wave2:
                    eng.submit(q)
                sent = True
        torch.cuda.synchronize()
        misses = eng.metrics.snapshot()["serve_compile_cache_misses_total"]
        print(f"serve {cfg.name} ({tag}): {len(results)} requests in "
              f"{time.perf_counter() - t0:.3f} s; joins {eng.joined_requests}, executors "
              f"{int(misses)}, ab group steps {ab[0]}, K1 launches {K.fused_ab_step.launches}")
        if not K.fused_ab_step.launches == ab[0] > 0:
            raise AssertionError(f"serve ({tag}): K1 launches {K.fused_ab_step.launches} != "
                                 f"ab group steps {ab[0]}")
        return results, misses

    cold, misses = serve("cold")
    want = {q.uid: q.seq_len for q in wave1 + wave2}
    if sorted(r.uid for r in cold) != sorted(want) or any(
            r.tokens.shape != (want[r.uid],) or r.tokens.min() < 0
            or r.tokens.max() >= cfg.vocab_size for r in cold):
        raise AssertionError("serve: not every request completed with tokens of its length")
    snap = eng.metrics.snapshot()
    if not snap["serve_submitted_total"] == snap["serve_completed_total"] == len(want):
        raise AssertionError("serve: submitted != completed")
    if eng.joined_requests < 1:
        raise AssertionError("serve: the staggered waves produced no join")
    if serve("warm replay")[1] != misses:
        raise AssertionError("serve: the warm replay added executors")
    del eng
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda")
    t0 = time.perf_counter()
    kind, count = phase_device(device)
    phase_build()
    print(f"[device and build: {time.perf_counter() - t0:.1f} s]")
    rows = []
    for phase in (phase_k1, phase_k2, phase_k3, phase_ssm_pointwise, phase_moe_dispatch):
        rows += phase(device)
    print(f"[times: {time.perf_counter() - t0:.1f} s]")
    phase_stress()
    print(f"[stress: {time.perf_counter() - t0:.1f} s]")
    phase_main_paths(device)
    print(f"[main paths: {time.perf_counter() - t0:.1f} s]")
    phase_serve(device)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
