#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one CUDA card.

    python3 chip_smoke.py                      # on a machine with a CUDA card
    python3 chip_smoke.py --device cpu --reduced   # rehearsal, plain versions

Phases (any failure raises and the script exits non-zero):

1. Device: the card's name, count, ``nvidia-smi`` name and power limit;
   TF32 off for float32 matmuls and convolutions.
2. Kernel K1 (``fused_ab_step``, Triton, built into ``build/triton``): held
   against its plain PyTorch version for r in 1..4, noise on/off, error
   pair on/off, R in {1, 5} at a ragged size (rtol = atol = 1e-6: FMA
   contraction and summation order), stacked rows bitwise equal to solo
   calls; then timed with CUDA events at the main path's shape beside the
   plain version and the byte bound.
3. Serving: gemma-2b at its published widths (18 layers, d_model 2048,
   MQA 8/1 heads of 256, d_ff 16384, vocab 256000, bf16), random weights
   from a seed, through ``DiffusionServeEngine`` with a ``RetirePolicy``
   and seq_len buckets (128, 256): two staggered waves of mixed-family
   requests (so a join happens), a warm replay that must add no executor,
   K1's launch count against the ``ab`` group steps served, the
   stacked-vs-solo difference of the eps-net on the card (reported, not
   asserted), and the card against the CPU on a reduced float32 model.

The line before the last is the kernel JSON; the last line is
``{"ok": true, "device": {...}}``. Exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
K1_TOL = 1e-6          # float32: FMA contraction and summation order
CARD_VS_CPU_TOL = 1e-3  # reduced float32 model: cuBLAS vs CPU summation order
HBM_BYTES_PER_S = 3.35e12   # H100 SXM published memory rate


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
    print("tf32: off for float32 matmuls and cuDNN convolutions")
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
    print(f"K1 check: {cases} cases (r 1..4 x noise x err x (R, M, D) in "
          f"(1|5, 70, 33), (5, 3, 1031), (2, 128, 2048)) within rtol=atol={K1_TOL}, "
          f"max abs err {max_err:.3e}; stacked rows bitwise equal to solo calls")

    # the main path's shape: a group of 8 rows at seq 256, d_model 2048, r=3
    R, m, d, r = 8, 256, 2048, 3
    args, kw = _k1_inputs(gen, device, R, m, d, r, False, True)
    timed = _timer(device)
    n_it = 200 if device.type == "cuda" else 5
    call = lambda: K.fused_ab_step(*args, **kw)
    plain = lambda: ref.fused_ab_step_ref(*args, **kw)
    out, e = call()
    want, want_e = plain()
    torch.testing.assert_close(out, want, rtol=K1_TOL, atol=K1_TOL)
    torch.testing.assert_close(e, want_e, rtol=K1_TOL, atol=K1_TOL)
    max_err = max(max_err, (out - want).abs().max().item(),
                  (e - want_e).abs().max().item())
    call_ms, plain_call_ms = timed(call, n=n_it), timed(plain, n=n_it)
    # each input read once, each output written once (x, r history slices,
    # the (R, 1 + 2r) float32 scalars in; x' and err out)
    nbytes = (r + 2) * R * m * d * 4 + R * (1 + 2 * r) * 4 + R * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    clock = "CUDA events" if device.type == "cuda" else "host clock"
    print(f"K1 at R={R} M={m} D={d} r={r} with err, per call ({clock}, "
          f"{n_it} back-to-back calls, wrapper included): kernel {call_ms:.4f} ms, "
          f"plain {plain_call_ms:.4f} ms")
    ms, plain_ms = call_ms, plain_call_ms
    if device.type == "cuda":
        dev = _device_kernel_us(call, 50)
        dev_plain = _device_kernel_us(plain, 50)
        k1 = [v for k, v in dev.items() if "fused_ab_kernel" in k]
        if k1 and dev_plain:
            ms, plain_ms = k1[0] / 1e3, sum(dev_plain.values()) / 1e3
            print(f"K1 device time (torch.profiler): kernel {ms:.4f} ms "
                  f"(bound / time = {bound_ms / ms:.3f}), "
                  f"wrapper's other kernels {(sum(dev.values()) / 1e3 - ms):.4f} ms, "
                  f"plain version {plain_ms:.4f} ms over {len(dev_plain)} kernels")
        else:
            print("K1 device time: the profiler saw no device time; CUDA-event times kept")
    print(f"K1 byte bound {bound_ms:.4f} ms ({nbytes} B at 3.35 TB/s), "
          "library call: none")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bytes=nbytes, shape=(R, m, d, r))


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


def phase_serve(device, reduced):
    from repro_torch.configs import get_config
    from repro_torch.core import RetirePolicy, VPSDE, get_timesteps, make_plan, solver_stages
    from repro_torch.kernels import deis_step as K
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import DiffusionServeEngine, Request

    cfg = get_config("gemma_2b").with_(objective="diffusion")
    if reduced:
        cfg = cfg.reduced()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device)
    _sync(device)
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"model: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s")

    sde = VPSDE()
    wave1, wave2 = _requests(Request)
    methods = {q.uid: make_plan(q.solver, sde, get_timesteps(
        sde, max(1, q.nfe // solver_stages(q.solver)))).method
        for q in wave1 + wave2}
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
    print(f"serve (cold): {len(cold)} requests of {len(set(q.solver for q in by_uid.values()))} "
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
    print(f"serve (warm replay): {warm_s:.3f} s, {n_tok} tokens ({n_tok / warm_s:.1f} "
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
    print(f"group step (dispatch to done, mean over the served groups): cold "
          f"{cold_ms:.3f} ms over {h_cold['count']} steps, warm {warm_ms:.3f} ms "
          f"over {n_warm} steps; peak memory {peak / 2**30:.2f} GiB")
    return cfg, params, sde, launches


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


def phase_card_vs_cpu(device):
    """The reduced float32 model on the card against the same model on the
    CPU (plain versions): finite x0 of the right shape that agree."""
    if device.type != "cuda":
        return
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


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced float32 model (rehearsal)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    device = torch.device(args.device)
    t_start = time.perf_counter()
    kind, count = phase_device(device)
    k1 = phase_k1(device)
    # launches: K1's count over the cold serve (reset just before it)
    cfg, params, sde, launches = phase_serve(device, args.reduced)
    phase_step_breakdown(device, cfg, params, sde, k1)
    phase_batch_invariance(device, cfg, params, sde)
    del params
    phase_card_vs_cpu(device)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "fused_ab_step", "route": "triton",
        "source": "src/repro_torch/kernels/deis_step.py",
        "replaces": "src/repro/kernels/deis_step.py:45",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": "bytes", "library_ms": None}]}))
    if device.type != "cuda":
        print("rehearsal ok (cpu): no device result")
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
