#!/usr/bin/env python3
"""Where the bf16 wgmma kernels of K2 and K3 spend their time, on the card.

    python3 tools/kernel_stages.py            # on a machine with a CUDA card

Builds variants of ``flash_fwd_wgmma_kernel`` (``csrc/flash_attention.cu``)
and ``ssd_scan_wgmma_kernel`` (``csrc/ssd_scan.cu``), each with one stage
of the work taken out by a text edit of the source, into ``build/stages``
(one nvcc per variant, all started together), and times each at the main
paths' shapes: device time of the kernel by torch.profiler, the best of 3
runs of 20 launches, each variant in a process of its own (a variant that
faults cannot spoil the others' numbers). A variant's results are wrong by
design; only its time is read. The stages:

* K2: the softmax (masks, max, exp, sum, rescale), and within it the
  rescale of O, the row maxima's shuffles, the exponentials, the
  denominators' shuffles; the S = Q K^T products; the O += P V products;
  all three (the loads and the pipeline alone); the epilogue (merge and
  store);
* K3: the decay exp(cum_t - cum_u) of the scores, the W x products (and
  W), the C B^T products, the merge and store of y.

The full kernel less a variant is what that stage costs where it does not
overlap the rest.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "stages"
SHAPES = {"K2": {"gemma": (4, 256, 8, 1, 256), "mixtral": (4, 256, 32, 8, 128),
                 "whisper": (4, 256, 6, 6, 64), "paligemma": (4, 512, 8, 1, 256)},
          "K3": {"mamba2": (4, 256, 80, 64, 128, 256)}}


def _cut(src, first, last, alt=""):
    """src with the lines from the one holding ``first`` to the end of
    ``last`` replaced by ``alt``, both searched from the wgmma kernel on."""
    a = src.index(first, src.index("_wgmma_kernel("))
    a = src.rindex("\n", 0, a) + 1
    b = src.index(last, a) + len(last)
    return src[:a] + alt + src[b:]


def k2_variants():
    src = (CSRC / "flash_attention.cu").read_text()
    soft = ("// masks, scale, online softmax", "for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e >> 1) & 1];",
            "for (int e = 0; e < 32; ++e) sc[e] *= 0.001f;")
    s_mm = ("wgmma_fence();\n#pragma unroll\n        for (int kk = 0; kk < D / 16; ++kk)",
            "reg_fence(sc);", "for (int e = 0; e < 32; ++e) sc[e] = 0.01f * e;")
    pv = ("for (int c = 0; c < CH; ++c) reg_fence(o[c]);\n        wgmma_fence();",
          "for (int kk = 0; kk < 4; ++kk) reg_fence(pa[kk]);", "")
    epi = ("    if constexpr (!KSPLIT) {", "bulk_wait_read();\n        }\n    }",
           "    if (qpos[0] == -7) qs[0] = (unsigned char)(o[0][0] + l[0]);")
    rescale = ("if (alpha[0] != 1.f || alpha[1] != 1.f)", "o[c][e] *= alpha[(e >> 1) & 1];", "")
    row_max = ("mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));",
               "mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));", "")
    denom = ("psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);",
             "psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);", "")
    wg = src.index("_wgmma_kernel(")
    no_exp = src[:wg] + src[wg:].replace("? exp2f(v - m[r]) : 0.f;", "? v - m[r] : 0.f;", 1)
    return {"full": src, "no softmax": _cut(src, *soft), "no o rescale": _cut(src, *rescale),
            "no row max shuffles": _cut(src, *row_max), "no exponentials": no_exp,
            "no denominator shuffles": _cut(src, *denom), "no S": _cut(src, *s_mm),
            "no PV": _cut(src, *pv), "loads only": _cut(_cut(_cut(src, *pv), *soft), *s_mm),
            "no epilogue": _cut(src, *epi)}


def k3_variants():
    src = (CSRC / "ssd_scan.cu").read_text()
    decay = src.replace("* exp2f(ct[r] - cu0)", "* (1.f + ct[r] - cu0)").replace(
        "* exp2f(ct[r] - cu1)", "* (1.f + ct[r] - cu1)")
    wx = _cut(src, "decayed_scores_times_x(acc[j]", "bs + (2 + j) * BOX, t4);", ";")
    cb = _cut(src, "float sc[32];\n                    wgmma_fence();", "reg_fence(sc);",
              "float sc[32];\nfor (int e = 0; e < 32; ++e) sc[e] = 0.01f * e;")
    y_out = _cut(src, "// warpgroup 1's partial y into warpgroup 0's, then y out",
                 "acc[j][e + 1] + xacc[(j * 32 + e + 1) * 128 + tid]);\n                            }\n                        }\n                }",
                 "if (tid == 999) y[0] = __float2bfloat16(acc[0][0]);")
    return {"full": src, "no decay exp": decay, "no W x": wx, "no C B^T": cb,
            "no y merge and store": y_out}


def build():
    """Write and compile every variant with the package's nvcc and flags;
    {(kernel, variant): library}."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kbuild
    nvcc = (kbuild._nvcc(), *kbuild.FLAGS)
    OUT.mkdir(parents=True, exist_ok=True)
    procs, libs = {}, {}
    for kernel, variants in (("K2", k2_variants()), ("K3", k3_variants())):
        for i, (name, text) in enumerate(variants.items()):
            cu = OUT / f"{kernel}_{i}.cu"
            cu.write_text(text.replace('#include "ptx.cuh"', f'#include "{CSRC / "ptx.cuh"}"'))
            lib = OUT / f"lib{kernel}_{i}.so"
            procs[kernel, name] = (subprocess.Popen([*nvcc, "-o", str(lib), str(cu)],
                                                    stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True), lib)
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc exited {proc.returncode}\n{log[-3000:]}")
        libs[key] = lib
    return libs


def time_variant(kernel, lib) -> dict:
    """{shape: device us} of one built variant (run in a child process)."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SS
    mod = FA if kernel == "K2" else SS
    fn = getattr(ctypes.CDLL(str(lib)), f"{'flash_attention' if mod is FA else 'ssd_scan'}_fwd")
    fn.argtypes, fn.restype = mod.ARGTYPES, ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for shape, dims in SHAPES[kernel].items():
        if mod is FA:
            b, s, h, kv, d = dims
            args = (rnd(b, s, h, d), rnd(b, s, kv, d), rnd(b, s, kv, d), False, 0)
        else:
            b, s, h, p, n, chunk = dims
            a = torch.rand((b, s, h), generator=gen, device=dev) * 0.299 + 0.7
            args = (rnd(b, s, h, p), a, rnd(b, s, n), rnd(b, s, n), chunk)
        call = lambda: mod._launch(fn, *args, stream, "wgmma")
        best = min(sum(us for name, us in chip_smoke._device_kernel_us(call, 20).items()
                       if "wgmma" in name) for _ in range(3))
        out[shape] = best
    return out


def main() -> int:
    if len(sys.argv) == 3:   # child: time one variant, print its JSON
        print(json.dumps(time_variant(sys.argv[1], sys.argv[2])))
        return 0
    libs = build()
    rows = {}
    for (kernel, name), lib in libs.items():
        child = subprocess.run([sys.executable, __file__, kernel, str(lib)], capture_output=True,
                               text=True, timeout=300)
        last = child.stdout.strip().splitlines()[-1:] if child.returncode == 0 else []
        rows[kernel, name] = json.loads(last[0]) if last else None
        if not last:
            print(f"stages {kernel} {name}: exit {child.returncode}: "
                  + " | ".join(child.stderr.strip().splitlines()[-3:]))
    for kernel in ("K2", "K3"):
        full = rows[kernel, "full"]
        for (k, name), got in rows.items():
            if k != kernel:
                continue
            cells = ("faulted" if got is None else ", ".join(
                f"{shape} {us:.1f} us" + ("" if name == "full" else f" ({us - full[shape]:+.1f})")
                for shape, us in got.items()))
            print(f"stages {kernel} {name}: {cells}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
