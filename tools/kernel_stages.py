#!/usr/bin/env python3
"""Where the tensor-core kernels of K2 and K3 spend their time, on the card.

    python3 tools/kernel_stages.py                 # both routes, on a machine with a CUDA card
    python3 tools/kernel_stages.py tf32x3          # the float32 kernels only (or: wgmma)

Builds variants of the bf16 kernels (route ``wgmma``:
``flash_fwd_wgmma_kernel``, ``ssd_scan_wgmma_kernel``) and of the float32
ones (route ``tf32x3``: ``flash_fwd_tf32x3_kernel``,
``ssd_scan_tf32x3_kernel``), each with one stage of the work taken out by a
text edit of its source (``csrc/flash_attention.cu``, ``csrc/ssd_scan.cu``),
into ``build/stages`` (one nvcc per variant, all started together), and
times each at the main paths' shapes: device time of the kernel by
torch.profiler, the best of 3 runs of 20 launches, each variant in a
process of its own (a variant that faults cannot spoil the others'
numbers). A variant's results are wrong by design; only its time is read.
The stages:

* K2 wgmma: the softmax (masks, max, exp, sum, rescale), and within it the
  rescale of O, the row maxima's shuffles, the exponentials, the
  denominators' shuffles; the S = Q K^T products; the O += P V products;
  all three (the loads and the pipeline alone); the epilogue (merge and
  store);
* K3 wgmma: the decay exp(cum_t - cum_u) of the scores, the W x products
  (and W), the C B^T products, the merge and store of y;
* K2 tf32x3: the S = Q K^T products (and Q's and K's splits), the softmax,
  the O += P V products (and P's and V's splits), all three (the loads
  alone), the epilogue (merge of the key halves and store), and every
  product as one TF32 product instead of three (what the 3xTF32 split
  costs);
* K3 tf32x3: the scores C B^T, the decay exponentials, the W x products
  (and W's and x's splits), the state's products, the store of y, and every
  product as one TF32 product instead of three.

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
K2_SHAPES = {"gemma": (4, 256, 8, 1, 256), "mixtral": (4, 256, 32, 8, 128),
             "whisper": (4, 256, 6, 6, 64), "paligemma": (4, 512, 8, 1, 256)}
SHAPES = {("K2", "wgmma"): K2_SHAPES,
          ("K2", "tf32x3"): dict(K2_SHAPES, glm4=(4, 256, 32, 2, 128), cifar10=(4, 256, 4, 4, 64)),
          ("K3", "wgmma"): {"mamba2": (4, 256, 80, 64, 128, 256)},
          ("K3", "tf32x3"): {"mamba2": (4, 256, 80, 64, 128, 256)}}


def _cut(src, first, last, alt="", kernel="_wgmma_kernel("):
    """src with the lines from the one holding ``first`` to the end of
    ``last`` replaced by ``alt``, both searched from ``kernel`` on."""
    a = src.index(first, src.index(kernel))
    a = src.rindex("\n", 0, a) + 1
    b = src.index(last, a) + len(last)
    return src[:a] + alt + src[b:]


def _one_product(src):
    """src with every 3xTF32 product taken as its hi hi product alone (a
    copy of ptx.cuh with the two small terms of ``mma_3xtf32`` cut)."""
    ptx = (CSRC / "ptx.cuh").read_text()
    small = ("    for (int j = 0; j < NB; ++j) mma_tf32_1688(acc[j], al, bh[j][0], bh[j][1]);\n"
             "#pragma unroll\n"
             "    for (int j = 0; j < NB; ++j) mma_tf32_1688(acc[j], ah, bl[j][0], bl[j][1]);\n"
             "#pragma unroll\n")
    assert small in ptx
    OUT.mkdir(parents=True, exist_ok=True)
    one = OUT / "ptx_one_product.cuh"
    one.write_text(ptx.replace(small, ""))
    return src.replace('#include "ptx.cuh"', f'#include "{one}"')


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


def k2_tf32_variants():
    src = (CSRC / "flash_attention.cu").read_text()
    cut = lambda text, first, last, alt="": _cut(text, first, last, alt, "_tf32x3_kernel(")
    s_mm = ("#pragma unroll 4\n        for (int kk = 0; kk < D / 8; ++kk) {",
            "mma_3xtf32<NB>(s, ah, al, bh, bl);\n        }",
            "for (int j = 0; j < NB; ++j) for (int e = 0; e < 4; ++e) s[j][e] = 0.01f * (j + e);")
    soft = ("// masks (skipped when every key of the warp's share", "o[j][3] *= alpha[1];\n        }",
            "for (int j = 0; j < NB; ++j) for (int e = 0; e < 4; ++e) s[j][e] *= 0.001f;")
    pv = ("// O += P V: P's accumulators of keys", "mma_3xtf32<T::NBG>(o + nb0, ph, pl, bh, bl);\n"
          "            }\n        }", "o[0][0] += s[0][0];")
    epi = ("if constexpr (KS == 2) {", "make_float2(o[j][2 * r] / den, o[j][2 * r + 1] / den);\n    }",
           "    if (qpos[0] == -7) out[0] = o[0][0] + l[0] + m[0];")
    return {"full": src, "no S": cut(src, *s_mm), "no softmax": cut(src, *soft),
            "no PV": cut(src, *pv), "loads only": cut(cut(cut(src, *pv), *soft), *s_mm),
            "no epilogue": cut(src, *epi), "one TF32 product": _one_product(src)}


def k3_tf32_variants():
    src = (CSRC / "ssd_scan.cu").read_text()
    cut = lambda text, first, last, alt="": _cut(text, first, last, alt, "ssd_scan_tf32x3_kernel(")
    k = src.index("ssd_scan_tf32x3_kernel(")
    decay = src[:k] + src[k:].replace("* __expf(ct0 - cu", "* (1.f + ct0 - cu").replace(
        "* __expf(ct1 - cu", "* (1.f + ct1 - cu")
    assert decay.count("(1.f + ct") == 4
    scores = ("if (nkg > 4) scores_tf32x3<8>(sc, cw, bs, g, t4);", "else scores_tf32x3<4>(sc, cw, bs, g, t4);",
              "for (int jn = 0; jn < 8; ++jn) for (int e = 0; e < 4; ++e) sc[jn][e] = 0.01f * (jn + e);")
    wx = ("const float* xr = xj + (8 * kg + 2 * t4) * LDX + g;", "mma_3xtf32<8>(acc[j], wh, wl, bh, bl);",
          "acc[j][kg][0] += __uint_as_float(wh[0]) + __uint_as_float(wl[3]);")
    state = ("#pragma unroll 2\n                for (int ks = 0; ks < TILE / 8; ++ks) {",
             "mma_3xtf32<8>(hacc[i], ah, al, bh, bl);\n                }",
             "hacc[i][0][0] += ej[lane] + xj[lane];")
    y_out = ("for (int r = 0; r < 2; ++r) {\n                    const int s = c0 + tr[r];",
             "make_float2(acc[j][jp][2 * r], acc[j][jp][2 * r + 1]);\n                    }\n                }",
             "if (tr[0] == -7) yb[0] = acc[j][0][0];")
    return {"full": src, "no scores": cut(src, *scores), "no decay exp": decay,
            "no W x": cut(src, *wx), "no state": cut(src, *state), "no y store": cut(src, *y_out),
            "one TF32 product": _one_product(src)}


VARIANTS = {("K2", "wgmma"): k2_variants, ("K3", "wgmma"): k3_variants,
            ("K2", "tf32x3"): k2_tf32_variants, ("K3", "tf32x3"): k3_tf32_variants}


def build(routes):
    """Write and compile every variant of the kernels of ``routes`` with the
    package's nvcc and flags; {(kernel, route, variant): library}."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kbuild
    nvcc = (kbuild._nvcc(), *kbuild.FLAGS)
    OUT.mkdir(parents=True, exist_ok=True)
    procs, libs = {}, {}
    for (kernel, route), make in VARIANTS.items():
        if route not in routes:
            continue
        for i, (name, text) in enumerate(make().items()):
            cu = OUT / f"{kernel}_{route}_{i}.cu"
            cu.write_text(text.replace('#include "ptx.cuh"', f'#include "{CSRC / "ptx.cuh"}"'))
            lib = OUT / f"lib{kernel}_{route}_{i}.so"
            procs[kernel, route, name] = (subprocess.Popen(
                [*nvcc, "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), lib)
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc exited {proc.returncode}\n{log[-3000:]}")
        libs[key] = lib
    return libs


def time_variant(kernel, route, lib) -> dict:
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
    dtype = torch.bfloat16 if route == "wgmma" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for shape, dims in SHAPES[kernel, route].items():
        if mod is FA:
            b, s, h, kv, d = dims
            args = (rnd(b, s, h, d), rnd(b, s, kv, d), rnd(b, s, kv, d), False, 0)
        else:
            b, s, h, p, n, chunk = dims
            a = torch.rand((b, s, h), generator=gen, device=dev) * 0.299 + 0.7
            args = (rnd(b, s, h, p), a, rnd(b, s, n), rnd(b, s, n), chunk)
        call = lambda: mod._launch(fn, *args, stream)
        best = min(sum(us for name, us in chip_smoke._device_kernel_us(call, 20).items()
                       if route in name) for _ in range(3))
        out[shape] = best
    return out


def main() -> int:
    if len(sys.argv) == 4:   # child: time one variant, print its JSON
        print(json.dumps(time_variant(*sys.argv[1:])))
        return 0
    routes = sys.argv[1:] or ["wgmma", "tf32x3"]
    libs = build(routes)
    rows = {}
    for (kernel, route, name), lib in libs.items():
        child = subprocess.run([sys.executable, __file__, kernel, route, str(lib)],
                               capture_output=True, text=True, timeout=300)
        last = child.stdout.strip().splitlines()[-1:] if child.returncode == 0 else []
        rows[kernel, route, name] = json.loads(last[0]) if last else None
        if not last:
            print(f"stages {kernel} {route} {name}: exit {child.returncode}: "
                  + " | ".join(child.stderr.strip().splitlines()[-3:]))
    for kernel, route in VARIANTS:
        if route not in routes:
            continue
        full = rows[kernel, route, "full"]
        for (k, r, name), got in rows.items():
            if (k, r) != (kernel, route):
                continue
            cells = ("faulted" if got is None else ", ".join(
                f"{shape} {us:.1f} us" + ("" if name == "full" else f" ({us - full[shape]:+.1f})")
                for shape, us in got.items()))
            print(f"stages {kernel} {route} {name}: {cells}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
