"""K2: blocked online-softmax attention (GQA, causal, sliding window), as
hand-written CUDA C++ kernels for Hopper (``csrc/flash_attention.cu``).

Replaces the Pallas kernel ``repro.kernels.flash_attention._kernel`` behind
``flash_attention`` (``src/repro/kernels/flash_attention.py``), with the
reference's layouts and semantics: q (B, Sq, H, D), k and v (B, Sk, KV, D),
query head h reading KV head ``h // (H // KV)`` in place, query positions
offset by ``Sk - Sq``, float32 online softmax and accumulation, output in
q's dtype.

What bounds it on the card: bytes at the one-shot path's shapes (gemma-2b,
B 4, S 256, H 8, KV 1, D 256, bf16: 9.4 MB against 2.1 GFLOP, 2.8 us at
3.35 TB/s); in float32 the operations (2.1 GFLOP at 165 TFLOP/s, the
tensor cores' TF32 rate over the three products of 3xTF32: 13 us). Four
kernels, one per route; :func:`route` picks it from the operands alone (a
pure function, so the CPU tests reach it):

* ``wgmma``: bf16 operands that a TMA tensor map can describe (every base
  pointer 16-byte aligned, D in :data:`WGMMA_HEAD_DIMS`) run
  ``flash_fwd_wgmma_kernel``: K/V tiles in a ring of shared-memory stages
  filled by TMA with mbarrier completion, products by warpgroup ``wgmma``;
* ``mma_sync``: other bf16 operands (an unaligned view, D 32) run
  ``flash_fwd_mma_kernel`` (``mma.sync`` fed by ``cp.async``);
* ``tf32x3``: float32 operands whose base pointers are 16-byte aligned
  run ``flash_fwd_tf32x3_kernel``: ``mma.sync`` m16n8k8 on TF32 operands,
  each float32 value split in registers into hi + lo and every product
  taken as three (hi hi + hi lo + lo hi, float32 sums), fed by ``cp.async``
  double buffering. One TF32 product keeps 10 bits of the significand and
  misses the float32 check (2e-5) by far; the three-term split keeps about
  21 and meets it;
* ``cuda_cores``: any other float32 operand (an unaligned view) runs
  ``flash_fwd_kernel``, in float32 on the CUDA cores.

Both bf16 kernels keep float32 softmax statistics and accumulators and
round the probabilities to bf16 once before PV. The source says how each
lays out its tiles; the times are in PERF.md.

A CUDA tensor launches the kernel of its route (``flash_attention.launches``
counts every launch, ``flash_attention.route_launches`` each route's); a
CPU tensor takes :func:`repro_torch.kernels.ref.flash_attention_ref`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, ref
from .runtime import use_kernel

HEAD_DIMS = (32, 64, 128, 256)       # the kernels' instantiations
WGMMA_HEAD_DIMS = (64, 128, 256)     # flash_fwd_wgmma_kernel's
_DTYPES = (torch.float32, torch.bfloat16)
# each route's code in the C entry's switch (flash_fwd_kernel,
# flash_fwd_mma_kernel, flash_fwd_wgmma_kernel, flash_fwd_tf32x3_kernel)
ROUTE_CODES = {"cuda_cores": 0, "mma_sync": 1, "wgmma": 2, "tf32x3": 3}
ROUTES = tuple(ROUTE_CODES)
_MAX_GRID_Y = 65535                  # B * H rides on grid axis 1
# flash_attention_fwd(q, k, v, out, route, B, Sq, Sk, H, KV, D, causal,
#                     window, scale, stream)
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]


def _check(q, k, v, window) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 q, "
                        f"k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"need q (B, Sq, H, D) and k, v (B, Sk, KV, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} "
                         "(same batch and head dim, H % KV == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    if min(b, sq, h, k.shape[1]) < 1 or b * h > _MAX_GRID_Y:
        raise ValueError(f"need 1 <= B*H <= {_MAX_GRID_Y} and nonempty "
                         f"sequences, got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def route(q, k, v) -> str:
    """The route of a launch on these operands: for float32, ``tf32x3``
    where every base pointer is 16-byte aligned (each row of D floats then
    starts on a 16-byte line for ``cp.async``), else ``cuda_cores``; for
    bf16, ``wgmma`` where TMA can describe them (16-byte aligned base
    pointers; contiguous rows of D in :data:`WGMMA_HEAD_DIMS`, a multiple of
    16 bytes), else ``mma_sync``."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    if q.dtype == torch.float32:
        return "tf32x3" if aligned else "cuda_cores"
    if q.shape[-1] in WGMMA_HEAD_DIMS and aligned:
        return "wgmma"
    return "mma_sync"


def _launch(fn, q, k, v, causal: bool, window: int, stream, scale=None) -> torch.Tensor:
    """Check the operands, allocate the output and launch ``fn`` on
    ``stream`` on the operands' :func:`route`, the logits times ``scale``
    (None: ``1/sqrt(D)``); raise on a nonzero CUDA error."""
    _check(q, k, v, window)
    name = route(q, k, v)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             ROUTE_CODES[name], b, sq, sk, h, kv, d, 1 if causal else 0, window,
             1.0 / math.sqrt(d) if scale is None else scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.route_launches[name] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D), H % KV == 0; the logits
    times ``scale`` (None: ``1/sqrt(D)``). Returns (B, Sq, H, D) in q's
    dtype."""
    if not use_kernel(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    with torch.cuda.device(q.device):
        fn = build.entry("flash_attention", "flash_attention_fwd", ARGTYPES)
        return _launch(fn, q, k, v, causal, window,
                       torch.cuda.current_stream().cuda_stream, scale=scale)


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
