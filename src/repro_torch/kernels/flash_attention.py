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
3.35 TB/s). The dtype picks the kernel (:data:`ROUTES`): bf16 operands run
on the tensor cores (``mma.sync``, bf16 products into float32, the
probabilities rounded to bf16 once before PV); float32 operands run on the
CUDA cores in float32 throughout, since bf16 or TF32 tensor cores cannot
meet the float32 check. The source says how each lays out its tiles; the
times are in PERF.md.

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

HEAD_DIMS = (32, 64, 128, 256)       # the kernel's instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel each dtype launches: flash_fwd_mma_kernel or flash_fwd_kernel
ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}
_MAX_GRID_Y = 65535                  # B * H rides on grid axis 1
# flash_attention_fwd(q, k, v, out, dtype, B, Sq, Sk, H, KV, D, causal,
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


def _launch(fn, q, k, v, causal: bool, window: int, stream) -> torch.Tensor:
    """Check the operands, allocate the output and launch ``fn`` on
    ``stream``; raise on a nonzero CUDA error."""
    _check(q, k, v, window)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             _DTYPES[q.dtype], b, sq, sk, h, kv, d, 1 if causal else 0, window,
             1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.route_launches[ROUTES[q.dtype]] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k, v: (B, Sk, KV, D), H % KV == 0. Returns
    (B, Sq, H, D) in q's dtype."""
    if not use_kernel(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    with torch.cuda.device(q.device):
        fn = build.entry("flash_attention", "flash_attention_fwd", ARGTYPES)
        return _launch(fn, q, k, v, causal, window,
                       torch.cuda.current_stream().cuda_stream)


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES.values(), 0)
