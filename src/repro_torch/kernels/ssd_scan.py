"""K3: the Mamba2 SSD chunked scan, as hand-written CUDA C++ kernels for
Hopper (``csrc/ssd_scan.cu``).

Replaces the Pallas kernel ``repro.kernels.ssd_scan._kernel`` behind
``ssd_scan`` (``src/repro/kernels/ssd_scan.py``), with the reference's
layouts and semantics: x (Bb, S, H, P), a (Bb, S, H) float32, B and C
(Bb, S, N) shared by the heads; chunk ``min(chunk, S)``; the 1e-37 clamp
before the log; padding with a = 1 and x = 0; y in x's dtype and the final
state (Bb, H, P, N) in float32.

What bounds it on the card: bytes at the one-shot path's shapes
(mamba2-2.7b, Bb 4, S 256, H 80, P 64, N 128, chunk 256, bf16: 32.3 MB
against 6.7 GFLOP of lower-triangle work, 9.6 us at 3.35 TB/s). One block
per (batch, head) walks the chunks in order with the float32 state on chip.
The dtype of x, B and C picks the kernel (:data:`ROUTES`): bf16 runs on the
tensor cores (``mma.sync``; the float32 factors, the decayed scores, the
decayed x and the state, split into bf16 high and low parts against the
exact bf16 operands); float32 runs on the CUDA cores in float32 throughout,
since bf16 or TF32 tensor cores cannot meet the float32 check. The times
are in PERF.md.

A CUDA tensor launches the kernel of its route (``ssd_scan.launches`` counts
every launch, ``ssd_scan.route_launches`` each route's); a CPU tensor takes
:func:`repro_torch.kernels.ref.ssd_scan_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref
from .runtime import use_kernel

MAX_HEAD_DIM, MAX_STATE, MAX_CHUNK = 64, 128, 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel each dtype launches: ssd_scan_mma_kernel or ssd_scan_kernel
ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}
# ssd_scan_fwd(x, a, B, C, y, state, dtype, Bb, S, H, P, N, L, stream)
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _check(x, a, B, C, chunk) -> None:
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16 x, B, C "
                        f"of one dtype, got {x.dtype}, {B.dtype}, {C.dtype}")
    if a.dtype != torch.float32:
        raise TypeError(f"a must be float32, got {a.dtype}")
    if x.ndim != 4 or a.ndim != 3 or B.ndim != 3 or tuple(B.shape) != tuple(C.shape):
        raise ValueError(f"need x (Bb, S, H, P), a (Bb, S, H), B and C (Bb, S, N), "
                         f"got {tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    bb, s, h, p = x.shape
    if tuple(a.shape) != (bb, s, h) or tuple(B.shape[:2]) != (bb, s):
        raise ValueError(f"a {tuple(a.shape)} and B, C {tuple(B.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    n = B.shape[2]
    if min(bb, s, h) < 1 or not (1 <= p <= MAX_HEAD_DIM and 1 <= n <= MAX_STATE):
        raise ValueError(f"the kernel takes nonempty Bb, S, H, head dim <= "
                         f"{MAX_HEAD_DIM} and state <= {MAX_STATE}, got x "
                         f"{tuple(x.shape)}, state {n}")
    if not 1 <= min(chunk, s) <= MAX_CHUNK:
        raise ValueError(f"chunk must be in 1..{MAX_CHUNK}, got {min(chunk, s)}")
    for name, t in (("x", x), ("a", a), ("B", B), ("C", C)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(fn, x, a, B, C, chunk: int, stream):
    """Check the operands, allocate y and the state and launch ``fn`` on
    ``stream``; raise on a nonzero CUDA error."""
    _check(x, a, B, C, chunk)
    bb, s, h, p = x.shape
    n = B.shape[2]
    y = torch.empty_like(x)
    state = torch.empty((bb, h, p, n), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
             state.data_ptr(), _DTYPES[x.dtype], bb, s, h, p, n, min(chunk, s), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    ssd_scan.route_launches[ROUTES[x.dtype]] += 1
    return y, state


def ssd_scan(x, a, B, C, *, chunk: int = 128):
    """x: (Bb, S, H, P); a: (Bb, S, H) float32; B, C: (Bb, S, N). Returns
    ``(y, final_state)``: y (Bb, S, H, P) in x's dtype, final_state
    (Bb, H, P, N) float32."""
    if not use_kernel(x, a, B, C):
        return ref.ssd_scan_ref(x, a, B, C, chunk=chunk)
    with torch.cuda.device(x.device):
        fn = build.entry("ssd_scan", "ssd_scan_fwd", ARGTYPES)
        return _launch(fn, x, a, B, C, chunk,
                       torch.cuda.current_stream().cuda_stream)


ssd_scan.launches = 0
ssd_scan.route_launches = dict.fromkeys(ROUTES.values(), 0)
