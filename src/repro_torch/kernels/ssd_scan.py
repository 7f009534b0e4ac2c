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
against 4.1 GFLOP of lower-triangle work with C B^T once per batch, 9.6 us
at 3.35 TB/s); in float32 the operations (24.6 us at 165 TFLOP/s, the
tensor cores' TF32 rate over the three products of 3xTF32). Four kernels,
one per route; :func:`route` picks it from the operands alone (a pure
function, so the CPU tests reach it):

* ``wgmma``: bf16 x, B and C that a TMA tensor map can describe (base
  pointers 16-byte aligned, P and N multiples of 8) run
  ``ssd_scan_wgmma_kernel``: C B^T computed once per (batch, chunk, query
  tile) for the heads a block owns, tiles by TMA into an mbarrier ring, the
  products by warpgroup ``wgmma``;
* ``mma_sync``: other bf16 operands run ``ssd_scan_mma_kernel``, one block
  per (batch, head) on ``mma.sync``;
* ``tf32x3``: float32 x, B and C with P and N multiples of 8 and 16-byte
  aligned base pointers run ``ssd_scan_tf32x3_kernel``: a block owns two
  heads of a batch (C B^T once for both), ``mma.sync`` m16n8k8 on TF32
  operands, each float32 factor split in registers into hi + lo and every
  product taken as three (float32 sums), key tiles double-buffered by
  ``cp.async``. One TF32 product misses the float32 check (2e-4) by far;
  the three-term split meets it;
* ``cuda_cores``: any other float32 operand runs ``ssd_scan_kernel``, in
  float32 on the CUDA cores.

Both bf16 kernels split the float32 factors (the decayed scores, the
decayed x, the state) into bf16 high and low parts against the exact bf16
operands. The times are in PERF.md.

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
TILE = 64                      # steps per query tile of the wgmma kernel
_DTYPES = (torch.float32, torch.bfloat16)
# each route's code in the C entry's switch (ssd_scan_kernel,
# ssd_scan_mma_kernel, ssd_scan_wgmma_kernel, ssd_scan_tf32x3_kernel)
ROUTE_CODES = {"cuda_cores": 0, "mma_sync": 1, "wgmma": 2, "tf32x3": 3}
ROUTES = tuple(ROUTE_CODES)
# ssd_scan_fwd(x, a, B, C, y, state, scratch, route, Bb, S, H, P, N, L, stream)
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


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


def route(x, B, C) -> str:
    """The route of a launch on these operands: where P and N are multiples
    of 8 and every base pointer is 16-byte aligned (so that every row starts
    on a 16-byte line, for TMA and ``cp.async``), ``tf32x3`` for float32 and
    ``wgmma`` for bf16; else ``cuda_cores`` for float32 and ``mma_sync`` for
    bf16."""
    tiled = x.shape[-1] % 8 == 0 and B.shape[-1] % 8 == 0 \
        and all(t.data_ptr() % 16 == 0 for t in (x, B, C))
    if x.dtype == torch.float32:
        return "tf32x3" if tiled else "cuda_cores"
    return "wgmma" if tiled else "mma_sync"


def _scratch_floats(bb, s, h, p, n, chunk) -> int:
    """Float32 scratch the wgmma kernel needs: a private state (P x N) for
    each query-tile block of each (batch, head) when S spans more than one
    chunk (each such block carries the state across chunks itself); none
    for one chunk."""
    L = min(chunk, s)
    return 0 if s <= L else bb * h * -(-L // TILE) * p * n


def _launch(fn, x, a, B, C, chunk: int, stream):
    """Check the operands, allocate y, the state (and the wgmma kernel's
    scratch) and launch ``fn`` on ``stream`` on the operands'
    :func:`route`; raise on a nonzero CUDA error."""
    _check(x, a, B, C, chunk)
    name = route(x, B, C)
    bb, s, h, p = x.shape
    n = B.shape[2]
    y = torch.empty_like(x)
    state = torch.empty((bb, h, p, n), dtype=torch.float32, device=x.device)
    scratch = None
    if name == "wgmma" and _scratch_floats(bb, s, h, p, n, chunk):
        scratch = torch.empty(_scratch_floats(bb, s, h, p, n, chunk), dtype=torch.float32,
                              device=x.device)
    err = fn(x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
             state.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
             ROUTE_CODES[name], bb, s, h, p, n, min(chunk, s), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    ssd_scan.route_launches[name] += 1
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
ssd_scan.route_launches = dict.fromkeys(ROUTES, 0)
