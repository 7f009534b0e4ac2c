"""Peaks of the chip and the least time a kernel's call could take.

Frozen copies: the constants of ``chip_smoke.py`` (H100 SXM, NVIDIA's
data sheet; the same figures as the port's ``launch/mesh.py``), its
``_bound`` (the larger of bytes over the memory rate and operations over
the compute rate), and the byte and operation counts of its ``phase_k1``
(K1: each input read once, each output written once) and ``phase_k3`` (K3:
x, a, B, C read once, y and the float32 state written once; C B^T counted
once per batch, since B and C carry no head axis).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core rate
FP32_FLOPS = 67e12          # H100 SXM float32 rate outside the tensor cores
TF32X3_FLOPS = 495e12 / 3   # float32 as three TF32 products on the tensor cores


def bound_s(nbytes: float, flops: float, flop_rate: float = BF16_FLOPS) -> float:
    """The least time (s) for the work: bytes at the memory rate or
    operations at ``flop_rate``, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_rate)


def k1_bytes(rows: int, m: int, d: int, r: int, noise: bool = False, err: bool = False,
             elem: int = 4) -> int:
    """K1 ``fused_ab_step`` on x (rows, m, d) with an r-deep history: x, the
    r history slices (and the noise) read, x' written; the (rows, 1 + r
    [+ 1] [+ r]) float32 scalars read, the per-block error partials
    ignored (a few bytes a row)."""
    planes = r + 2 + (1 if noise else 0)
    ncols = 1 + r + (1 if noise else 0) + (r if err else 0)
    return planes * rows * m * d * elem + rows * ncols * 4 + (rows * 4 if err else 0)


def k3_work(b: int, s: int, h: int, p: int, n: int, chunk: int, elem: int = 2) -> tuple[int, int]:
    """(bytes, operations) of K3 ``ssd_scan`` on x (b, s, h, p), a (b, s, h)
    float32, B and C (b, s, n): per chunk of L = min(chunk, s) the lower
    triangle of C B^T (N each, once per batch), per head the lower triangle
    of W x (P each) and C h^T and x^T B (L N P each)."""
    L = min(chunk, s)
    n_chunks = -(-s // L)
    nbytes = elem * (b * s * h * p * 2 + b * s * n * 2) + 4 * b * s * h + 4 * b * h * p * n
    tri = L * (L + 1) // 2
    flops = b * n_chunks * 2 * tri * n + b * h * n_chunks * (2 * tri * p + 2 * 2 * L * n * p)
    return nbytes, flops
