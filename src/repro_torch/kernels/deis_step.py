"""Fused DEIS multistep update (paper Eq. 14), stacked-plan form, as a
Triton kernel for Hopper.

    x'_row  = psi_row * x_row + sum_{j<r} C_row[j] * hist[j, row]
              (+ s_row * noise_row)                        [stochastic leaf]
    err_row = max_elem | sum_{j<r} E_row[j] * hist[j, row] |   [error pair]

Replaces the Pallas kernel ``repro.kernels.deis_step._kernel`` behind
``fused_ab_step`` / ``deis_step`` (``src/repro/kernels/deis_step.py``).

What bounds it on the card: bytes. It does 2 flops per element and operand
and no tensor-core work, so its least time is its traffic over the memory
rate: ``(r + 2 [+ 1 with noise]) * R * M * D * itemsize`` bytes per call
(x, r history slices and the noise read once, the output written once; the
per-row scalars and the error partials are a few hundred bytes).

Design: a single pass. The grid is ``(block of the flattened M*D elements,
row)`` (blocks on the first axis, which has no 65535 limit). Each program loads its row's scalars from the ``(R, ncols)``
operand laid out ``[psi, C_0..C_{r-1}, s?, E_0..E_{r-1}?]``, streams its
block of x, of every history slice and of the noise exactly once with
coalesced loads, accumulates in float32 in the reference's order (psi*x
first, then C_j*h_j for j = 0..r-1, then s*noise) and stores in x's dtype.
It is compiled without floating-point contraction (``enable_fp_fusion``
off): each product and each sum is rounded on its own, as the plain
version's separate PyTorch ops round them, so the kernel is bitwise equal
to the plain version. With contraction on, Triton fuses ``acc + c * h``
into FMAs, and where the terms cancel the two differ by up to 0.8 of the
tests' 1e-6 + 1e-6 |want| (probed over 24 input draws at R 8, M 256, D
2048, r 4): the margin of a card test that failed once.
With the error pair on, it also writes one partial ``max |E.h|`` per
program into an ``(R, n_blocks)`` buffer that the wrapper reduces with
``amax``: max is exact in any order, so ``err`` does not depend on how the
blocks are scheduled. ``r``, the noise and the error pair are ``constexpr``
(the Pallas kernel's static unroll); the row count is a runtime argument
that Triton does not specialise on, so every element runs the same
instructions whatever R is and a row of a stacked call is bitwise equal to
the same row called alone. Making the kernel fast (wider tiles, fewer
programs) is later work; its times are in PERF.md.
"""
from __future__ import annotations

import os
from pathlib import Path

import torch

from . import ref
from .runtime import use_kernel

BLOCK = 1024          # elements per program: 8 float32 per thread at 4 warps
NUM_WARPS = 4
_REPO_ROOT = Path(__file__).resolve().parents[3]

_kernel = None        # the @triton.jit function, built at first launch


def _build():
    """Import Triton and define the kernel (first launch only: the module
    must import where Triton is absent). Triton's cache goes to
    ``build/triton`` in the checkout unless TRITON_CACHE_DIR is set."""
    global _kernel
    if _kernel is not None:
        return _kernel
    os.environ.setdefault("TRITON_CACHE_DIR", str(_REPO_ROOT / "build" / "triton"))
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["n_rows"])
    def fused_ab_kernel(scal_ptr, x_ptr, hist_ptr, noise_ptr, out_ptr,
                        errp_ptr, n_rows, n_elem, n_blocks, ncols,
                        R_HIST: tl.constexpr, HAS_NOISE: tl.constexpr,
                        HAS_ERR: tl.constexpr, E_OFF: tl.constexpr,
                        BLK: tl.constexpr):
        blk = tl.program_id(0)
        row = tl.program_id(1).to(tl.int64)
        offs = blk * BLK + tl.arange(0, BLK)
        mask = offs < n_elem
        srow = scal_ptr + row * ncols
        x = tl.load(x_ptr + row * n_elem + offs, mask=mask, other=0.0)
        acc = tl.load(srow) * x.to(tl.float32)
        e = tl.zeros([BLK], dtype=tl.float32)
        for j in tl.static_range(R_HIST):
            h = tl.load(hist_ptr + (j * n_rows + row) * n_elem + offs,
                        mask=mask, other=0.0).to(tl.float32)
            acc += tl.load(srow + 1 + j) * h
            if HAS_ERR:
                e += tl.load(srow + E_OFF + j) * h
        if HAS_NOISE:
            nz = tl.load(noise_ptr + row * n_elem + offs, mask=mask, other=0.0)
            acc += tl.load(srow + 1 + R_HIST) * nz.to(tl.float32)
        tl.store(out_ptr + row * n_elem + offs,
                 acc.to(out_ptr.dtype.element_ty), mask=mask)
        if HAS_ERR:
            part = tl.max(tl.where(mask, tl.abs(e), 0.0), axis=0)
            tl.store(errp_ptr + row * n_blocks + blk, part)

    _kernel = fused_ab_kernel
    return _kernel


def _scalars(psi, coeffs, s, noise, err_coeffs) -> torch.Tensor:
    """The (R, ncols) float32 operand [psi, C_0..C_{r-1}, s?, E_*?]."""
    cols = [psi.to(torch.float32)[:, None], coeffs.to(torch.float32)]
    if noise is not None:
        cols.append(s.to(torch.float32)[:, None])
    if err_coeffs is not None:
        cols.append(err_coeffs.to(torch.float32))
    return torch.cat(cols, dim=1).contiguous()


def _check(x, hist, psi, coeffs, s, noise, err_coeffs) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_ab_step kernel takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if x.ndim != 3 or hist.ndim != 4 or tuple(hist.shape[1:]) != tuple(x.shape):
        raise ValueError(f"need x (R, M, D) and hist (r, R, M, D), got "
                         f"{tuple(x.shape)} and {tuple(hist.shape)}")
    r, n_rows = hist.shape[0], x.shape[0]
    if not 1 <= r <= 4:
        raise ValueError(f"history length must be 1..4, got {r}")
    if hist.dtype != x.dtype or (noise is not None and noise.dtype != x.dtype):
        raise TypeError("hist and noise must have x's dtype")
    if tuple(psi.shape) != (n_rows,) or tuple(coeffs.shape) != (n_rows, r):
        raise ValueError(f"need psi ({n_rows},) and coeffs ({n_rows}, {r}), "
                         f"got {tuple(psi.shape)} and {tuple(coeffs.shape)}")
    if (s is None) != (noise is None):
        raise ValueError("s and noise come together")
    if noise is not None and (tuple(noise.shape) != tuple(x.shape)
                              or tuple(s.shape) != (n_rows,)):
        raise ValueError("noise must be (R, M, D) and s (R,)")
    if err_coeffs is not None and tuple(err_coeffs.shape) != (n_rows, r):
        raise ValueError(f"err_coeffs must be ({n_rows}, {r})")
    for name, t in (("x", x), ("hist", hist), ("noise", noise)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_ab_step(x, hist, psi, coeffs, *, s=None, noise=None, err_coeffs=None):
    """One-pass stacked AB step.

    x: (R, M, D); hist: (r, R, M, D) with 1 <= r <= 4; psi: (R,);
    coeffs: (R, r). Optional stochastic leaf: s (R,) scales noise (R, M, D)
    (drawn by the caller). Optional error pair: err_coeffs (R, r) yields
    err (R,) float32, the per-row Linf of the embedded lower-order
    difference. Returns ``(x_new, err-or-None)``.

    CUDA operands launch the Triton kernel (``fused_ab_step.launches``
    counts the launches); CPU operands take
    :func:`repro_torch.kernels.ref.fused_ab_step_ref`.
    """
    if not use_kernel(x, hist, psi, coeffs, s, noise, err_coeffs):
        return ref.fused_ab_step_ref(x, hist, psi, coeffs, s=s, noise=noise,
                                     err_coeffs=err_coeffs)
    _check(x, hist, psi, coeffs, s, noise, err_coeffs)
    kernel = _build()
    n_rows, m, d = x.shape
    n_elem = m * d
    n_blocks = (n_elem + BLOCK - 1) // BLOCK
    scal = _scalars(psi, coeffs, s, noise, err_coeffs)
    out = torch.empty_like(x)
    has_err = err_coeffs is not None
    errp = (torch.empty((n_rows, n_blocks), device=x.device, dtype=torch.float32)
            if has_err else out)
    kernel[(n_blocks, n_rows)](
        scal, x, hist, noise if noise is not None else x, out, errp,
        n_rows, n_elem, n_blocks, scal.shape[1],
        R_HIST=hist.shape[0], HAS_NOISE=noise is not None, HAS_ERR=has_err,
        E_OFF=1 + hist.shape[0] + (noise is not None), BLK=BLOCK,
        num_warps=NUM_WARPS, enable_fp_fusion=False)
    fused_ab_step.launches += 1
    return out, (errp.amax(dim=1) if has_err else None)


fused_ab_step.launches = 0


def deis_step(x, eps_hist, psi, coeffs):
    """x: (M, D); eps_hist: (r, M, D); psi scalar tensor; coeffs: (r,).

    Single-request deterministic form: one row of :func:`fused_ab_step`."""
    out, _ = fused_ab_step(x[None].contiguous(), eps_hist[:, None].contiguous(),
                           psi.reshape(1), coeffs[None])
    return out[0]
