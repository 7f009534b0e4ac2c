"""The Mamba2 mixer's pointwise work around K3, as two hand-written CUDA C++
kernels for Hopper (``csrc/ssm_pointwise.cu``), and their plain versions.

Replaces no TPU kernel: the reference (``repro.models.ssm.ssm_forward``)
leaves this work to XLA, which fuses it. Added because in eager PyTorch it
ran as some thirty kernels a layer, each reading and writing a whole
(Bb, S, ~d_inner) tensor: two thirds of mamba2-2.7b's device time on the
one-shot path. Each pass here reads its inputs once and writes its outputs
once.

* :func:`conv_prep` (the mixer's ``pre``): from the xBC and dt columns of
  the in-projection, read in place, the decay ``a = exp(softplus(dt +
  dt_bias) * -exp(A_log))`` (float32) and the depthwise causal convolution
  with its bias and SiLU, split into K3's operands xh (Bb, S, H, P), B and
  C (Bb, S, N), each contiguous in x's dtype. The kernel sums the taps in
  float32 and rounds once; the plain version rounds each product and sum
  to the working dtype, as the mixer always has.
* :func:`gated_norm` (the mixer's ``post``): ``v = y + D[h] xh``, then
  ``v rsqrt(mean(v^2) + eps) (1 + norm_scale) silu(z)`` in float32, stored
  in x's dtype; or, with ``gate_first`` (the published Mamba-2 layer's
  order, granite-4.0-h-small's), ``g = v silu(z)``, then ``g rsqrt(mean(g^2)
  + eps) (1 + norm_scale)``.

What bounds them on the card: bytes. At mamba2-2.7b's one-shot shape (Bb
16, S 256, d_inner 5120, N 128, H 80, bf16) ``pre`` moves 90.05 MB (26.9 us
at 3.35 TB/s) and ``post`` 167.77 MB (50.1 us). The kernels' design is in
the source's note; their times are in PERF.md.

A CUDA tensor launches the kernel (``conv_prep.launches`` and
``gated_norm.launches`` count them) or the call raises; a CPU tensor takes
the plain version (:func:`conv_prep_ref`, :func:`gated_norm_ref`). The
mixer's plain route (``use_kernels=False``), its decode update and its mesh
route call the plain pieces (:func:`decay`, :func:`causal_conv`,
:func:`gated_norm_ref`) on any device.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .runtime import use_kernel

MAX_CONV_WIDTH = 4
# the widest row (d_inner) the norm takes: with 16-byte accesses, and without
MAX_NORM_WIDTH, MAX_NORM_WIDTH_UNALIGNED = 16384, 8192
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# ssm_conv_prep(xbc, xbc_sb, xbc_ss, dt, dt_sb, dt_ss, w, bias, dt_bias, A_log,
#               xh, B, C, a, Bb, S, d_inner, N, H, K, dtype, vec, stream)
CONV_ARGTYPES = [_P, _L, _L, _P, _L, _L] + [_P] * 8 + [_I] * 8 + [_P]
# ssm_gated_norm(y, xh, z, z_sb, z_ss, D, scale, out, Bb, S, d_inner, P, eps,
#                dtype, vec, gate_first, stream)
NORM_ARGTYPES = [_P, _P, _P, _L, _L, _P, _P, _P] + [_I] * 4 + [ctypes.c_float] + \
    [_I] * 3 + [_P]


def decay(dt, dt_bias, A_log):
    """The per-step decay a (Bb, S, H) in float32 from dt (Bb, S, H)."""
    dt = F.softplus(dt.to(torch.float32) + dt_bias)
    return torch.exp(dt * -torch.exp(A_log))                # decay in (0, 1)


def causal_conv(xbc, w, b, state=None):
    """Depthwise causal convolution of width K. xbc: (B, S, C); w: (K, C);
    state: the K - 1 inputs before this sequence (B, K - 1, C), or None for
    a zero history. Returns ``(silu(conv) in xbc's dtype, new_state)``,
    where ``new_state`` holds the last K - 1 inputs (None when K is 1)."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(xbc, (0, 0, k - 1, 0))                  # (B, S + K - 1, C)
    else:
        xp = torch.cat([state, xbc], dim=1)
    s = xbc.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    out = out + b
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return F.silu(out.to(torch.float32)).to(xbc.dtype), new_state


def conv_tail(xbc, k):
    """The last K - 1 inputs of xbc (B, S, C), zeros in front where S is
    shorter (what :func:`causal_conv` returns as its state from a zero
    history); None when K is 1."""
    if k == 1:
        return None
    s = xbc.shape[1]
    return xbc[:, s - (k - 1):] if s >= k - 1 else F.pad(xbc, (0, 0, k - 1 - s, 0))


def conv_prep_ref(xbc, dt, conv_w, conv_b, dt_bias, A_log, *, head_dim):
    """The plain version of :func:`conv_prep`: ``(xh, B, C, a)``."""
    bsz, s, h = dt.shape
    d_inner = h * head_dim
    n = (xbc.shape[-1] - d_inner) // 2
    a = decay(dt, dt_bias, A_log)
    xbc, _ = causal_conv(xbc, conv_w, conv_b)
    xs, B, C = torch.split(xbc, [d_inner, n, n], dim=-1)
    xh = xs.reshape(bsz, s, h, head_dim)
    return xh.contiguous(), B.contiguous(), C.contiguous(), a.contiguous()


def gated_norm_ref(y, xh, z, D, norm_scale, eps, gate_first=False):
    """The plain version of :func:`gated_norm`: the D skip and the gated
    RMS norm in float32, returned in z's dtype, (Bb, S, d_inner): the norm
    then the gate (mamba2 here), or with ``gate_first`` the gate then the
    norm."""
    f32 = torch.float32
    bsz, s = xh.shape[:2]
    y = y + D[None, None, :, None] * xh.to(f32)
    y = y.reshape(bsz, s, -1)
    if gate_first:
        y = y * F.silu(z.to(f32))
    y = y * torch.rsqrt(y.square().mean(dim=-1, keepdim=True) + eps)
    y = y * (1.0 + norm_scale.to(f32))
    if not gate_first:
        y = y * F.silu(z.to(f32))
    return y.to(z.dtype)


def _vec(t: torch.Tensor, *strides) -> bool:
    """Whether 16-byte accesses reach t: its base 16-byte aligned and each
    of ``strides`` (in elements) a multiple of the elements in 16 bytes."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(st % per == 0 for st in strides)


def _check_dtypes(name, *ts):
    dt = ts[0].dtype
    if dt not in _DTYPE_CODES or any(t.dtype != dt for t in ts):
        raise TypeError(f"{name} takes float32 or bfloat16 operands of one dtype, got "
                        f"{[t.dtype for t in ts]}")


def _check_conv_prep(xbc, dt, conv_w, conv_b, dt_bias, A_log, head_dim, layout=True) -> None:
    """Raise on operands the kernel does not take (``layout``: their strides
    too, which the plain version does not mind)."""
    _check_dtypes("conv_prep", xbc, dt, conv_w, conv_b)
    if dt_bias.dtype != torch.float32 or A_log.dtype != torch.float32:
        raise TypeError(f"dt_bias and A_log must be float32, got {dt_bias.dtype}, "
                        f"{A_log.dtype}")
    if xbc.ndim != 3 or dt.ndim != 3 or tuple(dt.shape[:2]) != tuple(xbc.shape[:2]):
        raise ValueError(f"need xbc (Bb, S, C) and dt (Bb, S, H), got {tuple(xbc.shape)} "
                         f"and {tuple(dt.shape)}")
    bsz, s, c = xbc.shape
    h = dt.shape[2]
    d_inner = h * head_dim
    if min(bsz, s, h, head_dim) < 1 or c <= d_inner or (c - d_inner) % 2:
        raise ValueError(f"xbc's {c} channels are not d_inner {h} x {head_dim} plus two "
                         f"state widths")
    k = conv_w.shape[0]
    if conv_w.ndim != 2 or tuple(conv_w.shape) != (k, c) or not 1 <= k <= MAX_CONV_WIDTH:
        raise ValueError(f"need conv_w (K, {c}) with K in 1..{MAX_CONV_WIDTH}, got "
                         f"{tuple(conv_w.shape)}")
    if tuple(conv_b.shape) != (c,) or tuple(dt_bias.shape) != (h,) \
            or tuple(A_log.shape) != (h,):
        raise ValueError(f"need conv_b ({c},), dt_bias and A_log ({h},), got "
                         f"{tuple(conv_b.shape)}, {tuple(dt_bias.shape)}, "
                         f"{tuple(A_log.shape)}")
    if bsz > 65535:
        raise ValueError(f"the kernel takes at most 65535 batch rows, got {bsz}")
    if not layout:
        return
    if xbc.stride(2) != 1 or dt.stride(2) != 1:
        raise ValueError("xbc and dt must have unit channel stride")
    for name, t in (("conv_w", conv_w), ("conv_b", conv_b), ("dt_bias", dt_bias),
                    ("A_log", A_log)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_gated_norm(y, xh, z, D, norm_scale, layout=True) -> None:
    """As :func:`_check_conv_prep`, for :func:`gated_norm`."""
    _check_dtypes("gated_norm", y, xh, z, norm_scale)
    if D.dtype != torch.float32:
        raise TypeError(f"D must be float32, got {D.dtype}")
    if xh.ndim != 4 or tuple(y.shape) != tuple(xh.shape):
        raise ValueError(f"need y and xh (Bb, S, H, P), got {tuple(y.shape)} and "
                         f"{tuple(xh.shape)}")
    bsz, s, h, p = xh.shape
    d_inner = h * p
    if min(bsz, s, h, p) < 1 or tuple(z.shape) != (bsz, s, d_inner) \
            or tuple(D.shape) != (h,) or tuple(norm_scale.shape) != (d_inner,):
        raise ValueError(f"need z ({bsz}, {s}, {d_inner}), D ({h},) and norm_scale "
                         f"({d_inner},), got {tuple(z.shape)}, {tuple(D.shape)}, "
                         f"{tuple(norm_scale.shape)}")
    if d_inner > MAX_NORM_WIDTH:
        raise ValueError(f"the kernel takes d_inner up to {MAX_NORM_WIDTH}, got {d_inner}")
    if not layout:
        return
    if z.stride(2) != 1:
        raise ValueError("z must have unit channel stride")
    for name, t in (("y", y), ("xh", xh), ("D", D), ("norm_scale", norm_scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def conv_prep(xbc, dt, conv_w, conv_b, dt_bias, A_log, *, head_dim):
    """xbc: (Bb, S, d_inner + 2N) and dt: (Bb, S, H), unit channel stride
    (views of the in-projection's output); conv_w (K, C), conv_b (C,) in
    their dtype; dt_bias, A_log (H,) float32. Returns K3's operands ``(xh
    (Bb, S, H, head_dim), B (Bb, S, N), C (Bb, S, N), a (Bb, S, H)
    float32)``, each contiguous."""
    kernel = use_kernel(xbc, dt, conv_w, conv_b, dt_bias, A_log)
    _check_conv_prep(xbc, dt, conv_w, conv_b, dt_bias, A_log, head_dim, layout=kernel)
    if not kernel:
        return conv_prep_ref(xbc, dt, conv_w, conv_b, dt_bias, A_log, head_dim=head_dim)
    bsz, s, c = xbc.shape
    h = dt.shape[2]
    d_inner = h * head_dim
    n = (c - d_inner) // 2
    # the kernel reads 4 channels at a time (8 bytes of bf16, 16 of float32)
    # where 16-byte accesses would be aligned, else one
    per = 16 // xbc.element_size()
    vec = d_inner % per == 0 and n % per == 0 and _vec(xbc, xbc.stride(0), xbc.stride(1)) \
        and _vec(conv_w) and _vec(conv_b)
    xh = torch.empty((bsz, s, h, head_dim), dtype=xbc.dtype, device=xbc.device)
    B = torch.empty((bsz, s, n), dtype=xbc.dtype, device=xbc.device)
    C = torch.empty_like(B)
    a = torch.empty((bsz, s, h), dtype=torch.float32, device=xbc.device)
    with torch.cuda.device(xbc.device):
        fn = build.entry("ssm_pointwise", "ssm_conv_prep", CONV_ARGTYPES)
        err = fn(xbc.data_ptr(), xbc.stride(0), xbc.stride(1), dt.data_ptr(), dt.stride(0),
                 dt.stride(1), conv_w.data_ptr(), conv_b.data_ptr(), dt_bias.data_ptr(),
                 A_log.data_ptr(), xh.data_ptr(), B.data_ptr(), C.data_ptr(), a.data_ptr(),
                 bsz, s, d_inner, n, h, conv_w.shape[0], _DTYPE_CODES[xbc.dtype],
                 1 if vec else 0, _stream())
    if err != 0:
        raise RuntimeError(f"ssm_conv_prep kernel launch failed: CUDA error {err}")
    conv_prep.launches += 1
    return xh, B, C, a


def gated_norm(y, xh, z, D, norm_scale, *, eps, gate_first=False):
    """y, xh: (Bb, S, H, P) contiguous (K3's output and its x); z: (Bb, S,
    H * P), unit channel stride (a view of the in-projection's output); D
    (H,) float32; norm_scale (H * P,); ``gate_first``: the gate before the
    norm (the kernel's other instantiation). Returns (Bb, S, H * P) in z's
    dtype."""
    kernel = use_kernel(y, xh, z, D, norm_scale)
    _check_gated_norm(y, xh, z, D, norm_scale, layout=kernel)
    if not kernel:
        return gated_norm_ref(y, xh, z, D, norm_scale, eps, gate_first)
    bsz, s, h, p = xh.shape
    d_inner = h * p
    per = 16 // xh.element_size()
    vec = d_inner % per == 0 and p % per == 0 and _vec(y) and _vec(xh) and _vec(norm_scale) \
        and _vec(z, z.stride(0), z.stride(1))
    if not vec and d_inner > MAX_NORM_WIDTH_UNALIGNED:
        raise ValueError(f"the kernel takes d_inner up to {MAX_NORM_WIDTH_UNALIGNED} on operands "
                         f"it cannot read 16 bytes at a time, got {d_inner}")
    out = torch.empty((bsz, s, d_inner), dtype=z.dtype, device=z.device)
    with torch.cuda.device(z.device):
        fn = build.entry("ssm_pointwise", "ssm_gated_norm", NORM_ARGTYPES)
        err = fn(y.data_ptr(), xh.data_ptr(), z.data_ptr(), z.stride(0), z.stride(1),
                 D.data_ptr(), norm_scale.data_ptr(), out.data_ptr(), bsz, s, d_inner, p,
                 eps, _DTYPE_CODES[z.dtype], 1 if vec else 0, 1 if gate_first else 0,
                 _stream())
    if err != 0:
        raise RuntimeError(f"ssm_gated_norm kernel launch failed: CUDA error {err}")
    gated_norm.launches += 1
    return out


conv_prep.launches = 0
gated_norm.launches = 0
