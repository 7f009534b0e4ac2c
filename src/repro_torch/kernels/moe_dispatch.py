"""The MoE layer's kernel route around the experts' products, as four
hand-written CUDA C++ kernels for Hopper (``csrc/moe_dispatch.cu``), and
their plain versions.

Replaces no TPU kernel: the reference (``repro.models.layers.moe``) leaves
the MoE's routing, dispatch and combine to XLA. Added because in eager
PyTorch the GShard one-hot dispatch built float32 (B, S, k, E, C)
products, multiplied by one-hot tensors to move rows and copied the
experts' slots between (B, E, C, d) and (E, B C, d): three quarters of
granite-4.0-h-small's device time on the one-shot path. Here the slots are
an expert-major table laid out (E, B C): slot ``e B C + b C + place``
holds the row ``b S + s`` of the token that took it, or -1.

* :func:`route`: from the float32 router logits (B, S, E), the top k on
  the logits (the larger logit first, then the lower expert), the chosen
  softmax gates renormalised to sum 1, each pair's place in its expert's
  queue (the earlier tokens of the row that chose that expert), the pair
  -> slot map (-1 for a dropped pair), the slot table, and what the two
  aux losses need: each row's per-expert gate sums and kept counts, each
  token's logsumexp.
* :func:`gather`: the experts' rows (E, B C, d) from x (B, S, d) through
  the table, zero rows in empty slots.
* :func:`glu`: ``silu(g) h`` in float32 from the experts' up and gate
  products, stored in their dtype.
* :func:`combine`: ``out[b, s] = sum_k w[b, s, k] out_e[slot[b, s, k]]``
  over the kept pairs, the gates and the sum in float32, plus an optional
  addend (the shared expert's output), one rounding to out_e's dtype.

What bounds them on the card: bytes (the route: its k E comparisons a
token, in one block a row). At
granite-4.0-h-small's one-shot shape (B 16, S 256, E 72, k 10, C 44, d
4096, f 768, bf16) the gather writes 415.24 MB, the GLU moves 233.57 MB,
the combine reads about 335 MB of kept rows; their times are in PERF.md.

A CUDA tensor launches the kernel (``route.launches``, ``gather.launches``,
``glu.launches`` and ``combine.launches`` count them) or the call raises; a
CPU tensor takes the plain version (:func:`route_ref`, :func:`gather_ref`,
:func:`glu_ref`, :func:`combine_ref`). None has a backward.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .runtime import use_kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the dynamic shared memory a route block may take; its threads, and the
# floats of a row of its logits tile
_MAX_SMEM, _ROUTE_THREADS, _TILE_STRIDE = 232448, 1024, 132
# moe_route(logits, B, S, E, K, C, gate_idx, gate_vals, pos, slot, table,
#           gate_sum, kept, lse, stream)
ROUTE_ARGTYPES = [_P] + [_I] * 5 + [_P] * 9
# moe_gather(x, table, xin, n_slots, row_bytes, vec, stream)
GATHER_ARGTYPES = [_P, _P, _P, _L, _L, _I, _P]
# moe_glu(h, g, out, n, dtype, vec, stream)
GLU_ARGTYPES = [_P, _P, _P, _L, _I, _I, _P]
# moe_combine(out_e, slot, w, add, out, rows, d, K, dtype, vec, stream)
COMBINE_ARGTYPES = [_P] * 5 + [_L, _I, _I, _I, _I, _P]


def route_ref(logits, *, top_k: int, cap: int) -> dict:
    """The plain version of :func:`route`."""
    b, s, e = logits.shape
    gates = torch.softmax(logits, dim=-1)
    gate_idx = torch.topk(logits, top_k, dim=-1).indices
    gate_vals = gates.gather(-1, gate_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    chose = F.one_hot(gate_idx, e).sum(2)                       # (B, S, E) 0 or 1
    pos = (chose.cumsum(1) - chose).gather(-1, gate_idx)        # earlier tokens of the row
    kept = pos < cap
    rows = torch.arange(b * s, device=logits.device).reshape(b, s, 1).expand(b, s, top_k)
    at = gate_idx * (b * cap) + torch.arange(b, device=logits.device)[:, None, None] * cap + pos
    slot = torch.where(kept, at, -1)
    table = torch.full((e * b * cap,), -1, dtype=torch.long, device=logits.device)
    table[slot[kept]] = rows[kept]
    i32 = torch.int32
    return dict(gate_idx=gate_idx, gate_vals=gate_vals, pos=pos.to(i32), slot=slot.to(i32),
                table=table.reshape(e, b * cap).to(i32), gate_sum=gates.sum(1),
                kept=chose.sum(1).clamp(max=cap).to(i32), lse=torch.logsumexp(logits, -1))


def gather_ref(x, table):
    """The plain version of :func:`gather`."""
    rows = x.reshape(-1, x.shape[-1])[table.clamp(min=0).long()]
    return torch.where((table >= 0)[..., None], rows, torch.zeros((), dtype=x.dtype))


def glu_ref(h, g):
    """The plain version of :func:`glu` (the plain route's formula)."""
    return (F.silu(g.to(torch.float32)) * h.to(torch.float32)).to(h.dtype)


def combine_ref(out_e, slot, gate_vals, add=None):
    """The plain version of :func:`combine`."""
    got = out_e.reshape(-1, out_e.shape[-1])[slot.clamp(min=0).long()].to(torch.float32)
    w = torch.where(slot >= 0, gate_vals, 0.0)
    out = (w[..., None] * got).sum(2)
    if add is not None:
        out = out + add.to(torch.float32)
    return out.to(out_e.dtype)


def _vec(*ts) -> bool:
    """Whether every tensor's base is 16-byte aligned."""
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _check_dtype(name, *ts):
    dt = ts[0].dtype
    if dt not in _DTYPE_CODES or any(t.dtype != dt for t in ts):
        raise TypeError(f"{name} takes float32 or bfloat16 operands of one dtype, got "
                        f"{[t.dtype for t in ts]}")


def _contiguous(name, **ts):
    for k, t in ts.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


def _check_route(logits, top_k, cap):
    if logits.dtype != torch.float32 or logits.ndim != 3:
        raise TypeError(f"route takes float32 logits (B, S, E), got {logits.dtype} "
                        f"{tuple(logits.shape)}")
    b, s, e = logits.shape
    if min(b, s, e) < 1 or e >= 2 ** 15 or not 1 <= top_k <= e or not 1 <= cap <= s:
        raise ValueError(f"need E < 2^15, 1 <= top_k <= E and 1 <= cap <= S, got top_k "
                         f"{top_k}, cap {cap} at (B, S, E) {(b, s, e)}")
    if b * s * top_k >= 2 ** 31 or e * b * cap >= 2 ** 31:
        raise ValueError("the pairs and the slots are indexed in 32 bits")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _raise(name, err):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def route(logits, *, top_k: int, cap: int) -> dict:
    """logits (B, S, E) float32 (the router's product); ``cap`` the
    experts' capacity C per row. Returns a dict of ``gate_idx`` (B, S, k)
    int64 and ``gate_vals`` (B, S, k) float32, ``pos`` and ``slot`` (B, S,
    k) int32, ``table`` (E, B C) int32, ``gate_sum`` (B, E) float32 (each
    row's sum of every token's softmax gate), ``kept`` (B, E) int32 (each
    row's pairs kept by each expert) and ``lse`` (B, S) float32."""
    kernel = use_kernel(logits)
    _check_route(logits, top_k, cap)
    if not kernel:
        return route_ref(logits, top_k=top_k, cap=cap)
    logits = logits.contiguous()
    b, s, e = logits.shape
    w = (s + 31) // 32
    groups = 1 if e >= _ROUTE_THREADS else _ROUTE_THREADS // e
    if 4 * e * (_TILE_STRIDE + 2 * w + 1 + groups) + 4 * -(-2 * s * top_k // 4) > _MAX_SMEM:
        raise ValueError(f"route: E {e} at S {s} needs more shared memory than a block has")
    new = lambda shape, dt: torch.empty(shape, dtype=dt, device=logits.device)
    i32, f32 = torch.int32, torch.float32
    r = dict(gate_idx=new((b, s, top_k), torch.long), gate_vals=new((b, s, top_k), f32),
             pos=new((b, s, top_k), i32), slot=new((b, s, top_k), i32),
             table=new((e, b * cap), i32), gate_sum=new((b, e), f32), kept=new((b, e), i32),
             lse=new((b, s), f32))
    with torch.cuda.device(logits.device):
        fn = build.entry("moe_dispatch", "moe_route", ROUTE_ARGTYPES)
        _raise("moe_route", fn(logits.data_ptr(), b, s, e, top_k, cap,
                               *(r[k].data_ptr() for k in ("gate_idx", "gate_vals", "pos",
                                                            "slot", "table", "gate_sum",
                                                            "kept", "lse")), _stream()))
    route.launches += 1
    return r


def gather(x, table):
    """x (B, S, d) contiguous; table (E, B C) int32, rows of x viewed (B S,
    d) or -1. Returns xin (E, B C, d) in x's dtype."""
    kernel = use_kernel(x, table)
    _check_dtype("gather", x)
    if table.dtype != torch.int32 or table.ndim != 2:
        raise TypeError(f"gather takes an int32 table (E, B C), got {table.dtype} "
                        f"{tuple(table.shape)}")
    if not kernel:
        return gather_ref(x, table)
    _contiguous("gather", x=x, table=table)
    d = x.shape[-1]
    xin = torch.empty((*table.shape, d), dtype=x.dtype, device=x.device)
    row_bytes = d * x.element_size()
    # the widest access that the rows' length and x's base allow (xin's is 16-byte aligned)
    vec = next(v for v in (16, 4, 2) if row_bytes % v == 0 and x.data_ptr() % v == 0)
    with torch.cuda.device(x.device):
        fn = build.entry("moe_dispatch", "moe_gather", GATHER_ARGTYPES)
        _raise("moe_gather", fn(x.data_ptr(), table.data_ptr(), xin.data_ptr(), table.numel(),
                                row_bytes, vec, _stream()))
    gather.launches += 1
    return xin


def glu(h, g):
    """h, g (E, B C, f) contiguous, one dtype: the experts' up and gate
    products. Returns ``silu(g) h`` in float32, stored in their dtype."""
    kernel = use_kernel(h, g)
    _check_dtype("glu", h, g)
    if h.shape != g.shape:
        raise ValueError(f"glu: h {tuple(h.shape)} and g {tuple(g.shape)} differ")
    if not kernel:
        return glu_ref(h, g)
    _contiguous("glu", h=h, g=g)
    out = torch.empty_like(h)
    vec = h.numel() % (16 // h.element_size()) == 0 and _vec(h, g, out)
    with torch.cuda.device(h.device):
        fn = build.entry("moe_dispatch", "moe_glu", GLU_ARGTYPES)
        _raise("moe_glu", fn(h.data_ptr(), g.data_ptr(), out.data_ptr(), h.numel(),
                             _DTYPE_CODES[h.dtype], 1 if vec else 0, _stream()))
    glu.launches += 1
    return out


def combine(out_e, slot, gate_vals, add=None):
    """out_e (E, B C, d) contiguous, the experts' outputs; slot (B, S, k)
    int32 from :func:`route`; gate_vals (B, S, k) float32; ``add``: (B, S,
    d) in out_e's dtype, or None. Returns (B, S, d) in out_e's dtype."""
    kernel = use_kernel(out_e, slot, gate_vals, add)
    _check_dtype("combine", out_e, *([add] if add is not None else []))
    if slot.dtype != torch.int32 or gate_vals.dtype != torch.float32 \
            or slot.shape != gate_vals.shape or slot.ndim != 3:
        raise TypeError(f"combine takes slot (B, S, k) int32 and gate_vals float32 of its "
                        f"shape, got {slot.dtype} {tuple(slot.shape)} and {gate_vals.dtype} "
                        f"{tuple(gate_vals.shape)}")
    b, s, k = slot.shape
    d = out_e.shape[-1]
    if add is not None and tuple(add.shape) != (b, s, d):
        raise ValueError(f"combine: add must be {(b, s, d)}, got {tuple(add.shape)}")
    if not kernel:
        return combine_ref(out_e, slot, gate_vals, add)
    _contiguous("combine", out_e=out_e, slot=slot, gate_vals=gate_vals, add=add)
    out = torch.empty((b, s, d), dtype=out_e.dtype, device=out_e.device)
    vec = d % (16 // out_e.element_size()) == 0 \
        and _vec(out_e, out, *([add] if add is not None else []))
    with torch.cuda.device(out_e.device):
        fn = build.entry("moe_dispatch", "moe_combine", COMBINE_ARGTYPES)
        _raise("moe_combine", fn(out_e.data_ptr(), slot.data_ptr(), gate_vals.data_ptr(),
                                 None if add is None else add.data_ptr(), out.data_ptr(),
                                 b * s, d, k, _DTYPE_CODES[out_e.dtype], 1 if vec else 0,
                                 _stream()))
    combine.launches += 1
    return out


route.launches = 0
gather.launches = 0
glu.launches = 0
combine.launches = 0
