"""The 3xTF32 split that the float32 kernels of K2 and K3 (route ``tf32x3``)
take their products in, modelled on the CPU and held to the float32 checks.

TF32 keeps 10 bits of a float32's significand. The kernels round a value
to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties away from zero (the
bit pattern plus 2^12, then the low 13 bits cleared). Each float32 factor
is split as hi = tf32(x), lo = tf32(x - hi), and a product a b is taken as
a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, about 2^-22 of a b, dropped):
each product of two TF32 values is exact in float32, and the sums are
float32. Here attention and the SSD scan run with every product of the
kernels (S = Q K^T and P V; C B^T, W x, C h^T and (x o e)^T B) through
that model, in the plain versions' arithmetic otherwise, and are held to
the port's plain versions and to ``repro.kernels.ref``'s JAX functions at
the card checks' tolerances: K2 2e-5; K3 2e-4 with an absolute term of
1e-5 x max|want| at mamba2's widths (sums of 256 x 128 terms on outputs of
order hundreds). The shapes are the JAX kernel tests' and one full-width
head group of gemma-2b (D 256, MQA 8/1) and of mamba2-2.7b (P 64, N 128,
chunk 256). One TF32 product alone misses the same checks (the last
tests), which is why the kernels take three."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as R
from repro_torch.kernels import ref as P

ATTN_TOL = 2e-5
SSD_TOL = 2e-4
SSD_ATOL_SCALE = 1e-5   # mamba2's widths: atol = this x max|want|
ATTN_CASES = [
    (2, 64, 4, 4, 32, True, 0),         # the JAX kernel tests' five
    (1, 128, 8, 2, 64, True, 0),
    (2, 96, 4, 1, 32, True, 0),
    (1, 64, 4, 4, 32, False, 0),
    (1, 128, 4, 2, 32, True, 32),
    (1, 256, 8, 1, 256, False, 0),      # one head group of gemma-2b at full width
]
SSD_CASES = [
    (2, 64, 2, 16, 8, 16),              # the JAX kernel tests' four
    (1, 96, 3, 8, 16, 32),
    (1, 50, 2, 16, 8, 16),
    (2, 32, 1, 32, 32, 32),
    (1, 256, 2, 64, 128, 256),          # one head pair of mamba2-2.7b at full width
]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32 as ``cvt.rna.tf32.f32``: nearest, ties
    away from zero (on the bit pattern; the sign bit is untouched)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """a @ b as the kernels take it: three TF32 products (or one), float32
    sums."""
    if terms == 1:
        return tf32(a) @ tf32(b)
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def attention(q, k, v, *, causal, window, terms=3):
    """``ref.flash_attention_ref``'s arithmetic with Q K^T and P V in the
    model. q (B, Sq, H, D), k and v (B, Sk, KV, D), float32."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    head = torch.arange(h) // (h // kv)
    qh = q.permute(0, 2, 1, 3)                                  # (B, H, Sq, D)
    kh = k.index_select(2, head).permute(0, 2, 1, 3)
    vh = v.index_select(2, head).permute(0, 2, 1, 3)
    s = mm(qh, kh.transpose(-1, -2), terms) * (1.0 / math.sqrt(d))
    qp = (sk - sq) + torch.arange(sq)[:, None]
    kp = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    s = s.masked_fill(~mask, P.NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1).clamp_min(1e-30)
    return (mm(p, vh, terms) / l[..., None]).permute(0, 2, 1, 3)


def ssd_scan(x, a, B, C, *, chunk, terms=3):
    """``ref.ssd_scan_ref``'s arithmetic, chunk by chunk, with the kernel's
    four products in the model: the scores C B^T, W x, C h^T and the state's
    (x o exp(cum_L - cum))^T B."""
    bb, s, h, p = x.shape
    L = min(chunk, s)
    pad = (-s) % L
    xf = F.pad(x, (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)    # (Bb, H, S, P)
    af = F.pad(a, (0, 0, 0, pad), value=1.0).permute(0, 2, 1)  # (Bb, H, S)
    Bf, Cf = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))
    state = torch.zeros((bb, h, p, B.shape[-1]))
    ys = []
    for c0 in range(0, s + pad, L):
        xc, Bc, Cc = xf[:, :, c0:c0 + L], Bf[:, c0:c0 + L], Cf[:, c0:c0 + L]
        cum = torch.cumsum(torch.log(af[:, :, c0:c0 + L].clamp_min(1e-37)), dim=-1)
        decay = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
        w = mm(Cc, Bc.transpose(1, 2), terms)[:, None] * decay          # (Bb, H, t, u)
        y = mm(w, xc, terms)
        y = y + mm(Cc[:, None], state.transpose(-1, -2), terms) * torch.exp(cum)[..., None]
        xd = xc * torch.exp(cum[..., -1:] - cum)[..., None]
        state = state * torch.exp(cum[..., -1])[..., None, None] \
            + mm(xd.transpose(-1, -2), Bc[:, None], terms)
        ys.append(y)
    return torch.cat(ys, dim=2)[:, :, :s].permute(0, 2, 1, 3), state


def _attn_inputs(b, sq, h, kv, d, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype(np.float32)
                 for shape in ((b, sq, h, d), (b, sq, kv, d), (b, sq, kv, d)))


def _ssd_inputs(b, s, h, p, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    a = rng.uniform(0.7, 0.999, (b, s, h)).astype(np.float32)
    return x, a, rng.randn(b, s, n).astype(np.float32), rng.randn(b, s, n).astype(np.float32)


def _ssd_tol(want, p, n):
    scale = SSD_ATOL_SCALE if (p, n) == (64, 128) else 0.0
    return dict(rtol=SSD_TOL, atol=max(SSD_TOL, scale * float(np.abs(want).max())))


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -11        # exactly half a TF32 ulp above 1: a tie
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0, 0.0, -2.5e-3])
    got = tf32(x)
    assert got.tolist()[:5] == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0, 0.0]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    g = torch.Generator().manual_seed(0)
    r = torch.randn(10000, generator=g) * 10.0 ** torch.randint(-6, 6, (10000,), generator=g)
    hi, lo = split(r)
    assert ((r - tf32(r)).abs() <= 2.0 ** -11 * r.abs()).all()
    # hi + lo holds about 21 bits of the significand; what is left over is
    # below 2^-21 of x
    assert ((r - (hi.double() + lo.double())).abs() <= 2.0 ** -21 * r.double().abs()).all()


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", ATTN_CASES)
def test_attention_3xtf32_meets_float32_check(b, s, h, kv, d, causal, window):
    q, k, v = _attn_inputs(b, s, h, kv, d)
    got = attention(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window)
    plain = P.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                  window=window)
    jax_ref = R.flash_attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal, window=window)
    torch.testing.assert_close(got, plain, rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ref), rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_scan_3xtf32_meets_float32_check(b, s, h, p, n, chunk):
    x, a, B, C = _ssd_inputs(b, s, h, p, n)
    got_y, got_st = ssd_scan(*map(torch.from_numpy, (x, a, B, C)), chunk=chunk)
    plain_y, plain_st = P.ssd_scan_ref(*map(torch.from_numpy, (x, a, B, C)), chunk=chunk)
    jax_y, jax_st = R.ssd_scan_ref(*map(jnp.asarray, (x, a, B, C)))
    for got, want in ((got_y, plain_y), (got_st, plain_st)):
        torch.testing.assert_close(got, want, **_ssd_tol(want.numpy(), p, n))
    for got, want in ((got_y, jax_y), (got_st, jax_st)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, **_ssd_tol(want, p, n))


def test_one_tf32_product_misses_the_attention_check():
    """Gemma-2b's head group with S = Q K^T and P V each one TF32 product:
    outside 2e-5 of the plain version, while three products are inside."""
    q, k, v = map(torch.from_numpy, _attn_inputs(1, 256, 8, 1, 256))
    plain = P.flash_attention_ref(q, k, v, causal=False)
    one = attention(q, k, v, causal=False, window=0, terms=1)
    three = attention(q, k, v, causal=False, window=0, terms=3)
    assert not torch.allclose(one, plain, rtol=ATTN_TOL, atol=ATTN_TOL)
    assert (one - plain).abs().max() > 10 * (three - plain).abs().max()


def test_one_tf32_product_misses_the_ssd_check():
    """Mamba2-2.7b's head pair with the scan's four products each one TF32
    product: outside the float32 check, while three products are inside."""
    x, a, B, C = map(torch.from_numpy, _ssd_inputs(1, 256, 2, 64, 128))
    plain_y, _ = P.ssd_scan_ref(x, a, B, C, chunk=256)
    one_y, _ = ssd_scan(x, a, B, C, chunk=256, terms=1)
    three_y, _ = ssd_scan(x, a, B, C, chunk=256, terms=3)
    tol = _ssd_tol(plain_y.numpy(), 64, 128)
    assert not torch.allclose(one_y, plain_y, **tol)
    torch.testing.assert_close(three_y, plain_y, **tol)
    assert (one_y - plain_y).abs().max() > 10 * (three_y - plain_y).abs().max()
