"""Tests of the port that need the CUDA card: each hand-written kernel
against its plain version on the card (K1 in Triton; K2, K3, the SSM
mixer's passes and the MoE's kernels in CUDA C++, built with nvcc at first
use), and the models, the engine and the training step on the card against
the CPU. They import only torch and the port, so they run where JAX is
absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card they skip. Tolerances: K1 float32 rtol = atol = 1e-6 (FMA
contraction and summation order), with the noise and the error pair on and
off, at ragged sizes, the served group's and the one-shot path's shapes
and the score net's x (1, 1024, 2); stacked rows held bitwise, and bitwise
to the plain version at the served shape (K1 is built without FMA
contraction); K2 and K3 at the JAX kernel tests' own tolerances (K2 2e-5
float32 and 2e-2 bf16, K3 2e-4 float32 and 5e-2 bf16: other summation
orders, a bf16 rounding of the output that a last-bit difference can flip;
K3 float32 at mamba2's full width and over several chunks at its widths
adds an absolute term of 1e-5 x max|want|, sums of 256 x 128 terms on
outputs of order hundreds); K2 also with a softmax scale given (granite's
1/128 at its GQA 32/8 shape). Each case checks that the route its operands
select, and only that, counted one launch: bf16 operands that TMA can
describe run K2's and K3's wgmma kernels, other bf16 (D 32, odd widths,
unaligned views) their mma.sync kernels; float32 with 16-byte aligned
bases (K3: P and N multiples of 8) their 3xTF32 tensor-core kernels, other
float32 (unaligned views, odd widths) their CUDA-core kernels. Every shape
is held on aligned operands and again on views one element past a 16-byte
line, so the mma.sync and CUDA-core kernels see every shape the others do.

The SSM mixer's two pointwise passes (CUDA C++, ``kernels/ssm_pointwise.py``)
on views of an in-projection output at mamba2's and granite's one-shot
shapes, jamba's mixer widths, the reduced config, S < K - 1, S no multiple
of the time tile, K 1 and 3, and unaligned views, in bf16 and float32:
``pre``'s xh, B and C within one rounding of the dtype of the same sums in
float64 (bf16 rtol 2^-7, atol 1e-5; float32 1e-5) and within the plain
chain's own rounding error (it rounds each of K products and K sums), its
decay a at rtol 1e-5; ``post`` within one rounding of its plain version
(the mean's summation order, rsqrtf), in both orders of gate and norm. A
one-shot sample of the reduced mamba2 launches each pass and K3 once a
layer and NFE; the reduced granite's forward on the kernel route is held
to its plain route (1e-3).

The MoE layer's four kernels (CUDA C++, ``kernels/moe_dispatch.py``) at
granite-4.0-h-small's and mixtral-8x7b's one-shot shapes and odd widths:
``moe_route``'s choices, places, slots and table bitwise against its plain
version (every token on the same experts too), its gates within float32
rounding; ``moe_gather`` bitwise; ``moe_glu`` and ``moe_combine`` within one
rounding; a tiny granite forward on the kernel route under the sync debug
mode's "error".

The card against the CPU, float32 at the reduced widths (1e-3: cuBLAS and
the 3xTF32 kernels against the CPU's summation order): the one-shot path
of every arch type (the MoE in both dispatch modes, whisper with frames,
paligemma with a prefix, grok on the plain route, cifar10-scorenet at its
published widths), each kernel's launches and every K2 and K3 launch on
tf32x3; the served path's stacked solve; AR decode of the dense, ssm,
windowed (a ring), hybrid, encdec (a cross cache) and vlm (a prefix)
archs; one train step of each arch type and of the ar objective (loss
rtol 1e-5, grads within 1e-3 of each leaf's max |grad|, the AdamW update
of the same grads rtol 1e-5, atol 1e-7; no kernel launches in training);
AdamW on CUDA tensors (rtol 1e-6, atol 1e-7); CLD's matrix tAB-DEIS and
its RK4 reference in float64 (rtol 1e-10). The MLP score net trained on
the card and sampled by a fused tab3 plan through K1 at x (1, 1024, 2)
(within 1e-5 of the unfused solve). The serving engine on the card: every
request of two staggered waves completes, K1 launches once an ``ab`` group
step, a warm replay adds no executor.

The request-axis slice's card tests: the sharded engine on a one-rank NCCL
group bitwise equal to the unsharded engine on the card, and expert-parallel
MoE there within the reference's bounds (2e-4 output, 1e-3 load-balance).
The model-parallel slice's: the sharded train step on a one-rank NCCL host
mesh bitwise equal to the unsharded step on the card. The dry runs': a
step's counts on the card equal the same step's on fake CUDA tensors. The
wgmma kernels' rings: 300 launches each of the diagnostic build with every
other ring item's copies held back, clean and every output unchanged; and
as its positive control, the rings as first written under the same delay,
which must fail."""
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import deis_step as K  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_scan as SS  # noqa: E402
from repro_torch.kernels.runtime import unaligned_copy as _unaligned  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions in full float32
    return torch.device("cuda")


# (R, M, D): ragged sizes, stacked rows, the served group's shape, and the
# one-shot path's one row of batch x seq (4 x 256) at whisper-tiny's,
# gemma-2b's and paligemma-3b's, mamba2-2.7b's and mixtral-8x7b's d_model, and
# the paper's score net at x (1, 1024, 2)
K1_SHAPES = [(1, 70, 33), (3, 70, 33), (5, 70, 33), (5, 3, 1031), (2, 128, 2048),
             (8, 256, 2048), (1, 1024, 384), (1, 1024, 2048), (1, 1024, 2560),
             (1, 1024, 4096), (1, 1024, 2)]


@pytest.mark.parametrize("noise,with_err", [(True, True), (False, False), (True, False),
                                            (False, True)])
@pytest.mark.parametrize("R,m,d", K1_SHAPES)
@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_triton_fused_ab_step_matches_plain(cuda, r, R, m, d, noise, with_err):
    g = torch.Generator(device=cuda).manual_seed(r * 100 + R)
    n = lambda *s: torch.randn(s, generator=g, device=cuda)
    x, hist, psi, C = n(R, m, d), n(r, R, m, d), torch.rand(R, device=cuda) + 0.5, n(R, r)
    kw = dict(s=torch.rand(R, device=cuda) * 0.2, noise=n(R, m, d)) if noise else {}
    if with_err:
        kw["err_coeffs"] = n(R, r) * 0.1
    before = K.fused_ab_step.launches
    out, err = K.fused_ab_step(x, hist, psi, C, **kw)
    assert K.fused_ab_step.launches == before + 1
    want, want_err = ref.fused_ab_step_ref(x, hist, psi, C, **kw)
    torch.testing.assert_close(out, want, **TOL)
    if with_err:
        torch.testing.assert_close(err, want_err, **TOL)
    for i in range(R):
        sl = slice(i, i + 1)
        o_i, e_i = K.fused_ab_step(x[sl].contiguous(), hist[:, sl].contiguous(), psi[sl],
                                   C[sl], **{k: v[sl] for k, v in kw.items()})
        assert torch.equal(o_i[0], out[i])
        if with_err:
            assert torch.equal(e_i[0], err[i])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("r", [1, 4])
def test_triton_fused_ab_step_bitwise_plain(cuda, r, seed):
    """K1 is compiled without FMA contraction, so it rounds each product and
    sum as the plain version does: bitwise equal to it in float32, with the
    noise and the error pair, whatever the draws (here from seeded
    generators at the served shape, R 8, M 256, D 2048)."""
    g = torch.Generator(device=cuda).manual_seed(1000 * r + seed)
    n = lambda *s: torch.randn(s, generator=g, device=cuda)
    u = lambda *s: torch.rand(s, generator=g, device=cuda)
    R, m, d = 8, 256, 2048
    x, hist, psi, C = n(R, m, d), n(r, R, m, d), u(R) + 0.5, n(R, r)
    kw = dict(s=u(R) * 0.2, noise=n(R, m, d), err_coeffs=n(R, r) * 0.1)
    out, err = K.fused_ab_step(x, hist, psi, C, **kw)
    want, want_err = ref.fused_ab_step_ref(x, hist, psi, C, **kw)
    assert torch.equal(out, want) and torch.equal(err, want_err)


def test_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(2, 4, 4, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        K.fused_ab_step(x, torch.zeros(1, 2, 4, 4, device=cuda, dtype=torch.float64),
                        torch.zeros(2, device=cuda), torch.zeros(2, 1, device=cuda))
    x = torch.zeros(2, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_ab_step(x, torch.zeros(1, 4, 2, 4, device=cuda).transpose(1, 2),
                        torch.zeros(2, device=cuda), torch.zeros(2, 1, device=cuda))


def _tol(dtype, f32, bf16):
    return dict(rtol=bf16, atol=bf16) if dtype == torch.bfloat16 else dict(rtol=f32, atol=f32)


def _launched_once(fn, route, before, before_routes):
    """fn launched once since ``before``, on ``route``."""
    want = dict(before_routes)
    want[route] += 1
    assert fn.launches == before + 1
    assert fn.route_launches == want


FA_CASES = [
    (2, 64, 64, 4, 4, 32, True, 0),
    (1, 128, 128, 8, 2, 64, True, 0),      # GQA
    (2, 96, 96, 4, 1, 32, True, 0),        # MQA, ragged tiles
    (1, 64, 64, 4, 4, 32, False, 0),       # bidirectional
    (1, 128, 128, 4, 2, 32, True, 32),     # sliding window
    (1, 5, 40, 2, 1, 32, True, 0),         # cross attention, Sq < Sk
    (2, 33, 47, 4, 2, 128, True, 7),       # ragged, window, D 128
    (2, 200, 200, 8, 1, 256, True, 64),    # causal with a window at D 256
    (4, 256, 256, 8, 1, 256, False, 0),    # gemma-2b's full width
    (4, 256, 256, 32, 8, 128, False, 4096),  # mixtral-8x7b's: GQA 32/8, D 128, window
    (4, 256, 256, 6, 6, 64, False, 0),     # whisper-tiny's decoder: D 64
    (4, 512, 512, 8, 1, 256, False, 0),    # paligemma-3b's prefix and text: S 512
    (4, 256, 256, 32, 2, 128, False, 0),   # glm4-9b's: GQA 32/2
    (4, 256, 256, 4, 4, 64, False, 0),     # cifar10-scorenet's
]


def _fa_route(dtype, d):
    if dtype == torch.float32:
        return "tf32x3"
    return "wgmma" if d in FA.WGMMA_HEAD_DIMS else "mma_sync"


def _fa_check(cuda, b, sq, sk, h, kv, d, causal, window, dtype, unaligned=False):
    """K2 on the route its operands select (``unaligned``: views that start
    one element past a 16-byte line, the mma_sync or cuda_cores route)
    against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(sq * 7 + sk + d)
    n = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    q, k, v = n(b, sq, h, d), n(b, sk, kv, d), n(b, sk, kv, d)
    before, routes = FA.flash_attention.launches, dict(FA.flash_attention.route_launches)
    if unaligned:
        got = FA.flash_attention(_unaligned(q), _unaligned(k), _unaligned(v), causal=causal,
                                 window=window)
        route = "cuda_cores" if dtype == torch.float32 else "mma_sync"
    else:
        got = FA.flash_attention(q, k, v, causal=causal, window=window)
        route = _fa_route(dtype, d)
    _launched_once(FA.flash_attention, route, before, routes)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, 2e-5, 2e-2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", FA_CASES)
def test_cuda_flash_attention_matches_plain(cuda, b, sq, sk, h, kv, d, causal, window, dtype):
    _fa_check(cuda, b, sq, sk, h, kv, d, causal, window, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window", FA_CASES)
def test_cuda_flash_attention_unaligned_views(cuda, b, sq, sk, h, kv, d, causal, window, dtype):
    """Views that do not start on a 16-byte line take the kernel that takes
    any operand of their dtype, over the same shapes: the CUDA-core kernel
    in float32, the mma.sync kernel in bf16, with the same results."""
    _fa_check(cuda, b, sq, sk, h, kv, d, causal, window, dtype, unaligned=True)


SS_CASES = [
    (2, 64, 2, 16, 8, 16),
    (1, 96, 3, 8, 16, 32),
    (1, 50, 2, 16, 8, 16),      # seq not a chunk multiple
    (2, 32, 1, 32, 32, 32),
    (1, 300, 4, 64, 128, 256),  # mamba2's head and state at chunk 256, padded
    (2, 100, 3, 64, 8, 64),     # N 8, below one 16-wide k-step, at P 64
    (1, 77, 2, 12, 20, 32),     # widths that are no multiple of 8 (element loads)
]


def _ss_check(cuda, b, s, h, p, n, chunk, dtype, unaligned=False, atol_scale=0.0):
    """K3 on the route its operands select (``unaligned``: views of x, B and
    C that start one element past a 16-byte line, the mma_sync or
    cuda_cores route) against the plain version (``atol_scale``: an
    absolute term of that times max|want|)."""
    g = torch.Generator(device=cuda).manual_seed(s + h + p)
    r = lambda *sh: torch.randn(sh, generator=g, device=cuda)
    x, B, C = r(b, s, h, p).to(dtype), r(b, s, n).to(dtype), r(b, s, n).to(dtype)
    a = torch.rand((b, s, h), generator=g, device=cuda) * 0.299 + 0.7
    before, routes = SS.ssd_scan.launches, dict(SS.ssd_scan.route_launches)
    f32 = dtype == torch.float32
    if unaligned:
        y, st = SS.ssd_scan(_unaligned(x), a, _unaligned(B), _unaligned(C), chunk=chunk)
        own = "cuda_cores" if f32 else "mma_sync"
    else:
        y, st = SS.ssd_scan(x, a, B, C, chunk=chunk)
        tiled = p % 8 == 0 and n % 8 == 0
        own = ("tf32x3" if tiled else "cuda_cores") if f32 else ("wgmma" if tiled else "mma_sync")
    _launched_once(SS.ssd_scan, own, before, routes)
    y_w, st_w = ref.ssd_scan_ref(x, a, B, C, chunk=chunk)
    torch.cuda.synchronize()
    for got, want in ((y.float(), y_w.float()), (st, st_w)):
        tol = _tol(dtype, 2e-4, 5e-2)
        tol["atol"] = max(tol["atol"], atol_scale * want.abs().max().item())
        torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SS_CASES)
def test_cuda_ssd_scan_matches_plain(cuda, b, s, h, p, n, chunk, dtype):
    _ss_check(cuda, b, s, h, p, n, chunk, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SS_CASES)
def test_cuda_ssd_scan_unaligned_views(cuda, b, s, h, p, n, chunk, dtype):
    """Views of x, B and C that do not start on a 16-byte line take the
    kernel that takes any operand of their dtype, over the same shapes: the
    CUDA-core kernel in float32, the mma.sync kernel in bf16, with the same
    results."""
    _ss_check(cuda, b, s, h, p, n, chunk, dtype, unaligned=True)


MAMBA2_CASES = [
    (2, 1000, 2, 64, 128, 256),  # four chunks at mamba2's widths, the last padded
    (2, 600, 4, 64, 128, 256),   # three chunks, the last padded
    (4, 256, 80, 64, 128, 256),  # mamba2-2.7b's full width, one chunk
]


@pytest.mark.parametrize("unaligned", [False, True], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", MAMBA2_CASES)
def test_cuda_ssd_scan_bf16_chunks_at_mamba2_widths(cuda, b, s, h, p, n, chunk, unaligned):
    """The state carried over several chunks, and the one-shot path's own
    shape, in bf16 at the JAX test's 5e-2: on the wgmma kernel (aligned
    operands) and on the mma.sync kernel (unaligned views)."""
    _ss_check(cuda, b, s, h, p, n, chunk, torch.bfloat16, unaligned=unaligned)


@pytest.mark.parametrize("unaligned", [False, True], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", MAMBA2_CASES)
def test_cuda_ssd_scan_float32_at_mamba2_widths(cuda, b, s, h, p, n, chunk, unaligned):
    """float32 at mamba2's widths, over several chunks and at the full
    width, on the 3xTF32 kernel (aligned operands) and on the CUDA-core
    kernel (unaligned views): within 2e-4 and 1e-5 x max|want|."""
    _ss_check(cuda, b, s, h, p, n, chunk, torch.float32, unaligned=unaligned, atol_scale=1e-5)


def test_cuda_tensor_core_kernels_take_unaligned_views(cuda):
    """bf16 operands that neither TMA nor cp.async can copy 16 bytes at a
    time (a view at an odd offset) take the mma.sync route, loaded element
    by element, with the same results."""
    g = torch.Generator(device=cuda).manual_seed(5)
    n = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = n(2, 70, 4, 64), n(2, 70, 2, 64), n(2, 70, 2, 64)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=20)
    before, routes = FA.flash_attention.launches, dict(FA.flash_attention.route_launches)
    got = FA.flash_attention(_unaligned(q), _unaligned(k), _unaligned(v), causal=True, window=20)
    _launched_once(FA.flash_attention, "mma_sync", before, routes)
    torch.testing.assert_close(got.float(), want.float(), **_tol(torch.bfloat16, 2e-5, 2e-2))
    x, B, C = n(1, 90, 3, 32), n(1, 90, 16), n(1, 90, 16)
    a = torch.rand((1, 90, 3), generator=g, device=cuda) * 0.299 + 0.7
    y_w, st_w = ref.ssd_scan_ref(x, a, B, C, chunk=64)
    before, routes = SS.ssd_scan.launches, dict(SS.ssd_scan.route_launches)
    y, st = SS.ssd_scan(_unaligned(x), a, _unaligned(B), _unaligned(C), chunk=64)
    _launched_once(SS.ssd_scan, "mma_sync", before, routes)
    tol = _tol(torch.bfloat16, 2e-4, 5e-2)
    torch.testing.assert_close(y.float(), y_w.float(), **tol)
    torch.testing.assert_close(st, st_w, **tol)


def test_cuda_kernels_reject_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(*(torch.zeros(1, 8, 1, 48, device=cuda) for _ in range(3)))
    with pytest.raises(ValueError, match="state"):
        SS.ssd_scan(torch.zeros(1, 8, 2, 16, device=cuda), torch.ones(1, 8, 2, device=cuda),
                    torch.zeros(1, 8, 256, device=cuda), torch.zeros(1, 8, 256, device=cuda))


# the SSM mixer's passes: (Bb, S, H, P, N, K, extra columns of the in-projection).
# The extra columns make the row stride no multiple of 8 elements (or 4 in
# float32): the views then take the kernels' one-element accesses.
PW_CASES = [
    (16, 256, 80, 64, 128, 4, 0),   # mamba2-2.7b's one-shot shape
    (16, 256, 80, 64, 128, 4, 1),   # the same, unaligned views
    (16, 256, 128, 64, 128, 4, 0),  # granite-4.0-h-small's one-shot shape
    (2, 48, 256, 64, 128, 4, 0),    # jamba-1.5-large's mixer widths (d_inner 16384)
    (2, 40, 32, 16, 16, 4, 0),      # the reduced config (P 16, N 16)
    (3, 2, 32, 16, 16, 4, 0),       # S < K - 1
    (2, 37, 8, 64, 128, 4, 1),      # S no multiple of the time tile (4), unaligned views
    (2, 19, 5, 16, 16, 1, 3),       # K 1, odd head count, unaligned views
    (1, 70, 6, 12, 20, 3, 0),       # widths that are no multiple of 8, K 3
]


def _pw_operands(cuda, b, s, h, p, n, k, extra, dtype):
    """The in-projection's output (Bb, S, 2 d_inner + 2N + H + extra) drawn
    on the card, its z, xBC and dt views, and the mixer's parameters."""
    g = torch.Generator(device=cuda).manual_seed(b * s + h + k)
    r = lambda *sh: torch.randn(sh, generator=g, device=cuda)
    d_inner, c = h * p, h * p + 2 * n
    zx = r(b, s, d_inner + c + h + extra).to(dtype)
    z, xbc = zx[..., :d_inner], zx[..., d_inner:d_inner + c]
    dt = zx[..., d_inner + c:d_inner + c + h]
    prm = dict(conv_w=(r(k, c) * 0.3).to(dtype), conv_b=(r(c) * 0.1).to(dtype),
               dt_bias=r(h), A_log=r(h) * 0.5)
    return z, xbc, dt, prm


def _conv_exact(xbc, w, b):
    """silu(conv) with the taps summed in float64 and rounded once to xbc's
    dtype, and sum_i |w_i x_i| + |b| (the scale of the plain chain's
    roundings)."""
    k, s = w.shape[0], xbc.shape[1]
    xp = torch.nn.functional.pad(xbc.double(), (0, 0, k - 1, 0))
    acc = sum(xp[:, i:i + s] * w[i].double() for i in range(k)) + b.double()
    mag = sum((xp[:, i:i + s] * w[i].double()).abs() for i in range(k)) + b.double().abs()
    return torch.nn.functional.silu(acc).to(xbc.dtype), mag


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,k,extra", PW_CASES)
def test_cuda_ssm_conv_prep_matches_plain(cuda, b, s, h, p, n, k, extra, dtype):
    """The ``pre`` pass on views of the in-projection's output. xh, B and C:
    within one rounding of the dtype of the same sums in float64 (rtol
    2^-7 and atol 1e-5 in bf16, rtol = atol = 1e-5 in float32: the kernel
    sums in float32 and rounds once); and, elementwise, within
    1.1 (2K + 2) u (sum_i |w_i x_i| + |b|) + 2 u |want| of the plain chain,
    u the dtype's unit roundoff (the chain rounds each of K products and K
    sums, SiLU's slope is at most 1.1, and both round the output). a:
    rtol 1e-5 (exp of arguments up to about 30 in size carries their few
    ulp of error times that size)."""
    from repro_torch.kernels import ssm_pointwise as SP
    z, xbc, dt, prm = _pw_operands(cuda, b, s, h, p, n, k, extra, dtype)
    args = (prm["conv_w"], prm["conv_b"], prm["dt_bias"], prm["A_log"])
    before = SP.conv_prep.launches
    xh, B, C, a = SP.conv_prep(xbc, dt, *args, head_dim=p)
    got = (xh, B, C)
    assert SP.conv_prep.launches == before + 1
    want = SP.conv_prep_ref(xbc, dt, *args, head_dim=p)
    exact, mag = _conv_exact(xbc, prm["conv_w"], prm["conv_b"])
    u = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
    tol = dict(rtol=2 ** -7, atol=1e-5) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    for part, g, w in zip(torch.split(exact, [h * p, n, n], dim=-1), got, want):
        assert g.is_contiguous() and g.dtype == dtype and g.shape == w.shape
        g = g.reshape(part.shape)
        torch.testing.assert_close(g.float(), part.float(), **tol)
    bound = 1.1 * (2 * k + 2) * u * mag + 2 * u * exact.double().abs()
    diff = (torch.cat([t.reshape(b, s, -1) for t in got], -1).double()
            - torch.cat([t.reshape(b, s, -1) for t in want[:3]], -1).double()).abs()
    assert bool((diff <= bound + 1e-30).all()), float((diff - bound).max())
    torch.testing.assert_close(a, want[3], rtol=1e-5, atol=0)


@pytest.mark.parametrize("gate_first", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,k,extra", PW_CASES)
def test_cuda_ssm_gated_norm_matches_plain(cuda, b, s, h, p, n, k, extra, dtype, gate_first):
    """The ``post`` pass in both orders of norm and gate (gate first is
    granite-4.0-h-small's), z a view of the in-projection's output: within
    one rounding of the plain version of the same order (which computes in
    float32 and rounds once): rtol 2^-7, atol 1e-5 in bf16; rtol = atol =
    1e-5 in float32 (the mean's order of summation, rsqrtf)."""
    from repro_torch.kernels import ssm_pointwise as SP
    z, _, _, _ = _pw_operands(cuda, b, s, h, p, n, k, extra, dtype)
    g = torch.Generator(device=cuda).manual_seed(s)
    y = torch.randn((b, s, h, p), generator=g, device=cuda).to(dtype)
    xh = torch.randn((b, s, h, p), generator=g, device=cuda).to(dtype)
    D = torch.randn(h, generator=g, device=cuda)
    scale = (torch.randn(h * p, generator=g, device=cuda) * 0.1).to(dtype)
    before = SP.gated_norm.launches
    out = SP.gated_norm(y, xh, z, D, scale, eps=1e-5, gate_first=gate_first)
    assert SP.gated_norm.launches == before + 1
    want = SP.gated_norm_ref(y, xh, z, D, scale, 1e-5, gate_first)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == want.shape
    tol = dict(rtol=2 ** -7, atol=1e-5) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.float(), want.float(), **tol)


@pytest.mark.parametrize("gate_first", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssm_gated_norm_at_granite_width(cuda, dtype, gate_first):
    """Both orders of the ``post`` pass (the gate-first instantiation is
    granite-4.0-h-small's) at granite's one-shot shape, Bb 16, S 256,
    d_inner 8192 (128 heads of 64), z a view of the in-projection's output:
    within one rounding of the plain version of the same order, as above
    (rtol 2^-7, atol 1e-5 in bf16; rtol = atol = 1e-5 in float32)."""
    from repro_torch.kernels import ssm_pointwise as SP
    b, s, h, p = 16, 256, 128, 64
    z, _, _, _ = _pw_operands(cuda, b, s, h, p, 128, 4, 0, dtype)
    g = torch.Generator(device=cuda).manual_seed(31)
    y = torch.randn((b, s, h, p), generator=g, device=cuda).to(dtype)
    xh = torch.randn((b, s, h, p), generator=g, device=cuda).to(dtype)
    D = torch.randn(h, generator=g, device=cuda)
    scale = (torch.randn(h * p, generator=g, device=cuda) * 0.1).to(dtype)
    before = SP.gated_norm.launches
    out = SP.gated_norm(y, xh, z, D, scale, eps=1e-5, gate_first=gate_first)
    assert SP.gated_norm.launches == before + 1
    want = SP.gated_norm_ref(y, xh, z, D, scale, 1e-5, gate_first)
    other = SP.gated_norm_ref(y, xh, z, D, scale, 1e-5, not gate_first)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == want.shape
    tol = dict(rtol=2 ** -7, atol=1e-5) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.float(), want.float(), **tol)
    assert not torch.allclose(out.float(), other.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,d,window,scale", [
    (4, 256, 32, 8, 128, 0, 0.0078125),   # granite-4.0-h-small's: GQA 32/8, scale 1/128
    (16, 256, 32, 8, 128, 0, 0.0078125),  # the same at granite's one-shot batch
    (2, 100, 8, 1, 64, 16, 0.3),          # MQA with a window, another scale
])
def test_cuda_flash_attention_takes_a_scale(cuda, b, s, h, kv, d, window, scale, dtype):
    """K2 with the softmax scale given, bidirectional, against the plain
    version at that scale (the JAX tests' tolerance, 2e-5 float32 and 2e-2
    bf16); its output moves off the default scale's."""
    g = torch.Generator(device=cuda).manual_seed(s + d)
    n = lambda *sh: torch.randn(sh, generator=g, device=cuda).to(dtype)
    q, k, v = n(b, s, h, d), n(b, s, kv, d), n(b, s, kv, d)
    before, routes = FA.flash_attention.launches, dict(FA.flash_attention.route_launches)
    got = FA.flash_attention(q, k, v, causal=False, window=window, scale=scale)
    _launched_once(FA.flash_attention, _fa_route(dtype, d), before, routes)
    want = ref.flash_attention_ref(q, k, v, causal=False, window=window, scale=scale)
    default = ref.flash_attention_ref(q, k, v, causal=False, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype, 2e-5, 2e-2))
    assert not torch.allclose(got.float(), default.float(), rtol=0.1, atol=0.1)


def test_cuda_tiny_granite_kernel_route_matches_plain(cuda):
    """The reduced float32 granite-4.0-h-small (10 layers: 9 SSD mixers,
    their norm gate-first, and one NoPE attention layer at softmax scale
    1/128; every layer a MoE with a shared expert; the muP multipliers) on
    the kernel route against the plain route on the card: K2 once, K3 and
    each SSM pass 9 times a forward, K2 and K3 on their 3xTF32 routes; eps
    within 1e-3 (K2 and K3 in three TF32 products, the conv pass summing
    its taps in float32 once, over ten layers), the plain route launching
    none."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssm_pointwise as SP
    from repro_torch.models.transformer import forward, init_params
    cfg = get_config("granite_4p0_h_small").reduced().with_(objective="diffusion")
    params = init_params(cfg, 0, cuda)
    g = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randn((2, 64, cfg.d_model), generator=g, device=cuda)
    t = torch.tensor([0.8, 0.3], device=cuda)
    counts = lambda: (FA.flash_attention.launches, SS.ssd_scan.launches,
                      SP.conv_prep.launches, SP.gated_norm.launches)
    eps = {}
    for use_kernels, want in ((True, (1, 9, 9, 9)), (False, (0, 0, 0, 0))):
        before = counts()
        k2_routes, k3_routes = (dict(FA.flash_attention.route_launches),
                                dict(SS.ssd_scan.route_launches))
        with torch.no_grad():
            eps[use_kernels] = forward(params, cfg, embeds=x, t_cond=t, logits=False,
                                       use_kernels=use_kernels)["eps"]
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(counts(), before)) == want
        if use_kernels:
            assert FA.flash_attention.route_launches["tf32x3"] == k2_routes["tf32x3"] + 1
            assert SS.ssd_scan.route_launches["tf32x3"] == k3_routes["tf32x3"] + 9
    torch.testing.assert_close(eps[True], eps[False], rtol=1e-3, atol=1e-3)


def test_cuda_ssm_passes_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels import ssm_pointwise as SP
    z, xbc, dt, prm = _pw_operands(cuda, 1, 8, 2, 16, 16, 4, 0, torch.float32)
    with pytest.raises(ValueError, match="K in 1..4"):
        SP.conv_prep(xbc, dt, torch.zeros(5, xbc.shape[-1], device=cuda), prm["conv_b"],
                     prm["dt_bias"], prm["A_log"], head_dim=16)
    with pytest.raises(ValueError, match="one device"):
        SP.conv_prep(xbc, dt, prm["conv_w"], prm["conv_b"], prm["dt_bias"].cpu(),
                     prm["A_log"], head_dim=16)
    z = torch.zeros(2, 8, 32, device=cuda)
    y = torch.zeros(2, 8, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="y must be contiguous"):
        SP.gated_norm(y.transpose(0, 1).contiguous().transpose(0, 1), y, z,
                      torch.zeros(2, device=cuda), torch.zeros(32, device=cuda), eps=1e-5)


def test_cuda_one_shot_mamba2_launches_each_pass_once_a_layer(cuda):
    """A one-shot sample of the reduced float32 mamba2 on the kernel route:
    each pass and K3 once a layer and NFE; the plain route launches none."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import VPSDE, get_timesteps, make_plan
    from repro_torch.diffusion import lm as DLM
    from repro_torch.kernels import ssm_pointwise as SP
    from repro_torch.models.transformer import init_params
    cfg = get_config("mamba2_2p7b").reduced().with_(objective="diffusion")
    params = init_params(cfg, 0, cuda)
    sde = VPSDE()
    plan = dataclasses.replace(make_plan("tab3", sde, get_timesteps(sde, 6)), fused=True)
    want = cfg.n_layers * 6
    x_T = torch.randn((2, 40, cfg.d_model), generator=torch.Generator().manual_seed(6))
    for use_kernels, n in ((True, want), (False, 0)):
        before = (SP.conv_prep.launches, SP.gated_norm.launches, SS.ssd_scan.launches)
        with torch.no_grad():
            DLM.sample_tokens(params, cfg, plan, None, batch=2, seq_len=40, prior_std=1.0,
                              use_kernels=use_kernels, x_T=x_T.to(cuda))
        torch.cuda.synchronize()
        after = (SP.conv_prep.launches, SP.gated_norm.launches, SS.ssd_scan.launches)
        assert tuple(x - y for x, y in zip(after, before)) == (n, n, n)


# the MoE kernels' shapes (B, S, E, k, C, d, f): granite-4.0-h-small's one-shot
# shape and mixtral-8x7b's one layer, then small odd widths (4- and 2-byte accesses)
MOE_CASES = [(16, 256, 72, 10, 44, 4096, 768), (4, 256, 8, 2, 80, 4096, 14336),
             (3, 70, 16, 4, 6, 33, 20), (2, 40, 6, 2, 13, 35, 7)]
MOE_ROUTE_CASES = [(16, 256, 72, 10, 44, False), (4, 256, 8, 2, 80, False),
                   (16, 256, 72, 10, 44, True), (3, 300, 130, 3, 5, False)]


def _moe_logits(cuda, b, s, e, alike, seed=3):
    g = torch.Generator(device=cuda).manual_seed(seed)
    if alike:       # every token's logits the same: every token picks the same experts
        return torch.randn((1, 1, e), generator=g, device=cuda).expand(b, s, e).contiguous()
    return torch.randn((b, s, e), generator=g, device=cuda)


@pytest.mark.parametrize("b,s,e,k,c,alike", MOE_ROUTE_CASES)
def test_cuda_moe_route_matches_plain(cuda, b, s, e, k, c, alike):
    """``moe_route`` against its plain version on the card, at granite's and
    mixtral's shapes, with every token choosing the same experts (all but C
    of each row's pairs to an expert drop), and at E 130 (more experts
    than threads) over S 300 (a part tile): each token's chosen logits
    equal (ties may swap only between equal logits), then the choices,
    places, slots, table and kept counts bitwise; the gates, gate sums and
    logsumexps within float32 rounding (rtol 1e-5)."""
    from repro_torch.kernels import moe_dispatch as MD
    logits = _moe_logits(cuda, b, s, e, alike)
    before = MD.route.launches
    got = MD.route(logits, top_k=k, cap=c)
    torch.cuda.synchronize()
    assert MD.route.launches == before + 1
    want = MD.route_ref(logits, top_k=k, cap=c)
    torch.testing.assert_close(logits.gather(-1, got["gate_idx"]),
                               logits.gather(-1, want["gate_idx"]), rtol=0, atol=0)
    for key in ("gate_idx", "pos", "slot", "table", "kept"):
        assert torch.equal(got[key], want[key]), key
    for key in ("gate_vals", "gate_sum", "lse"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=1e-6)
    if alike:       # each chosen expert takes the row's first C tokens
        assert int((got["slot"] >= 0).sum()) == b * k * c
        assert bool((got["pos"] == torch.arange(s, device=cuda)[None, :, None]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,e,k,c,d,f", MOE_CASES)
def test_cuda_moe_gather_glu_combine_match_plain(cuda, b, s, e, k, c, d, f, dtype):
    """``moe_gather`` bitwise; ``moe_glu`` within one unit in the last place
    of its plain version (the same formula: bitwise but for a rounding
    flipped by the exponential); ``moe_combine`` with and without the shared
    addend within one rounding of its plain version's float32 sum (rtol one
    unit in the last place, atol 1e-5 of the largest expert output). Each
    launches once."""
    from repro_torch.kernels import moe_dispatch as MD
    g = torch.Generator(device=cuda).manual_seed(b + e + d)
    r = lambda *sh: torch.randn(sh, generator=g, device=cuda)
    route = MD.route(_moe_logits(cuda, b, s, e, False), top_k=k, cap=c)
    x, add = r(b, s, d).to(dtype), r(b, s, d).to(dtype)
    h, gate, out_e = (r(e, b * c, f) * 2).to(dtype), (r(e, b * c, f) * 2).to(dtype), \
        r(e, b * c, d).to(dtype)
    before = (MD.gather.launches, MD.glu.launches, MD.combine.launches)
    xin = MD.gather(x, route["table"])
    a = MD.glu(h, gate)
    outs = [MD.combine(out_e, route["slot"], route["gate_vals"], extra) for extra in (add, None)]
    torch.cuda.synchronize()
    assert (MD.gather.launches, MD.glu.launches, MD.combine.launches) == \
        (before[0] + 1, before[1] + 1, before[2] + 2)
    assert torch.equal(xin, MD.gather_ref(x, route["table"]))
    one = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -21
    torch.testing.assert_close(a.float(), MD.glu_ref(h, gate).float(), rtol=one, atol=1e-30)
    for out, extra in zip(outs, (add, None)):
        want = MD.combine_ref(out_e, route["slot"], route["gate_vals"], extra)
        torch.testing.assert_close(out.float(), want.float(), rtol=one,
                                   atol=1e-5 * out_e.abs().max().item())


def test_cuda_moe_takes_unaligned_views(cuda):
    """Operands one element past a 16-byte line (2- and 4-byte accesses):
    the gather bitwise, the combine within one rounding."""
    from repro_torch.kernels import moe_dispatch as MD
    b, s, e, k, c, d = 2, 40, 6, 2, 13, 64
    route = MD.route(_moe_logits(cuda, b, s, e, False), top_k=k, cap=c)
    g = torch.Generator(device=cuda).manual_seed(5)
    x = _unaligned(torch.randn((b, s, d), generator=g, device=cuda).to(torch.bfloat16))
    out_e = _unaligned(torch.randn((e, b * c, d), generator=g, device=cuda))
    assert torch.equal(MD.gather(x, route["table"]), MD.gather_ref(x, route["table"]))
    torch.testing.assert_close(MD.combine(out_e, route["slot"], route["gate_vals"]),
                               MD.combine_ref(out_e, route["slot"], route["gate_vals"]),
                               rtol=2.0 ** -21, atol=1e-5 * out_e.abs().max().item())


def test_cuda_tiny_granite_moe_kernel_route_never_synchronises(cuda):
    """The reduced float32 granite-4.0-h-small forward on the kernel route
    under ``torch.cuda.set_sync_debug_mode("error")``: no step of it waits
    on the card. Each MoE kernel launches once a layer (every layer is a
    MoE); the plain route launches none; the kernel route raises under
    autograd."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import moe_dispatch as MD
    from repro_torch.models.transformer import forward, init_params
    cfg = get_config("granite_4p0_h_small").reduced().with_(objective="diffusion")
    params = init_params(cfg, 0, cuda)
    g = torch.Generator(device=cuda).manual_seed(19)
    x = torch.randn((2, 64, cfg.d_model), generator=g, device=cuda)
    t = torch.tensor([0.8, 0.3], device=cuda)
    kernels = (MD.route, MD.gather, MD.glu, MD.combine)
    with torch.no_grad():
        forward(params, cfg, embeds=x, t_cond=t, logits=False, use_kernels=True)  # builds
        torch.cuda.synchronize()
        for use_kernels, n in ((True, cfg.n_layers), (False, 0)):
            before = [fn.launches for fn in kernels]
            torch.cuda.set_sync_debug_mode("error")
            try:
                forward(params, cfg, embeds=x, t_cond=t, logits=False, use_kernels=use_kernels)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            assert [fn.launches - b for fn, b in zip(kernels, before)] == [n] * 4
    from repro_torch.models import layers as L
    moe_p = {key: v.requires_grad_() if key == "router" else v
             for key, v in params["blocks"][0]["moe"].items()}
    with pytest.raises(RuntimeError, match="no backward"):
        L.moe(moe_p, cfg, x, use_kernels=True)


def _leaves(tree):
    from repro_torch.training.optimizer import tree_leaves
    return tree_leaves(tree)


@pytest.mark.parametrize("kernel", ["ssd_scan", "flash_attention"])
def test_cuda_wgmma_rings_hold_with_copies_held_back(cuda, kernel):
    """The wgmma kernels' rings keep their barriers' contract (csrc/ptx.cuh)
    when the producer holds every other item's copies back 4 us (the
    diagnostic build of tools/kernel_stress.py --delay-ns): over the tool's
    shapes (K3 at mamba2's widths, Bb 4 and 16; K2 at gemma-2b's heads, B 4
    and B 1 at S 1024 with the key tiles split, B 16 not), no wait returns
    before its item was filled or times out, no launch faults, and every
    output is the first launch's, which is held against the plain version."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import kernel_stress
    r = kernel_stress.stress(kernel, "wgmma", 300, seed=0,
                             defines=kernel_stress.defines_for(delay_ns=4000))
    assert (r["fault"], r["wrong"], r["early"], r["timeouts"]) == (None, None, 0, 0), r
    assert r["launches"] == 300


@pytest.mark.parametrize("kernel", ["ssd_scan", "flash_attention"])
def test_cuda_held_back_copies_break_the_first_rings(cuda, kernel):
    """The positive control of the test above: the rings as first written
    (one full barrier a stage, waited for by the item's parity; the
    diagnostic build's RING_DIAG_SHARED_FULL), under the same held-back
    copies, fault, give a wrong output or record an early wait, and the
    tool exits 3. So a clean run above shows the repair, not a delay that
    misses the fault. In a subprocess: a fault leaves the CUDA context
    unusable."""
    tool = Path(__file__).resolve().parents[1] / "tools" / "kernel_stress.py"
    r = subprocess.run([sys.executable, str(tool), kernel, "wgmma", "30", "0",
                        "--delay-ns", "4000", "--shared-full"],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 3, r.stdout + r.stderr
    assert "RING_DIAG_SHARED_FULL]" in r.stdout, r.stdout


def _launches():
    """Every hand-written kernel's launch count."""
    from repro_torch.kernels import moe_dispatch as MD
    from repro_torch.kernels import ssm_pointwise as SP
    return dict(K1=K.fused_ab_step.launches, K2=FA.flash_attention.launches,
                K3=SS.ssd_scan.launches, ssm_pre=SP.conv_prep.launches,
                ssm_post=SP.gated_norm.launches, moe_route=MD.route.launches,
                moe_gather=MD.gather.launches, moe_glu=MD.glu.launches,
                moe_combine=MD.combine.launches)


# one train step of each arch type: dense, ssm, moe, hybrid, encdec (frames),
# vlm (a prefix) on the diffusion objective, and dense on the ar objective
TRAIN_CASES = [("gemma_2b", "diffusion"), ("mamba2_2p7b", "diffusion"),
               ("mixtral_8x7b", "diffusion"), ("jamba_1p5_large", "diffusion"),
               ("whisper_tiny", "diffusion"), ("paligemma_3b", "diffusion"), ("gemma_2b", "ar")]


@pytest.mark.parametrize("arch,objective", TRAIN_CASES)
def test_cuda_train_step_matches_cpu(cuda, arch, objective):
    """One train step of the reduced float32 config on the card against the
    CPU, from the same params, batch (with its frames or prefix) and, for
    diffusion, t / eps: the loss at rtol 1e-5, every grad within 1e-3 of
    its leaf's max |grad| (cuBLAS against the CPU's summation order), the
    AdamW update of the same grads at rtol 1e-5, atol 1e-7 (elementwise
    float32); then ``train_step`` on the card, finite, on the plain route
    (no hand-written kernel launches: the reference trains with
    ``use_pallas=False``, and no kernel has a backward)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovTextSource, make_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.training import optimizer as O
    from repro_torch.training.steps import make_loss_fn, make_train_step
    cfg = get_config(arch).reduced().with_(objective=objective)
    p_cpu = init_params(cfg, 3, "cpu")
    p_dev = O.tree_map(lambda t: t.to(cuda), p_cpu)
    batch = {k: torch.from_numpy(v) for k, v in
             make_batch(cfg, MarkovTextSource(cfg.vocab_size, 0), 0, 2, 16).items()}
    g = torch.Generator().manual_seed(0)
    draws = {} if objective == "ar" else {
        "t": torch.rand((2,), generator=g) * 0.99 + 0.01,
        "eps": torch.randn((2, 16, cfg.d_model), generator=g)}
    loss_fn = make_loss_fn(cfg)
    (l_c, _), g_c = O.value_and_grad(loss_fn, p_cpu, batch, has_aux=True, **draws)
    (l_d, _), g_d = O.value_and_grad(loss_fn, p_dev, {k: v.to(cuda) for k, v in batch.items()},
                                     has_aux=True, **{k: v.to(cuda) for k, v in draws.items()})
    assert float(l_d) == pytest.approx(float(l_c), rel=1e-5)
    for a, b in zip(_leaves(g_d), _leaves(g_c)):
        assert (a.cpu() - b).abs().max() <= 1e-3 * b.abs().max()
    opt = O.AdamW(O.cosine_schedule(1e-3, 1, 10))
    opt.update(O.tree_map(lambda x: x.cpu(), g_d), opt.init(p_cpu), p_cpu)
    opt.update(g_d, opt.init(p_dev), p_dev)
    for a, b in zip(_leaves(p_dev), _leaves(p_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-7)
    before = _launches()
    _, state, m = make_train_step(cfg, opt)(p_dev, opt.init(p_dev),
                                            {k: v.to(cuda) for k, v in batch.items()},
                                            torch.Generator(device=cuda).manual_seed(1))
    assert all(torch.isfinite(v) for v in m.values()) and int(state.step) == 1
    assert state.step.device.type == "cuda"
    assert _launches() == before


def test_cuda_cifar10_scorenet_trains_and_checkpoints(cuda, tmp_path):
    """cifar10-scorenet at its published widths (4 layers, d_model 256,
    float32; vocab 256 as the reference's training test sets it) on the
    card: 30 diffusion train steps at batch 16, seq 32 of the Markov corpus,
    constant lr 3e-4, finite, the mean loss of the last 5 below that of the
    first 5; then its ``(params, opt_state)`` checkpoint restored bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovTextSource, make_batch
    from repro_torch.models.transformer import init_params
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training.optimizer import AdamW, constant_schedule
    from repro_torch.training.steps import make_train_step
    cfg = get_config("cifar10_scorenet").with_(objective="diffusion", vocab_size=256)
    params = init_params(cfg, 0, cuda)
    opt = AdamW(constant_schedule(3e-4))
    state, step = opt.init(params), make_train_step(cfg, opt)
    src, gen = MarkovTextSource(cfg.vocab_size, 0), torch.Generator(device=cuda).manual_seed(1)
    losses = []
    for i in range(30):
        batch = {k: torch.from_numpy(v).to(cuda) for k, v in make_batch(cfg, src, i, 16, 32).items()}
        params, state, m = step(params, state, batch, gen)
        losses.append(float(m["loss"]))
    assert all(map(math.isfinite, losses))
    assert sum(losses[-5:]) < sum(losses[:5]), losses
    CKPT.save(str(tmp_path), 30, (params, state), {"next_step": 30})
    (p2, s2), meta = CKPT.restore(str(tmp_path), (init_params(cfg, 1, cuda), opt.init(params)))
    assert meta == {"next_step": 30} and int(s2.step) == 30
    for a, b in zip(_leaves([params, state.m, state.v]), _leaves([p2, s2.m, s2.v])):
        assert torch.equal(a, b)


def test_cuda_adamw_matches_cpu(cuda):
    """AdamW, 3 steps with weight decay, on CUDA tensors against the CPU
    (per-layer lists under "blocks" decayed, a top-level vector not):
    rtol 1e-6, atol 1e-7."""
    from repro_torch.training import optimizer as O
    g = torch.Generator().manual_seed(2)
    n = lambda *s: torch.randn(s, generator=g)
    tree = lambda: {"blocks": [{"norm1": n(8), "w": n(8, 4)} for _ in range(2)],
                    "final_norm": n(8), "embed": n(16, 8)}
    p_cpu = tree()
    p_dev = O.tree_map(lambda t: t.to(cuda), p_cpu)
    opt = O.AdamW(O.cosine_schedule(1e-2, 1, 5), weight_decay=0.5, clip_norm=5.0)
    s_cpu, s_dev = opt.init(p_cpu), opt.init(p_dev)
    for _ in range(3):
        grads = tree()
        _, s_cpu, m_c = opt.update(grads, s_cpu, p_cpu)
        _, s_dev, m_d = opt.update(O.tree_map(lambda t: t.to(cuda), grads), s_dev, p_dev)
        assert float(m_d["grad_norm"]) == pytest.approx(float(m_c["grad_norm"]), rel=1e-6)
    for a, b in zip(_leaves([p_dev, s_dev.m, s_dev.v]), _leaves([p_cpu, s_cpu.m, s_cpu.v])):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-7)
    assert int(s_dev.step) == 3


def test_cuda_score_net_samples_through_k1(cuda):
    """The MLP score net trained on the card (60 steps on the 8-mode GMM),
    then a fused tab3 solve of 1024 points in 2-D: K1 launches once a step
    at x (1, 1024, 2), and the solve agrees with the unfused one (the plain
    version's arithmetic) within 1e-5."""
    import dataclasses
    from repro_torch.core import VPSDE, get_timesteps, make_plan, sample
    from repro_torch.diffusion.analytic import default_gmm
    from repro_torch.diffusion.score_net import train_score_net
    sde = VPSDE()
    gmm = default_gmm(sde, d=2)
    model = train_score_net(sde, gmm.sample_data, 2, steps=60, batch=256, device=cuda)
    eps = model.eps_fn()
    x_T = torch.randn((1024, 2), generator=torch.Generator(device=cuda).manual_seed(0),
                      device=cuda)
    plan = make_plan("tab3", sde, get_timesteps(sde, 10, "quadratic")).to(cuda)
    before = K.fused_ab_step.launches
    with torch.no_grad():
        fused = sample(dataclasses.replace(plan, fused=True), eps, x_T)
        assert K.fused_ab_step.launches == before + plan.n_steps
        plain = sample(plan, eps, x_T)
    assert fused.shape == (1024, 2) and torch.isfinite(fused).all()
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-5)


def test_cuda_paper_headline_on_the_gmm(cuda):
    """The paper's headline on the card, on the 8-mode GMM in 2-D with its
    exact eps: 1024 samples from one prior draw, tAB3 (fused: K1 once a
    step) against DDIM at 10 NFE (quadratic steps), both against rho_rk4 on
    400 log_rho steps: tAB3's RMS error is below DDIM's. The likelihood at
    8 and 32 kutta3 steps: the error falls, under 0.02 bits/dim at 32. An
    ``AdaptiveRK23`` solve gives a finite x0."""
    import dataclasses

    import numpy as np

    from repro_torch.core import (AdaptiveRK23, VPSDE, get_timesteps, make_plan,
                                  nll_bits_per_dim, sample)
    from repro_torch.diffusion.analytic import default_gmm
    sde = VPSDE()
    gmm = default_gmm(sde, d=2)
    eps = gmm.eps_fn()
    gen = torch.Generator(device=cuda).manual_seed(0)
    x_T = torch.randn((1024, 2), generator=gen, device=cuda) * sde.prior_std()
    plan = lambda name, n, kind="quadratic": make_plan(name, sde,
                                                       get_timesteps(sde, n, kind)).to(cuda)
    rms = lambda a, b: float(torch.sqrt(torch.mean((a - b) ** 2)))
    with torch.no_grad():
        ref_x = sample(plan("rho_rk4", 400, "log_rho"), eps, x_T)
        tab3 = dataclasses.replace(plan("tab3", 10), fused=True)
        before = K.fused_ab_step.launches
        err_tab3 = rms(sample(tab3, eps, x_T), ref_x)
        assert K.fused_ab_step.launches == before + tab3.n_steps
        err_ddim = rms(sample(plan("ddim", 10), eps, x_T), ref_x)
        assert err_tab3 < err_ddim, (err_tab3, err_ddim)
        x0 = gmm.sample_data(gen, 24, dtype=torch.float64)
        exact = float(-gmm.log_prob(x0).mean() / 2 / np.log(2.0))
        nll = {n: abs(float(nll_bits_per_dim(sde, eps, x0, n_steps=n, method="kutta3").mean())
                      - exact) for n in (8, 32)}
        assert nll[32] < nll[8] and nll[32] < 0.02, nll
        assert torch.isfinite(AdaptiveRK23(sde).solve(eps, x_T).x0).all()


def _cond(cfg, device, batch=2, seed=13):
    """A conditioned arch's inputs drawn from a seed, float32 N(0, 1):
    ``{"frames": (batch, encoder_seq, d_model)}`` (encdec) or ``{"prefix":
    (batch, prefix_tokens, d_model)}`` (vlm); {} for any other arch."""
    n = {"encdec": ("frames", cfg.encoder_seq), "vlm": ("prefix", cfg.prefix_tokens)}
    if cfg.arch_type not in n:
        return {}
    name, length = n[cfg.arch_type]
    gen = torch.Generator(device=device).manual_seed(seed)
    return {name: torch.randn((batch, length, cfg.d_model), generator=gen, device=device)}


# (arch, use_kernels, moe_dispatch, reduced): every arch type on the one-shot
# kernel route (the MoE in both dispatch modes), grok on the plain route (its
# logit softcap is not in K2), and cifar10-scorenet at its published widths
# (a float32 model: the 3xTF32 K2 at D 64)
ONE_SHOT_CASES = [("gemma_2b", True, "einsum", True), ("mamba2_2p7b", True, "einsum", True),
                  ("jamba_1p5_large", True, "einsum", True),
                  ("mixtral_8x7b", True, "einsum", True), ("mixtral_8x7b", True, "gather", True),
                  ("grok_1_314b", False, "einsum", True), ("whisper_tiny", True, "einsum", True),
                  ("paligemma_3b", True, "einsum", True),
                  ("cifar10_scorenet", True, "einsum", False)]


@pytest.mark.parametrize("arch,use_kernels,dispatch,reduced", ONE_SHOT_CASES)
def test_cuda_one_shot_matches_cpu(cuda, arch, use_kernels, dispatch, reduced):
    """``sample_tokens`` with a fused tab3 plan of 6 steps (with frames or a
    prefix where the arch takes them) on the card against the same call on
    the CPU (plain versions), float32, from the same x_T: a finite x0 within
    1e-3 (cuBLAS and the 3xTF32 kernels against the CPU's summation order);
    on the card K1 once a step, K2 once an attention layer and NFE, K3 and
    each SSM pass once an SSM layer and NFE, each MoE kernel once a MoE
    layer and NFE (none of K2, K3, the passes and the MoE kernels on the
    plain route), every K2 and K3 launch on its 3xTF32 kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import VPSDE, get_timesteps, make_plan
    from repro_torch.diffusion import lm as DLM
    from repro_torch.models.transformer import _layer_kind, init_params
    from repro_torch.training import optimizer as O
    cfg = get_config(arch)
    cfg = (cfg.reduced() if reduced else cfg).with_(objective="diffusion", moe_dispatch=dispatch)
    p_cpu = init_params(cfg, 4, "cpu")
    p_dev = O.tree_map(lambda t: t.to(cuda), p_cpu)
    sde = VPSDE()
    plan = dataclasses.replace(make_plan("tab3", sde, get_timesteps(sde, 6)), fused=True)
    x_T = torch.randn((2, 40, cfg.d_model), generator=torch.Generator().manual_seed(6))
    c_cpu = _cond(cfg, "cpu")
    kinds = [_layer_kind(cfg, i) for i in range(cfg.n_layers)]
    n_attn = sum(k[0] == "attn" for k in kinds) * 6 * use_kernels
    n_ssm = sum(k[0] == "ssm" for k in kinds) * 6 * use_kernels
    n_moe = sum(k[1] == "moe" for k in kinds) * 6 * use_kernels
    want = dict(K1=plan.n_steps, K2=n_attn, K3=n_ssm, ssm_pre=n_ssm, ssm_post=n_ssm,
                moe_route=n_moe, moe_gather=n_moe, moe_glu=n_moe, moe_combine=n_moe)
    before = _launches()
    k2_routes, k3_routes = (dict(FA.flash_attention.route_launches),
                            dict(SS.ssd_scan.route_launches))
    with torch.no_grad():
        _, x_dev = DLM.sample_tokens(p_dev, cfg, plan, None, batch=2, seq_len=40,
                                     prior_std=1.0, use_kernels=use_kernels,
                                     x_T=x_T.to(cuda), **{k: v.to(cuda) for k, v in c_cpu.items()})
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in _launches().items()} == want
        assert FA.flash_attention.route_launches == dict(k2_routes, tf32x3=k2_routes["tf32x3"]
                                                         + n_attn)
        assert SS.ssd_scan.route_launches == dict(k3_routes, tf32x3=k3_routes["tf32x3"] + n_ssm)
        _, x_cpu = DLM.sample_tokens(p_cpu, cfg, plan, None, batch=2, seq_len=40,
                                     prior_std=1.0, use_kernels=use_kernels, x_T=x_T, **c_cpu)
    assert x_dev.shape == (2, 40, cfg.d_model) and torch.isfinite(x_dev).all()
    torch.testing.assert_close(x_dev.cpu(), x_cpu, rtol=1e-3, atol=1e-3)


def test_cuda_sample_tokens_stream_matches_cpu(cuda):
    """The served path's one-shot solve (``sample_tokens_stream``: a stacked
    group of two rows, fused tab3 with the error pair, 8 steps) of the
    reduced float32 gemma-2b on the card against the CPU from the same x_T:
    a finite x0 within 1e-3; K1 once a step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import VPSDE, get_timesteps, make_plan, stack_plans
    from repro_torch.diffusion import lm as DLM
    from repro_torch.models.transformer import init_params
    from repro_torch.training import optimizer as O
    cfg = get_config("gemma_2b").reduced().with_(objective="diffusion")
    sde = VPSDE()
    p_cpu = init_params(cfg, 3, "cpu")
    p_dev = O.tree_map(lambda t: t.to(cuda), p_cpu)
    plan = make_plan("tab3", sde, get_timesteps(sde, 8), error_estimate=True)
    plan = stack_plans([dataclasses.replace(plan, fused=True)] * 2)
    x_T = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(5))
    before = K.fused_ab_step.launches
    with torch.no_grad():
        _, x_dev = DLM.sample_tokens_stream(p_dev, cfg, plan, None, seq_len=16, prior_std=1.0,
                                            x_T=x_T.to(cuda))
        torch.cuda.synchronize()
        assert K.fused_ab_step.launches == before + plan.n_steps
        _, x_cpu = DLM.sample_tokens_stream(p_cpu, cfg, plan, None, seq_len=16, prior_std=1.0,
                                            x_T=x_T)
    assert x_dev.shape == (2, 16, cfg.d_model) and torch.isfinite(x_dev).all()
    torch.testing.assert_close(x_dev.cpu(), x_cpu, rtol=1e-3, atol=1e-3)


def _ar_decode_logits(cfg, params, seq, n_prompt, cond):
    """Prefill ``seq[:, :n_prompt]`` (with ``cond``: a vlm's ``prefix`` of P
    positions or an encdec's ``frames``) into a cache of P + ``seq``'s
    length, then decode the rest of ``seq`` one token at a time at
    ``cache_index`` P + i. Returns the logits of the last prompt position
    and of each decoded position, (B, L - n_prompt + 1, vocab)."""
    from repro_torch.models import transformer as T
    from repro_torch.training.steps import make_decode_step, make_prefill_step
    b, L = seq.shape
    p = cond["prefix"].shape[1] if "prefix" in cond else 0
    with torch.no_grad():
        logits, pf = make_prefill_step(cfg)(params, dict(cond, tokens=seq[:, :n_prompt]))
        cache = T.init_cache(cfg, b, p + L, device=seq.device)
        for dst, src in zip(cache["blocks"], pf["blocks"]):
            for name, t in src.items():
                dst[name][:, :t.shape[1]].copy_(t)
        if "cross" in pf:
            cache["cross"] = pf["cross"]
        out = [logits]
        decode = make_decode_step(cfg)
        for i in range(n_prompt, L):
            logits, cache = decode(params, cache, seq[:, i:i + 1], p + i)
            out.append(logits)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("arch", ["gemma_2b", "mamba2_2p7b", "h2o_danube_3_4b",
                                  "jamba_1p5_large", "whisper_tiny", "paligemma_3b"])
def test_cuda_ar_decode_matches_cpu(cuda, arch):
    """The reduced float32 model's AR decode on the card against the CPU:
    prefill 40 tokens (h2o-danube: into its ring of window slots; jamba: a
    cache of ssm and attention layers; whisper: with frames, then the cross
    cache; paligemma: behind a prefix that ``cache_index`` counts), then 8
    teacher-forced decode steps: finite logits of the right shape within
    1e-3."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.training import optimizer as O
    cfg = get_config(arch).reduced().with_(objective="ar")
    p_cpu = init_params(cfg, 5, "cpu")
    p_dev = O.tree_map(lambda t: t.to(cuda), p_cpu)
    seq = torch.from_numpy(np.random.RandomState(8).randint(0, cfg.vocab_size, (2, 48)))
    c_cpu = _cond(cfg, "cpu")
    lg_cpu = _ar_decode_logits(cfg, p_cpu, seq, 40, c_cpu)
    lg_dev = _ar_decode_logits(cfg, p_dev, seq.to(cuda), 40,
                               {k: v.to(cuda) for k, v in c_cpu.items()}).cpu()
    assert lg_dev.shape == (2, 9, cfg.vocab_size) and torch.isfinite(lg_dev).all()
    torch.testing.assert_close(lg_dev, lg_cpu, rtol=1e-3, atol=1e-3)


def test_cuda_cld_matches_cpu(cuda):
    """CLD's matrix tAB-DEIS (order 2, 16 steps) and its fine RK4 reference
    (200 steps) on the exactly-scored Gaussian problem, float64 on the card
    against the CPU: finite, rtol 1e-10, atol 1e-12 (matrix products in
    another order)."""
    import numpy as np

    from repro_torch.core.matrix_sde import CLD, CLDGaussianOracle, cld_reference, cld_sample
    cld = CLD()
    orc = CLDGaussianOracle(cld, mean=1.0, var=0.25)
    m_t, s_t = orc._moments(1.0)
    z_T = torch.from_numpy(m_t + np.random.RandomState(0).randn(128, 2)
                           @ np.linalg.cholesky(s_t).T)
    ts = np.linspace(cld.T, cld.t0, 17)
    out = {}
    for dev in ("cpu", cuda):
        z = z_T.to(dev)
        out[str(dev)] = (cld_sample(cld, ts, 2, orc.eps_fn(), z).cpu(),
                         cld_reference(cld, orc.eps_fn(), z, n_steps=200).cpu())
    for got, want in zip(out[str(cuda)], out["cpu"]):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


def test_cuda_engine_launches_k1_once_an_ab_step(cuda):
    """``DiffusionServeEngine`` on the card, reduced float32 gemma-2b with a
    ``RetirePolicy`` and seq_len buckets (128, 256): two staggered waves of
    ddim, tab3, dpm2m, sndeis2, seeds2 and rho_heun requests, the second
    sent when request 1 comes back (a join). Every request completes with
    tokens of its length in the vocabulary; K1 launches once an ``ab``
    group step; a warm replay of the same waves adds no executor and again
    launches K1 once an ``ab`` group step."""
    from repro_torch.configs import get_config
    from repro_torch.core import RetirePolicy, VPSDE, get_timesteps, make_plan, solver_stages
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import DiffusionServeEngine, Request
    cfg = get_config("gemma_2b").reduced().with_(objective="diffusion")
    sde = VPSDE()
    eng = DiffusionServeEngine(init_params(cfg, 0, cuda), cfg, sde=sde,
                               retire=RetirePolicy(tol=0.05, min_k=3, norm="rel"),
                               seq_len_buckets=(128, 256), device=cuda)
    wave1 = [Request(uid=0, solver="ddim", nfe=8, seq_len=100, seed=10),
             Request(uid=1, solver="ddim", nfe=6, seq_len=128, seed=11),
             Request(uid=2, solver="tab3", nfe=8, seq_len=256, seed=12),
             Request(uid=3, solver="dpm2m", nfe=8, seq_len=256, seed=13),
             Request(uid=4, solver="sndeis2", nfe=10, seq_len=200, seed=14),
             Request(uid=5, solver="seeds2", nfe=8, seq_len=256, seed=15),
             Request(uid=6, solver="rho_heun", nfe=8, seq_len=128, seed=16)]
    wave2 = [Request(uid=7, solver="ddim", nfe=6, seq_len=96, seed=17),
             Request(uid=8, solver="tab3", nfe=6, seq_len=240, seed=18)]
    method = {q.uid: make_plan(q.solver, sde, get_timesteps(
        sde, max(1, q.nfe // solver_stages(q.solver)))).method for q in wave1 + wave2}

    def serve():
        ab, results, sent = [0], [], False
        on_step = lambda ev: ab.__setitem__(0, ab[0] + (method[ev.uids[0]] == "ab"))
        before = K.fused_ab_step.launches
        for q in wave1:
            eng.submit(q)
        while eng.busy:
            results += eng.tick(on_step=on_step)
            if not sent and any(r.uid == 1 for r in results):
                for q in wave2:
                    eng.submit(q)
                sent = True
        torch.cuda.synchronize()
        assert K.fused_ab_step.launches - before == ab[0] > 0
        return results

    cold = serve()
    want = {q.uid: q.seq_len for q in wave1 + wave2}
    assert sorted(r.uid for r in cold) == sorted(want)
    for r in cold:
        assert r.tokens.shape == (want[r.uid],)
        assert 0 <= r.tokens.min() and r.tokens.max() < cfg.vocab_size
    snap = eng.metrics.snapshot()
    assert snap["serve_submitted_total"] == snap["serve_completed_total"] == len(want)
    assert eng.joined_requests >= 1
    serve()
    assert eng.metrics.snapshot()["serve_compile_cache_misses_total"] == \
        snap["serve_compile_cache_misses_total"]


@pytest.fixture
def one_rank_nccl(cuda, tmp_path):
    """A one-rank NCCL default group from a file store (the engine adds its
    gloo control group) and the request mesh over it; torn down after."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_request_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield make_request_mesh()
    finally:
        dist.destroy_process_group()


def test_cuda_sharded_engine_one_rank_bitwise(one_rank_nccl):
    """The request-axis engine on a one-rank NCCL group, reduced float32
    gemma-2b on the card: a ragged mix with a join, compaction, early exit
    and a stochastic family gives the unsharded engine's results bitwise
    (at one rank the local shapes are the unsharded ones), K1 launches once
    an ab group step, and a warm replay adds no executor; then a
    ``ServeDriver`` over it completes 4 requests with no crash."""
    from repro_torch.configs import get_config
    from repro_torch.core import RetirePolicy
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.driver import ServeDriver
    from repro_torch.serving.engine import DiffusionServeEngine, Request
    cfg = get_config("gemma_2b").reduced().with_(objective="diffusion")
    params = init_params(cfg, 0, "cuda")
    reqs = [Request(uid=i, seq_len=16, nfe=[3, 7][i % 2], solver="ddim", seed=i)
            for i in range(6)]
    reqs += [Request(uid=10 + i, seq_len=12, nfe=6, solver=s, seed=20 + i)
             for i, s in enumerate(["tab3", "seeds2", "tab2"])]
    kw = dict(max_group=4, seq_len_buckets=(16,), retire=RetirePolicy(tol=1.0, min_k=2),
              device="cuda")

    def drive(eng):
        out, ab = [], [0]
        on_step = lambda ev: ab.__setitem__(0, ab[0] + 1)   # every family here is ab
        for r in reqs[:5]:
            eng.submit(r)
        for _ in range(3):
            out += eng.tick(on_step=on_step)
        for r in reqs[5:]:
            eng.submit(r)
        while eng.busy:
            out += eng.tick(on_step=on_step)
        return {r.uid: r for r in out}, ab[0]

    want, _ = drive(DiffusionServeEngine(params, cfg, **kw))
    eng = DiffusionServeEngine(params, cfg, mesh=one_rank_nccl, **kw)
    before = K.fused_ab_step.launches
    got, ab_steps = drive(eng)
    assert K.fused_ab_step.launches - before == ab_steps > 0
    assert sorted(got) == sorted(want)
    for uid, w in want.items():
        g = got[uid]
        assert torch.equal(torch.as_tensor(g.tokens), torch.as_tensor(w.tokens)), uid
        assert (g.nfe, g.early_exit, g.final_err) == (w.nfe, w.early_exit, w.final_err)
    assert eng.joined_requests >= 1
    n = eng.num_executors
    again, _ = drive(eng)
    assert eng.num_executors == n
    assert all(torch.equal(torch.as_tensor(again[u].tokens), torch.as_tensor(want[u].tokens))
               for u in want)
    with ServeDriver(eng) as drv:      # its scheduler thread makes every collective
        handles = [drv.submit(Request(uid=500 + i, seq_len=16, nfe=4, solver="ddim", seed=i))
                   for i in range(4)]
        res = [h.result(timeout=300) for h in handles]
    assert [tuple(r.tokens.shape) for r in res] == [(16,)] * 4
    assert eng.metrics.snapshot()["driver_crash_total"] == 0
    eng.close()


def test_cuda_expert_parallel_one_rank(one_rank_nccl):
    """Expert-parallel MoE on a one-rank NCCL group, reduced float32 mixtral
    on the card, capacity_factor 100: within the reference's bounds of
    ``layers.moe`` (2e-4 on the output, 1e-3 on the load-balance loss)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.sharding.expert_parallel import moe_expert_parallel
    cfg = get_config("mixtral_8x7b").reduced().with_(objective="ar")
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=100.0),
                    moe_dispatch="gather")
    params = L.init_moe(torch.Generator(device="cuda").manual_seed(0), cfg, torch.float32,
                        "cuda")
    x = torch.randn((4, 32, cfg.d_model), generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda")
    out, aux = moe_expert_parallel(params, cfg, x, one_rank_nccl)
    want, aux_w = L.moe(params, cfg, x)
    assert (out - want).abs().max().item() < 2e-4
    assert abs(aux["moe_lb"].item() - aux_w["moe_lb"].item()) < 1e-3


def test_cuda_sharded_train_step_one_rank(one_rank_nccl):
    """The model-parallel train step on a one-rank NCCL host mesh (DTensor
    params, moments and batch), reduced float32 gemma on the card, 2 steps:
    the unsharded step's losses, grad norms and params, bitwise (at one rank
    the local shapes and products are the unsharded ones)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovTextSource, device_put_sharded, make_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.convert import tree_leaves
    from repro_torch.models.transformer import init_params
    from repro_torch.sharding import rules as R
    from repro_torch.training.optimizer import AdamW, constant_schedule
    from repro_torch.training.steps import make_train_step
    cfg = get_config("gemma_2b").reduced().with_(objective="diffusion")
    mesh = make_host_mesh(model=1)
    src = MarkovTextSource(cfg.vocab_size, 0)
    runs = []
    for sharded in (False, True):
        params = init_params(cfg, 0, "cuda")
        if sharded:
            params = R.device_put(params, R.to_shardings(R.param_specs(params, mesh), mesh))
        opt = AdamW(constant_schedule(1e-3))
        state, step = opt.init(params), make_train_step(cfg, opt)
        gen = torch.Generator(device="cuda").manual_seed(1)
        metrics = []
        for i in range(2):
            host = make_batch(cfg, src, i, 4, 16)
            batch = device_put_sharded(host, R.to_shardings(R.batch_specs(host, mesh), mesh),
                                       "cuda") if sharded else \
                {k: torch.from_numpy(v).cuda() for k, v in host.items()}
            params, state, m = step(params, state, batch, gen)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        leaves = [p.full_tensor() if sharded else p for p in tree_leaves(params)]
        runs.append((metrics, leaves))
    (m0, p0), (m1, p1) = runs
    assert m1 == m0
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.parametrize("kind", ["train", "deis"])
def test_cuda_dryrun_fake_counts_equal_a_real_step(one_rank_nccl, kind):
    """The dry run's accounting (``launch.dryrun.count_costs``) of one step
    of reduced gemma built by ``make_workload`` on a one-rank NCCL host
    mesh, on the card, and of the same step on fake CUDA tensors over a
    fake one-rank group: the same FLOPs, bytes and collectives."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_config("gemma_2b").reduced().with_(objective="diffusion")
    shape = ShapeConfig(kind, 16, 4, kind)
    mesh = make_host_mesh(model=1)
    fn, args, _ = D.make_workload(cfg, shape, mesh, device="cuda")
    real = D.count_costs(fn, args, mesh)
    dist.destroy_process_group()        # the fixture's group; a process has one default
    D.init_fake_world(1)
    try:
        fake_mesh = make_host_mesh(model=1, device_type="cuda")
        with FakeTensorMode():
            fn, args, _ = D.make_workload(cfg, shape, fake_mesh, device="cuda")
            fake = D.count_costs(fn, args, fake_mesh)
    finally:
        dist.destroy_process_group()
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))   # for the teardown
    assert real["flops"] > 0 and real["bytes"] > 0
    for key in ("flops", "bytes", "collectives"):
        assert fake[key] == real[key], key
