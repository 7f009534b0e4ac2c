"""Which kernel a launch takes in K2 (flash attention) and K3 (SSD scan),
on the CPU. Four routes, picked by a pure function of the operands: for
bf16, ``wgmma`` where a TMA tensor map can describe them (16-byte aligned
base pointers; K2: D 64, 128 or 256; K3: P and N multiples of 8), else
``mma_sync``; for float32, ``tf32x3`` where every base pointer is 16-byte
aligned (K3: P and N multiples of 8), else ``cuda_cores``. The wrapper
hands the C entry the route's code and counts each launch on its route;
CPU tensors (the plain versions) launch nothing. The kernels themselves run
only on the card (``tests/test_torch_cuda.py``); here the C entry points'
route switch is held to the wrappers' routes."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd_scan as SS
from repro_torch.kernels.runtime import unaligned_copy as _unaligned

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
DTYPES = [torch.bfloat16, torch.float32]
# per source: its C entry point, and per route the call in the entry's
# route switch, the launcher that call reaches and the kernel it starts
SOURCES = {
    "flash_attention": ("flash_attention_fwd", {
        "wgmma": ("launch_wgmma_dim", "launch_wgmma", "flash_fwd_wgmma_kernel"),
        "mma_sync": ("launch_dim<true>", "launch_mma", "flash_fwd_mma_kernel"),
        "tf32x3": ("launch_tf32x3_dim", "launch_tf32x3", "flash_fwd_tf32x3_kernel"),
        "cuda_cores": ("launch_dim<false>", "launch_f32", "flash_fwd_kernel")}),
    "ssd_scan": ("ssd_scan_fwd", {
        "wgmma": ("launch_wgmma", "launch_wgmma_hg", "ssd_scan_wgmma_kernel"),
        "mma_sync": ("launch_mma", "launch_mma", "ssd_scan_mma_kernel"),
        "tf32x3": ("launch_tf32x3", "launch_tf32x3_hg", "ssd_scan_tf32x3_kernel"),
        "cuda_cores": ("launch_f32", "launch_f32", "ssd_scan_kernel")}),
}
ROUTE_NAMES = ["wgmma", "mma_sync", "tf32x3", "cuda_cores"]
# the one-shot path's attention (B, S, H, KV, D) and scan (Bb, S, H, P, N)
# shapes, cut to a short sequence: the route does not depend on B or S
MAIN_PATH_ARCHS = ["gemma_2b", "mixtral_8x7b", "whisper_tiny", "paligemma_3b", "mamba2_2p7b"]
# the float32 one-shot paths' widths: every main-path arch at its published
# widths, the paper-native cifar10-scorenet (float32 itself), and the reduced
# float32 models that the card is held to the CPU with
FLOAT32_ARCHS = [(a, False) for a in MAIN_PATH_ARCHS + ["cifar10_scorenet", "jamba_1p5_large"]] \
    + [(a, True) for a in ["gemma_2b", "mamba2_2p7b", "jamba_1p5_large", "mixtral_8x7b",
                           "whisper_tiny", "paligemma_3b"]]


def _operands(mod, dtype):
    """Small CPU operands of the wrapper, in dtype."""
    g = torch.Generator().manual_seed(0)
    n = lambda *s: torch.randn(s, generator=g).to(dtype)
    if mod is FA:
        return (n(1, 8, 2, 64), n(1, 8, 1, 64), n(1, 8, 1, 64))
    return (n(1, 8, 2, 16), torch.rand((1, 8, 2), generator=g) * 0.3 + 0.7,
            n(1, 8, 8), n(1, 8, 8))


def _arch_operands(arch, dtype=torch.bfloat16, seq=8, reduced=False):
    """Operands of K2 or K3 at ``arch``'s head widths (``reduced``: its
    reduced config's), as the one-shot path makes them (contiguous, freshly
    allocated)."""
    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    if cfg.ssm is not None:
        p, n = cfg.ssm.head_dim, cfg.ssm.state_dim
        h = cfg.ssm.expand * cfg.d_model // p
        return SS, (torch.zeros(1, seq, h, p, dtype=dtype), torch.ones(1, seq, h),
                    torch.zeros(1, seq, n, dtype=dtype), torch.zeros(1, seq, n, dtype=dtype))
    d = cfg.resolved_head_dim
    return FA, (torch.zeros(1, seq, cfg.n_heads, d, dtype=dtype),
                torch.zeros(1, seq, cfg.n_kv_heads, d, dtype=dtype),
                torch.zeros(1, seq, cfg.n_kv_heads, d, dtype=dtype))


def _route(mod, ops):
    return mod.route(*ops) if mod is FA else mod.route(ops[0], ops[2], ops[3])


def _wrapper(mod):
    return mod.flash_attention if mod is FA else mod.ssd_scan


def _launch(mod, entry, ops):
    if mod is FA:
        return mod._launch(entry, *ops, True, 0, None)
    return mod._launch(entry, *ops, 8, None)


@pytest.mark.parametrize("route", ROUTE_NAMES)
@pytest.mark.parametrize("mod", [FA, SS], ids=["flash_attention", "ssd_scan"])
def test_dtype_takes_its_route_in_the_c_entry(mod, route):
    """The C entry's switch calls, for each route's code, that route's
    launcher, and that launcher starts the route's kernel."""
    name = mod.__name__.rsplit(".", 1)[1]
    entry, routes = SOURCES[name]
    call, launcher, kernel = routes[route]
    assert set(mod.ROUTES) == set(routes) == set(mod.ROUTE_CODES)
    src = (CSRC / f"{name}.cu").read_text()
    switch = src[src.index(f'extern "C" int {entry}('):]
    assert f"case {mod.ROUTE_CODES[route]}: return {call}(" in switch
    body = re.search(rf"cudaError_t {launcher}\((.*?)\n}}\n", src, re.S).group(1)
    if call != launcher:   # a dispatcher in between: it reaches the launcher
        dispatch = re.search(rf"cudaError_t {re.escape(call.split('<')[0])}\((.*?)\n}}\n",
                             src, re.S).group(1)
        assert re.search(rf"\b{launcher}(<[^<>()]*>)?\(", dispatch) or "FA_LAUNCH" in dispatch
    assert re.search(rf"\b{kernel}(<[^<>()]*>)?<<<", body)
    if call.startswith("launch_dim"):   # K2 picks the launcher by the template flag
        assert "MMA ? launch_mma<DIM>(" in src and ": launch_f32<DIM>(" in src


@pytest.mark.parametrize("arch", MAIN_PATH_ARCHS)
def test_main_path_shapes_take_wgmma(arch):
    """Every shape the one-shot path gives K2 and K3 in bf16 takes the
    wgmma route."""
    mod, ops = _arch_operands(arch)
    assert _route(mod, ops) == "wgmma"


@pytest.mark.parametrize("arch,reduced", FLOAT32_ARCHS)
def test_float32_takes_tf32x3(arch, reduced):
    """float32 operands as the one-shot path makes them take the 3xTF32
    kernels, at every arch's widths the float32 paths run."""
    mod, ops = _arch_operands(arch, torch.float32, reduced=reduced)
    assert _route(mod, ops) == "tf32x3"


@pytest.mark.parametrize("arch", MAIN_PATH_ARCHS)
def test_float32_takes_cuda_cores(arch):
    """float32 views whose data do not start on a 16-byte line: no 16-byte
    cp.async can copy their rows, so the CUDA-core kernel takes them."""
    mod, ops = _arch_operands(arch, torch.float32)
    ops = tuple(_unaligned(t) if i != 1 or mod is FA else t for i, t in enumerate(ops))
    assert _route(mod, ops) == "cuda_cores"


@pytest.mark.parametrize("arch", MAIN_PATH_ARCHS)
def test_unaligned_views_take_mma_sync(arch):
    """bf16 operands whose data do not start on a 16-byte line: no tensor
    map can describe them, so the mma_sync kernel takes them."""
    mod, ops = _arch_operands(arch)
    ops = tuple(_unaligned(t) if t.dtype == torch.bfloat16 else t for t in ops)
    assert _route(mod, ops) == "mma_sync"


@pytest.mark.parametrize("shape,route", [
    ((1, 8, 2, 32), "mma_sync"),      # D 32: no wgmma instantiation
    ((1, 8, 2, 64), "wgmma"),
    ((1, 8, 2, 128), "wgmma"),
    ((1, 8, 2, 256), "wgmma"),
])
def test_flash_attention_head_dims(shape, route):
    q = torch.zeros(shape, dtype=torch.bfloat16)
    k = torch.zeros(shape[:2] + (1, shape[3]), dtype=torch.bfloat16)
    assert FA.route(q, k, k.clone()) == route


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_flash_attention_float32_head_dims(d):
    """The 3xTF32 kernel has every head dim of the kernels (32 to 256)."""
    q = torch.zeros((1, 8, 2, d))
    k = torch.zeros((1, 8, 1, d))
    assert FA.route(q, k, k.clone()) == "tf32x3"


SS_WIDTHS = [
    (64, 128, "wgmma"), (16, 8, "wgmma"), (8, 16, "wgmma"), (24, 72, "wgmma"),
    (12, 20, "mma_sync"),   # widths no multiple of 8: a row stride TMA cannot take
    (64, 20, "mma_sync"), (12, 128, "mma_sync"),
]


@pytest.mark.parametrize("p,n,route", SS_WIDTHS)
def test_ssd_scan_widths(p, n, route):
    x = torch.zeros(1, 8, 2, p, dtype=torch.bfloat16)
    B = torch.zeros(1, 8, n, dtype=torch.bfloat16)
    assert SS.route(x, B, B.clone()) == route


@pytest.mark.parametrize("p,n,bf16_route", SS_WIDTHS)
def test_ssd_scan_float32_widths(p, n, bf16_route):
    """float32 takes the 3xTF32 kernel at the widths bf16 takes wgmma at (P
    and N multiples of 8), the CUDA-core kernel at the others."""
    x = torch.zeros(1, 8, 2, p)
    B = torch.zeros(1, 8, n)
    assert SS.route(x, B, B.clone()) == ("tf32x3" if bf16_route == "wgmma" else "cuda_cores")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mod", [FA, SS], ids=["flash_attention", "ssd_scan"])
def test_cpu_tensors_launch_no_route(mod, dtype):
    fn = _wrapper(mod)
    before, routes = fn.launches, dict(fn.route_launches)
    out = fn(*_operands(mod, dtype))
    assert fn.launches == before and fn.route_launches == routes
    assert set(fn.route_launches) == {"wgmma", "mma_sync", "tf32x3", "cuda_cores"}
    assert (out if mod is FA else out[0]).dtype == dtype


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mod", [FA, SS], ids=["flash_attention", "ssd_scan"])
def test_launch_counts_its_route(mod, dtype, aligned, monkeypatch):
    """``_launch`` hands the C entry the route its operands select and
    counts one launch, on that route only (a stand-in entry point on CPU
    tensors): aligned operands take ``wgmma`` (bf16) or ``tf32x3``
    (float32), views one element past a 16-byte line ``mma_sync`` or
    ``cuda_cores``."""
    fn = _wrapper(mod)
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "route_launches", dict.fromkeys(mod.ROUTES, 0))
    seen = []

    def entry(*args):
        seen.append(args)
        return 0

    ops = _operands(mod, dtype)
    if not aligned:
        ops = tuple(_unaligned(t) if t.dtype == dtype else t for t in ops)
    _launch(mod, entry, ops)
    code = seen[0][4] if mod is FA else seen[0][7]
    route = _route(mod, ops)
    bf16 = dtype == torch.bfloat16
    assert route == {(True, True): "wgmma", (True, False): "tf32x3",
                     (False, True): "mma_sync", (False, False): "cuda_cores"}[aligned, bf16]
    assert code == mod.ROUTE_CODES[route]
    want = dict.fromkeys(mod.ROUTES, 0)
    want[route] = 1
    assert fn.launches == 1 and fn.route_launches == want


@pytest.mark.parametrize("s,chunk,tiles", [(8, 8, 0), (40, 16, 1), (300, 256, 4), (600, 100, 2)])
def test_ssd_scan_scratch_only_across_chunks(s, chunk, tiles, monkeypatch):
    """The wgmma kernel gets float32 scratch for a private state per
    query-tile block (P x N each) only when S spans more than one chunk; a
    null pointer otherwise, and on the other routes (here ``mma_sync``,
    which an unaligned view of x selects)."""
    monkeypatch.setattr(SS.ssd_scan, "launches", 0)
    monkeypatch.setattr(SS.ssd_scan, "route_launches", dict.fromkeys(SS.ROUTES, 0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, s, 3, 16), generator=g).bfloat16()
    a = torch.rand((2, s, 3), generator=g)
    B = torch.randn((2, s, 8), generator=g).bfloat16()
    seen = []
    entry = lambda *args: seen.append(args) or 0
    for xs in (x, _unaligned(x)):
        SS._launch(entry, xs, a, B, B.clone(), chunk, None)
    assert SS.ssd_scan.route_launches == {"cuda_cores": 0, "mma_sync": 1, "wgmma": 1, "tf32x3": 0}
    want = 2 * 3 * tiles * 16 * 8
    assert SS._scratch_floats(2, s, 3, 16, 8, chunk) == want
    assert (seen[0][6] != 0) == (want > 0) and seen[1][6] == 0


@pytest.mark.parametrize("mod", [FA, SS], ids=["flash_attention", "ssd_scan"])
def test_failed_launch_counts_nothing(mod, monkeypatch):
    fn = _wrapper(mod)
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "route_launches", dict.fromkeys(mod.ROUTES, 0))
    ops = _operands(mod, torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _launch(mod, lambda *a: 1, ops)
    assert fn.launches == 0 and set(fn.route_launches.values()) == {0}
