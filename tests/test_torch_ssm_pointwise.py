"""The SSM mixer's two pointwise passes (``kernels/ssm_pointwise.py``) on
the CPU: each plain version bitwise equal to the eager chain it replaced in
``ssm_forward`` (kept here as the oracle), the wrappers' operand checks,
the launch counters untouched by a CPU call, the conv state of the kernel
route, and the ctypes bindings against the C entry points. The CUDA
kernels run only on the card (``tests/test_torch_cuda.py``)."""
import ctypes
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ssm_pointwise as SP
from repro_torch.models.ssm import ssm_dims

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
WIDTHS = {"full": get_config("mamba2_2p7b"), "reduced": get_config("mamba2_2p7b").reduced()}


def _old_pre(xbc, dt, w, b, dt_bias, A_log, h, p, n):
    """``ssm_forward``'s ``pre`` as it stood before the passes: the decay,
    the causal convolution, the split and K3's contiguous operands."""
    f32 = torch.float32
    bsz, s, _ = xbc.shape
    dt = F.softplus(dt.to(f32) + dt_bias)
    a = torch.exp(dt * -torch.exp(A_log))
    k = w.shape[0]
    xp = F.pad(xbc, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    out = out + b
    state = xp[:, -(k - 1):] if k > 1 else None
    xbc = F.silu(out.to(f32)).to(xbc.dtype)
    xs, B, C = torch.split(xbc, [h * p, n, n], dim=-1)
    xh = xs.reshape(bsz, s, h, p)
    return (xh.contiguous(), B.contiguous(), C.contiguous(), a.contiguous()), state


def _old_post(y, xh, z, D, norm_scale, eps, out_dtype):
    """``ssm_forward``'s ``post`` as it stood before the passes."""
    f32 = torch.float32
    bsz, s, h, p = xh.shape
    y = y + D[None, None, :, None] * xh.to(f32)
    y = y.reshape(bsz, s, h * p)
    y = y * torch.rsqrt(y.square().mean(dim=-1, keepdim=True) + eps)
    y = y * (1.0 + norm_scale.to(f32))
    y = y * F.silu(z.to(f32))
    return y.to(out_dtype)


def _operands(cfg, s, k, dtype, bsz=2, seed=0):
    """The in-projection's output (Bb, S, 2 d_inner + 2N + H) and the
    mixer's parameters, drawn from a seed; z, xbc and dt are its views."""
    d_inner, h = ssm_dims(cfg)
    n, p = cfg.ssm.state_dim, cfg.ssm.head_dim
    c = d_inner + 2 * n
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g)
    zx = rnd(bsz, s, 2 * d_inner + 2 * n + h).to(dtype)
    z, xbc, dt = torch.split(zx, [d_inner, c, h], dim=-1)
    prm = dict(conv_w=(rnd(k, c) * 0.3).to(dtype), conv_b=(rnd(c) * 0.1).to(dtype),
               dt_bias=rnd(h), A_log=rnd(h) * 0.5, D=rnd(h),
               norm_scale=(rnd(d_inner) * 0.1).to(dtype))
    return z, xbc, dt, prm, (h, p, n)


@pytest.mark.parametrize("widths", ["full", "reduced"])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("s", [1, 2, 5, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_equal_the_old_chain_bitwise(dtype, s, k, widths):
    cfg = WIDTHS[widths]
    bsz = 1 if widths == "full" else 2
    z, xbc, dt, prm, (h, p, n) = _operands(cfg, s, k, dtype, bsz=bsz, seed=s + k)
    args = (prm["conv_w"], prm["conv_b"], prm["dt_bias"], prm["A_log"])
    got = ops.ssm_conv_prep(xbc, dt, *args, head_dim=p)
    want, state = _old_pre(xbc, dt, *args, h, p, n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g, w)
    tail = SP.conv_tail(xbc, k)
    assert (tail is None) == (state is None)
    if state is not None:
        assert torch.equal(tail, state)
    xh = got[0]
    y = torch.randn(xh.shape, generator=torch.Generator().manual_seed(s)).to(dtype)
    out = ops.ssm_gated_norm(y, xh, z, prm["D"], prm["norm_scale"], eps=cfg.norm_eps)
    old = _old_post(y, xh, z, prm["D"], prm["norm_scale"], cfg.norm_eps, dtype)
    assert out.dtype == dtype and torch.equal(out, old)
    # the plain route's float32 y (ssd_chunked) through the same plain version
    y32 = y.float()
    assert torch.equal(SP.gated_norm_ref(y32, xh, z, prm["D"], prm["norm_scale"],
                                         cfg.norm_eps),
                       _old_post(y32, xh, z, prm["D"], prm["norm_scale"], cfg.norm_eps, dtype))


def test_cpu_calls_leave_the_launch_counters():
    cfg = WIDTHS["reduced"]
    z, xbc, dt, prm, (h, p, n) = _operands(cfg, 8, 4, torch.float32)
    before = (SP.conv_prep.launches, SP.gated_norm.launches)
    xh, _, _, _ = ops.ssm_conv_prep(xbc, dt, prm["conv_w"], prm["conv_b"], prm["dt_bias"],
                                    prm["A_log"], head_dim=p)
    ops.ssm_gated_norm(xh, xh, z, prm["D"], prm["norm_scale"], eps=1e-5)
    assert (SP.conv_prep.launches, SP.gated_norm.launches) == before


def _pre_ops():
    cfg = WIDTHS["reduced"]
    z, xbc, dt, prm, (h, p, n) = _operands(cfg, 8, 4, torch.float32)
    return dict(xbc=xbc, dt=dt, conv_w=prm["conv_w"], conv_b=prm["conv_b"],
                dt_bias=prm["dt_bias"], A_log=prm["A_log"], head_dim=p)


def _post_ops():
    cfg = WIDTHS["reduced"]
    z, xbc, dt, prm, (h, p, n) = _operands(cfg, 8, 4, torch.float32)
    xh = torch.zeros(2, 8, h, p)
    return dict(y=xh.clone(), xh=xh, z=z, D=prm["D"], norm_scale=prm["norm_scale"])


@pytest.mark.parametrize("bad,err", [
    (lambda o: dict(xbc=o["xbc"].double()), "float32 or bfloat16"),
    (lambda o: dict(conv_w=o["conv_w"].bfloat16()), "one dtype"),
    (lambda o: dict(A_log=o["A_log"].bfloat16()), "must be float32"),
    (lambda o: dict(dt=o["dt"][:, :4]), r"need xbc \(Bb, S, C\)"),
    (lambda o: dict(head_dim=o["head_dim"] + 1), "not d_inner"),
    (lambda o: dict(conv_w=torch.zeros(5, o["xbc"].shape[-1])), "K in 1..4"),
    (lambda o: dict(conv_b=o["conv_b"][1:]), "need conv_b"),
    (lambda o: dict(dt_bias=o["dt_bias"][1:]), "dt_bias and A_log"),
    (lambda o: dict(xbc=torch.zeros(*o["xbc"].shape[:2], 2 * o["xbc"].shape[2])[..., ::2]),
     "unit channel stride"),
    (lambda o: dict(conv_w=o["conv_w"].t().contiguous().t()), "conv_w must be contiguous"),
])
def test_conv_prep_operand_checks(bad, err):
    o = _pre_ops()
    o.update(bad(o))
    with pytest.raises((TypeError, ValueError), match=err):
        SP._check_conv_prep(o["xbc"], o["dt"], o["conv_w"], o["conv_b"], o["dt_bias"],
                            o["A_log"], o["head_dim"])


@pytest.mark.parametrize("bad,err", [
    (lambda o: dict(y=o["y"].double(), xh=o["xh"].double(), z=o["z"].double(),
                    norm_scale=o["norm_scale"].double()), "float32 or bfloat16"),
    (lambda o: dict(y=o["y"].bfloat16()), "one dtype"),
    (lambda o: dict(D=o["D"].bfloat16()), "D must be float32"),
    (lambda o: dict(y=o["y"][:, :4]), r"need y and xh"),
    (lambda o: dict(z=o["z"][..., 1:]), r"need z"),
    (lambda o: dict(norm_scale=o["norm_scale"][1:]), r"need z"),
    (lambda o: dict(y=torch.zeros(1, 1, 2, 8193), xh=torch.zeros(1, 1, 2, 8193),
                    z=torch.zeros(1, 1, 16386), D=torch.zeros(2),
                    norm_scale=torch.zeros(16386)), "d_inner up to"),
    (lambda o: dict(z=torch.zeros(*o["z"].shape[:2], 2 * o["z"].shape[2])[..., ::2]),
     "unit channel stride"),
    (lambda o: dict(y=o["y"].transpose(0, 1).contiguous().transpose(0, 1)),
     "y must be contiguous"),
])
def test_gated_norm_operand_checks(bad, err):
    o = _post_ops()
    o.update(bad(o))
    with pytest.raises((TypeError, ValueError), match=err):
        SP._check_gated_norm(o["y"], o["xh"], o["z"], o["D"], o["norm_scale"])


def test_plain_route_skips_only_the_layout_checks():
    """On the CPU the wrappers check dtypes and shapes, not strides: the
    plain versions take any layout."""
    o = _post_ops()
    y = o["y"].transpose(0, 1).contiguous().transpose(0, 1)
    out = ops.ssm_gated_norm(y, o["xh"], o["z"], o["D"], o["norm_scale"], eps=1e-5)
    assert out.shape == o["z"].shape
    with pytest.raises(TypeError, match="one dtype"):
        ops.ssm_gated_norm(y.bfloat16(), o["xh"], o["z"], o["D"], o["norm_scale"], eps=1e-5)


@pytest.mark.parametrize("which", ["conv_prep", "gated_norm"])
def test_wrappers_reject_operands_on_two_devices(which):
    if which == "conv_prep":
        o = _pre_ops()
        o["dt_bias"] = o["dt_bias"].to("meta")
        with pytest.raises(ValueError, match="one device"):
            ops.ssm_conv_prep(o["xbc"], o["dt"], o["conv_w"], o["conv_b"], o["dt_bias"],
                              o["A_log"], head_dim=o["head_dim"])
    else:
        o = _post_ops()
        o["D"] = o["D"].to("meta")
        with pytest.raises(ValueError, match="one device"):
            ops.ssm_gated_norm(o["y"], o["xh"], o["z"], o["D"], o["norm_scale"], eps=1e-5)


@pytest.mark.parametrize("symbol,argtypes", [("ssm_conv_prep", SP.CONV_ARGTYPES),
                                             ("ssm_gated_norm", SP.NORM_ARGTYPES)])
def test_bindings_match_the_c_entry_points(symbol, argtypes):
    src = (CSRC / "ssm_pointwise.cu").read_text()
    params = re.search(rf'extern "C" int {symbol}\((.*?)\)', src, re.S).group(1).split(",")
    kinds = {"*": ctypes.c_void_p, "long long": ctypes.c_longlong, "float": ctypes.c_float,
             "int": ctypes.c_int}
    want = [next(t for key, t in kinds.items() if key in p) for p in params]
    assert argtypes == want


def test_kernel_names_stay_out_of_k1_and_k3_patterns():
    """The benchmark reads K1's and K3's rooflines by kernel name
    (``fused_ab_kernel``, ``ssd_scan``): the passes' kernels match neither."""
    src = (CSRC / "ssm_pointwise.cu").read_text()
    kernels = re.findall(r"__global__ void (?:__launch_bounds__\(\w+\) )?(\w+)", src)
    assert kernels == ["ssm_conv_prep_kernel", "ssm_gated_norm_kernel"]
    assert not any(re.search(r"fused_ab_kernel|ssd_scan", k) for k in kernels)
