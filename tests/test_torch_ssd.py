"""Kernel K3 (the Mamba2 SSD chunked scan) and the port's Mamba2 mixer
against the JAX package: the port's wrapper on CPU tensors (its plain
version) against the Pallas kernel in interpret mode at the shapes of the
JAX kernel tests; the port's plain chunked form ``ssd_chunked`` against the
reference's; and ``ssm_forward`` on ``mamba2_2p7b.reduced()`` with the
reference's weights, with and without the kernel route. The CUDA kernel
runs only on the card (``tests/test_torch_cuda.py``).

Tolerances: the scan as the JAX kernel tests hold it (rtol = atol = 2e-4 in
float32, 5e-2 in bfloat16); the float32 mixer at rtol = atol = 1e-5 (sum
orders of the products)."""
import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.mamba2_2p7b import get_config as ref_config
from repro.kernels import ops as R_ops
from repro.models import ssm as RS
from repro.models.transformer import init_params as ref_init
from repro_torch.configs import get_config
from repro_torch.kernels import ops as P_ops
from repro_torch.kernels import ssd_scan as K
from repro_torch.models import ssm as PS

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
F32 = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, b, s, h, p, n, lo=0.7):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, p).astype(np.float32),
            rng.uniform(lo, 0.999, (b, s, h)).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 2, 16, 8, 16),
    (1, 96, 3, 8, 16, 32),    # odd head count
    (1, 50, 2, 16, 8, 16),    # seq not a chunk multiple
    (2, 32, 1, 32, 32, 32),   # single chunk
])
def test_ssd_scan_matches_pallas_interpret(b, s, h, p, n, chunk, dtype):
    x, a, B, C = _inputs(s + h + p, b, s, h, p, n)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    y_w, st_w = R_ops.ssd_scan(jnp.asarray(x, jdt), jnp.asarray(a), jnp.asarray(B, jdt),
                               jnp.asarray(C, jdt), chunk=chunk, interpret=True)
    y, st = P_ops.ssd_scan(torch.from_numpy(x).to(tdt), torch.from_numpy(a),
                           torch.from_numpy(B).to(tdt), torch.from_numpy(C).to(tdt),
                           chunk=chunk)
    assert y.dtype == tdt and st.dtype == torch.float32 and tuple(st.shape) == (b, h, p, n)
    tol = dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" else dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(y_w, np.float32), **tol)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_w), **tol)


@pytest.mark.parametrize("s,chunk", [(64, 16), (50, 16)])
def test_ssd_chunked_matches_reference(s, chunk):
    x, a, B, C = _inputs(11 + s, 2, s, 3, 16, 8)
    y_w, st_w = RS.ssd_chunked(*map(jnp.asarray, (x, a, B, C)), chunk=chunk)
    y, st = PS.ssd_chunked(*map(torch.from_numpy, (x, a, B, C)), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_w), **F32)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_w), **F32)


def test_kernel_form_agrees_with_chunked_form():
    """The plain version of K3 against ``ssd_chunked`` (two forms of one
    function; they differ only where a underflows to 0, not here)."""
    x, a, B, C = _inputs(5, 1, 128, 2, 16, 8, lo=0.8)
    t = [torch.from_numpy(v) for v in (x, a, B, C)]
    y1, s1 = P_ops.ssd_scan(*t, chunk=32)
    y2, s2 = PS.ssd_chunked(*t, chunk=32)
    torch.testing.assert_close(y1, y2, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s1, s2, rtol=2e-4, atol=2e-4)


def _mixer_models():
    rcfg = ref_config().reduced()
    pcfg = get_config("mamba2_2p7b").reduced()
    rp = ref_init(rcfg, jax.random.PRNGKey(0))
    layer = jax.tree.map(lambda v: np.asarray(v)[0], rp["blocks"]["slot0"]["ssm"])
    return rcfg, pcfg, layer


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ssm_forward_matches_reference(use_kernels):
    rcfg, pcfg, layer = _mixer_models()
    x = np.random.RandomState(2).randn(2, 40, pcfg.d_model).astype(np.float32)
    want, want_cache = RS.ssm_forward(jax.tree.map(jnp.asarray, layer), rcfg,
                                      jnp.asarray(x), use_pallas=use_kernels)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
    got, cache = PS.ssm_forward(pp, pcfg, torch.from_numpy(x), use_kernels=use_kernels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(cache["state"].numpy(), np.asarray(want_cache["state"]), **F32)
    np.testing.assert_allclose(cache["conv"].numpy(), np.asarray(want_cache["conv"]), **F32)
    # one O(1) decode step from that cache, against the reference's
    x1 = np.random.RandomState(3).randn(2, 1, pcfg.d_model).astype(np.float32)
    want1, want_c1 = RS.ssm_forward(jax.tree.map(jnp.asarray, layer), rcfg,
                                    jnp.asarray(x1), cache=want_cache)
    got1, c1 = PS.ssm_forward(pp, pcfg, torch.from_numpy(x1), cache=cache)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **F32)
    for name in ("conv", "state"):
        np.testing.assert_allclose(c1[name].numpy(), np.asarray(want_c1[name]), **F32)


def test_ssm_dims_and_init_match_reference():
    rcfg, pcfg, layer = _mixer_models()
    assert PS.ssm_dims(pcfg) == RS.ssm_dims(rcfg)
    mine = PS.init_ssm(torch.Generator().manual_seed(0), pcfg, torch.float32, "cpu")
    assert set(mine) == set(layer)
    for k, v in layer.items():
        assert tuple(mine[k].shape) == v.shape, k
        assert str(mine[k].dtype).split(".")[1] == str(v.dtype), k
    for k in ("A_log", "dt_bias", "D", "conv_b", "norm_scale"):   # constants
        np.testing.assert_array_equal(mine[k].numpy(), layer[k])
    full = get_config("mamba2_2p7b")
    assert (full.n_layers, full.d_model, full.ssm.state_dim, full.ssm.head_dim,
            full.ssm.chunk_size, full.vocab_size) == (64, 2560, 128, 64, 256, 50280)
    assert PS.ssm_dims(full) == (5120, 80)


def test_binding_matches_the_c_entry_point():
    src = (CSRC / "ssd_scan.cu").read_text()
    params = re.search(r'extern "C" int ssd_scan_fwd\((.*?)\)', src, re.S).group(1)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params.split(",")]
    assert K.ARGTYPES == want


@pytest.mark.parametrize("bad,err", [
    (dict(x=torch.zeros(1, 8, 2, 65)), "head dim"),
    (dict(B=torch.zeros(1, 8, 129), C=torch.zeros(1, 8, 129)), "state"),
    (dict(a=torch.zeros(1, 8, 2, dtype=torch.bfloat16)), "a must be float32"),
    (dict(B=torch.zeros(1, 8, 4, dtype=torch.bfloat16)), "one dtype"),
    (dict(x=torch.zeros(1, 8, 2, 16, dtype=torch.float16), B=torch.zeros(
        1, 8, 4, dtype=torch.float16), C=torch.zeros(1, 8, 4, dtype=torch.float16)),
     "float32 or bfloat16"),
    (dict(a=torch.zeros(1, 8, 3)), "do not fit"),
    (dict(x=torch.zeros(1, 2, 8, 16).transpose(1, 2)), "contiguous"),
    (dict(x=torch.zeros(1, 300, 2, 16), a=torch.zeros(1, 300, 2), B=torch.zeros(1, 300, 4),
          C=torch.zeros(1, 300, 4), chunk=512), "chunk"),
])
def test_kernel_operand_checks(bad, err):
    ops = dict(x=torch.zeros(1, 8, 2, 16), a=torch.zeros(1, 8, 2),
               B=torch.zeros(1, 8, 4), C=torch.zeros(1, 8, 4), chunk=256)
    ops.update(bad)
    with pytest.raises((TypeError, ValueError), match=err):
        K._check(ops["x"], ops["a"], ops["B"], ops["C"], ops["chunk"])
