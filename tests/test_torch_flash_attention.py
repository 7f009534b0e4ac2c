"""Kernel K2 (flash attention): the port's wrapper on CPU tensors (its plain
version) against the JAX package's Pallas kernel run in interpret mode, over
the shapes of the JAX kernel tests, a cross-attention case with Sq != Sk and
an MQA case at gemma's head dim 256. The CUDA kernel itself runs only on the
card (``tests/test_torch_cuda.py``); here its binding and its operand checks
are held to the C source.

Tolerance: the JAX kernel tests' own (rtol = atol = 2e-5 in float32, 2e-2
in bfloat16: the two frameworks sum the logits and the PV product in other
orders, and round the bf16 output at other places)."""
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as R_ops
from repro_torch.kernels import flash_attention as K
from repro_torch.kernels import ops as P_ops

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, b, sq, sk, h, kv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, sk, kv, d).astype(np.float32),
            rng.randn(b, sk, kv, d).astype(np.float32))


def _run_both(q, k, v, dtype, **kw):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = R_ops.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                 blk_q=32, blk_k=32, interpret=True, **kw)
    got = P_ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), **kw)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,d,causal,window", [
    (2, 64, 4, 4, 32, True, 0),
    (1, 128, 8, 2, 64, True, 0),     # GQA
    (2, 96, 4, 1, 32, True, 0),      # MQA + padded seq (96 % 64)
    (1, 64, 4, 4, 32, False, 0),     # bidirectional (diffusion mode)
    (1, 128, 4, 2, 32, True, 32),    # sliding window
])
def test_flash_attention_matches_pallas_interpret(b, s, h, kv, d, causal, window, dtype):
    q, k, v = _inputs(b + s + h + d, b, s, s, h, kv, d)
    got, want = _run_both(q, k, v, dtype, causal=causal, window=window)
    np.testing.assert_allclose(got, want, **_tol(dtype))


@pytest.mark.parametrize("sq,sk,window", [(5, 40, 0), (40, 5, 0), (24, 72, 16)])
def test_cross_attention_offsets_queries(sq, sk, window):
    """Sq != Sk: query positions offset by Sk - Sq (the last query sees the
    last key), causal, with and without a window."""
    q, k, v = _inputs(sq * 100 + sk, 2, sq, sk, 4, 2, 32)
    got, want = _run_both(q, k, v, "float32", causal=True, window=window)
    np.testing.assert_allclose(got, want, **_tol("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mqa_at_head_dim_256(dtype):
    """gemma-2b's attention: 8 query heads on one KV head of 256, bidirectional."""
    q, k, v = _inputs(7, 2, 48, 48, 8, 1, 256)
    got, want = _run_both(q, k, v, dtype, causal=False)
    np.testing.assert_allclose(got, want, **_tol(dtype))


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 1, 16, 16, 2, 1, 32))
    before = K.flash_attention.launches
    P_ops.flash_attention(q, k, v, causal=False)
    assert K.flash_attention.launches == before
    with pytest.raises(ValueError, match="one device"):
        P_ops.flash_attention(q, k.to("meta"), v)


def test_binding_matches_the_c_entry_point():
    """ARGTYPES has one ctypes type per parameter of flash_attention_fwd, in
    order: pointers and the stream as c_void_p, ints as c_int."""
    src = (CSRC / "flash_attention.cu").read_text()
    params = re.search(r'extern "C" int flash_attention_fwd\((.*?)\)', src, re.S).group(1)
    want = [ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.split()[0] == "float" else ctypes.c_int
            for p in params.split(",")]
    assert K.ARGTYPES == want


@pytest.mark.parametrize("bad,err", [
    (dict(q=torch.zeros(1, 8, 2, 48)), "head dim"),
    (dict(k=torch.zeros(1, 8, 3, 32), v=torch.zeros(1, 8, 3, 32)), "H % KV"),
    (dict(q=torch.zeros(1, 8, 2, 32, dtype=torch.float64)), "float32"),
    (dict(q=torch.zeros(1, 8, 2, 32, dtype=torch.float16), k=torch.zeros(
        1, 8, 1, 32, dtype=torch.float16), v=torch.zeros(1, 8, 1, 32, dtype=torch.float16)),
     "float32 or bfloat16"),
    (dict(v=torch.zeros(1, 9, 1, 32)), "need q"),
    (dict(q=torch.zeros(1, 2, 8, 32).transpose(1, 2)), "contiguous"),
])
def test_kernel_operand_checks(bad, err):
    ops = dict(q=torch.zeros(1, 8, 2, 32), k=torch.zeros(1, 8, 1, 32),
               v=torch.zeros(1, 8, 1, 32))
    ops.update(bad)
    with pytest.raises((TypeError, ValueError), match=err):
        K._check(ops["q"], ops["k"], ops["v"], 0)
