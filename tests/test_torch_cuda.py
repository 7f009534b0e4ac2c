"""Tests of the port that need the CUDA card: the Triton kernel against its
plain version, and a stacked fused solve through the kernel. They import
only torch and the port, so they run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card they skip. Tolerance: float32 rtol = atol = 1e-6 (FMA
contraction and summation order); stacked rows are held bitwise."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import deis_step as K  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Triton kernel runs only on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("R,m,d", [(1, 70, 33), (3, 70, 33), (8, 256, 2048)])
@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_triton_fused_ab_step_matches_plain(cuda, r, R, m, d):
    g = torch.Generator(device=cuda).manual_seed(r * 100 + R)
    n = lambda *s: torch.randn(s, generator=g, device=cuda)
    x, hist, psi, C = n(R, m, d), n(r, R, m, d), torch.rand(R, device=cuda) + 0.5, n(R, r)
    kw = dict(s=torch.rand(R, device=cuda) * 0.2, noise=n(R, m, d), err_coeffs=n(R, r) * 0.1)
    before = K.fused_ab_step.launches
    out, err = K.fused_ab_step(x, hist, psi, C, **kw)
    assert K.fused_ab_step.launches == before + 1
    want, want_err = ref.fused_ab_step_ref(x, hist, psi, C, **kw)
    torch.testing.assert_close(out, want, **TOL)
    torch.testing.assert_close(err, want_err, **TOL)
    for i in range(R):
        sl = slice(i, i + 1)
        o_i, e_i = K.fused_ab_step(x[sl].contiguous(), hist[:, sl].contiguous(), psi[sl],
                                   C[sl], **{k: v[sl] for k, v in kw.items()})
        assert torch.equal(o_i[0], out[i]) and torch.equal(e_i[0], err[i])


def test_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(2, 4, 4, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        K.fused_ab_step(x, torch.zeros(1, 2, 4, 4, device=cuda, dtype=torch.float64),
                        torch.zeros(2, device=cuda), torch.zeros(2, 1, device=cuda))
    x = torch.zeros(2, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_ab_step(x, torch.zeros(1, 4, 2, 4, device=cuda).transpose(1, 2),
                        torch.zeros(2, device=cuda), torch.zeros(2, 1, device=cuda))
