"""The frozen coefficient quadrature equals the port's plans today, and the
float32 reference agrees with the port's plain route at a tiny size (the
reference imports nothing of the program; only this test holds them side
by side)."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chipbench.reference import model as R  # noqa: E402
from chipbench.reference import quadrature as Q  # noqa: E402
from chipbench.tests import _tiny  # noqa: E402


@pytest.mark.parametrize("solver", Q.SOLVERS)
@pytest.mark.parametrize("nfe", [6, 10, 20])
def test_frozen_plans_equal_the_ports(solver, nfe):
    from repro_torch.core import VPSDE, get_timesteps, make_plan, solver_stages
    sde = VPSDE()
    assert Q.stages(solver) == solver_stages(solver)
    ts = get_timesteps(sde, max(1, nfe // solver_stages(solver)))
    port = make_plan(solver, sde, ts)
    mine = Q.make_plan(solver, nfe)
    assert np.allclose(mine["ts"], port.ts.numpy(), rtol=0, atol=1e-15)
    assert mine["method"] == port.method and mine["stochastic"] == port.stochastic
    assert mine["nfe"] == port.nfe
    for key, val in port.coeffs.items():
        np.testing.assert_allclose(np.broadcast_to(mine[key], val.shape), val.numpy(),
                                   rtol=1e-12, atol=1e-14, err_msg=key)


@pytest.mark.parametrize("config", ["tiny-moe", "tiny-dense", "tiny-ssm", "tiny-hybrid"])
def test_reference_forward_matches_the_plain_route(config):
    from repro_torch.configs.base import config_from_dict
    from repro_torch.models import transformer as T
    from chipbench import weights as W
    m = _tiny.CONFIGS[config]["model"]
    w = W.make(m, 3, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 12, m["d_model"]), generator=gen)
    t = torch.tensor([0.3, 0.8])
    vl = torch.tensor([12, 9])
    want = T.forward(w, config_from_dict(m), embeds=x, t_cond=t, causal=False,
                     valid_len=vl, logits=False)["eps"]
    got = R.Net(w, m)(x, t, vl)
    if config == "tiny-moe":      # padded rows' outputs are the program's business
        got, want = got[:, :9], want[:, :9]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_control_rounds_coarser_than_bf16():
    t = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    e8 = (R._round(t, "fp8") - t).abs().mean()
    e16 = (R._round(t, "bf16") - t).abs().mean()
    assert R._round(t, "fp32") is t and e8 > 8 * e16 > 0
