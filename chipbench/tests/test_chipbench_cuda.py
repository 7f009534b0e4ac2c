"""On the card: the control (the reference in float8 products) fails the
one-shot cell's limits at the cell's own size, while the program passes
them; a tiny hybrid's one-shot cell passes its check on the kernels.
Marked ``cuda``; without a card it skips (decided inside the test)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
def test_control_fails_the_oneshot_limits():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from chipbench import control, run, spec
    run.setup_env()
    cell = "mamba2-2.7b.oneshot_tab3"
    limits = spec.load_cell(cell)["check"]["limits"]
    got = control.measure(cell, [977], {977}, 2.0, 3.0)
    prog, ctrl = got["program"][977], got["control"][977]
    assert all(prog[k] <= v for k, v in limits.items())
    assert any(ctrl[k] > v for k, v in limits.items())


@pytest.mark.cuda
def test_tiny_hybrid_oneshot_on_the_float32_kernels(tmp_path):
    """A hybrid written in files only (SSM and attention layers, MLPs and
    MoEs) runs its one-shot cell on the card with K2 and K3 on their float32
    route in one model, and its check passes."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from chipbench import run
    from chipbench.tests import _tiny
    run.setup_env()
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    k2, k3 = flash_attention.route_launches["tf32x3"], ssd_scan.route_launches["tf32x3"]
    res = _tiny.run("tiny-hybrid.oneshot", _tiny.write(tmp_path), device="cuda")
    assert res["correct"], res["check"]
    assert res["device"]["kind"] == torch.cuda.get_device_name()
    assert flash_attention.route_launches["tf32x3"] > k2
    assert ssd_scan.route_launches["tf32x3"] > k3
