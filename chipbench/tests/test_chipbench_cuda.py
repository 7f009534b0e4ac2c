"""On the card: the control (the reference in float8 products) fails the
one-shot cell's limits at the cell's own size, while the program passes
them. Marked ``cuda``; without a card it skips (decided inside the test)."""
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
