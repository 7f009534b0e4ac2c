"""A whole run of a tiny cell on the CPU, with the timed path sound and with
it broken underneath: the check must pass the first and fail each fault
the cell can have (one card, so no exchange between chips to leave out)."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from chipbench.tests import _tiny  # noqa: E402


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return _tiny.write(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _unchanged_state(monkeypatch):
    """A solver step that returns its state unchanged."""
    from repro_torch.core import sampler
    monkeypatch.setattr(sampler, "step", lambda plan, k, state, eps_fn, **kw: state)


def _half_batch(monkeypatch):
    """The eps-net's output kept for the first half of the rows (rounded
    down), the rest given their mean (zeros where no row is kept)."""
    from repro_torch.diffusion import lm
    real = lm.make_eps_fn

    def make(*a, **kw):
        fn = real(*a, **kw)

        def eps(x, t):
            n = x.shape[0] // 2
            out = fn(x, t)
            if n == 0:
                return torch.zeros_like(out)
            return torch.cat([out[:n], out[:n].mean(0, keepdim=True).expand_as(out[n:])])
        return eps
    monkeypatch.setattr(lm, "make_eps_fn", make)


def _altered_token(monkeypatch):
    """One token of every decode altered where it is produced."""
    from repro_torch.diffusion import lm
    real = lm.decode_tokens

    def decode(params, cfg, x0):
        out = real(params, cfg, x0).clone()
        out.view(-1)[0] = (out.view(-1)[0] + 1) % cfg.vocab_size
        return out
    monkeypatch.setattr(lm, "decode_tokens", decode)


CELLS = ["tiny-moe.closed", "tiny-ssm.closed", "tiny-ssm.oneshot", "tiny-hybrid.oneshot"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(base, cell):
    res = _tiny.run(cell, base)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "check"
    e2e = {"tokens_per_s" if cell.endswith("oneshot") else "served_tokens_per_s", "setup_s"}
    assert set(res["metrics"]) == e2e
    assert all(np.isfinite(v["value"]) and v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _altered_token])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(base, cell, fault, monkeypatch):
    fault(monkeypatch)
    res = _tiny.run(cell, base)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("cell", ["tiny-ssm.oneshot", "tiny-moe.closed"])
def test_traced_run_reads_the_window(base, cell):
    res = _tiny.run(cell, base, trace=True)
    assert res["correct"] and res["device"]["window_s"] > 0 and "breakdown" in res


@pytest.mark.parametrize("cell", ["tiny-ssm.oneshot", "tiny-moe.closed"])
def test_control_fails_the_cells_limits(base, cell):
    """The float8 control, judged by the cell's limits as a run judges the
    program, comes out as not correct where the program comes out correct."""
    from chipbench import control
    got = control.measure(cell, [2 ** 31 + 9], {2 ** 31 + 9}, 1.5, 0.5, base=base, root=base,
                          device="cpu")
    assert got["correct"] == {"program": {2 ** 31 + 9: True}, "control": {2 ** 31 + 9: False}}
