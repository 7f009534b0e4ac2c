"""Which kernel each dtype takes in K2 (flash attention) and K3 (SSD scan),
on the CPU: bf16 operands launch the tensor-core kernel and float32
operands the CUDA-core kernel of the same source, the wrapper counts each
launch on its route, and CPU tensors (the plain versions) launch nothing.
The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
here the C entry points' dtype switch is held to the wrappers' routes."""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd_scan as SS

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
DTYPES = [torch.bfloat16, torch.float32]
# per source: its C entry point, and per route the call in the entry's
# dtype switch, the launcher that call reaches and the kernel it starts
SOURCES = {
    "flash_attention": ("flash_attention_fwd", {
        "tensor_cores": ("launch_dim<true>", "launch_mma", "flash_fwd_mma_kernel"),
        "cuda_cores": ("launch_dim<false>", "launch_f32", "flash_fwd_kernel")}),
    "ssd_scan": ("ssd_scan_fwd", {
        "tensor_cores": ("launch_mma", "launch_mma", "ssd_scan_mma_kernel"),
        "cuda_cores": ("launch_f32", "launch_f32", "ssd_scan_kernel")}),
}


def _operands(mod, dtype):
    """Small CPU operands of the wrapper, in dtype."""
    g = torch.Generator().manual_seed(0)
    n = lambda *s: torch.randn(s, generator=g).to(dtype)
    if mod is FA:
        return (n(1, 8, 2, 32), n(1, 8, 1, 32), n(1, 8, 1, 32))
    return (n(1, 8, 2, 16), torch.rand((1, 8, 2), generator=g) * 0.3 + 0.7,
            n(1, 8, 4), n(1, 8, 4))


def _wrapper(mod):
    return mod.flash_attention if mod is FA else mod.ssd_scan


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_cores"),
                                         (torch.float32, "cuda_cores")])
@pytest.mark.parametrize("mod", [FA, SS], ids=["flash_attention", "ssd_scan"])
def test_dtype_takes_its_route_in_the_c_entry(mod, dtype, route):
    """The wrapper's route for a dtype is what the C entry's dtype switch
    calls for that dtype's code, and that launcher starts the route's
    kernel."""
    name = mod.__name__.rsplit(".", 1)[1]
    entry, routes = SOURCES[name]
    call, launcher, kernel = routes[route]
    assert mod.ROUTES[dtype] == route
    src = (CSRC / f"{name}.cu").read_text()
    switch = src[src.index(f'extern "C" int {entry}('):]
    assert f"case {mod._DTYPES[dtype]}: return {call}(" in switch
    body = re.search(rf"cudaError_t {launcher}\((.*?)\n}}\n", src, re.S).group(1)
    assert re.search(rf"\b{kernel}(<\w+>)?<<<", body)
    if call.startswith("launch_dim"):   # K2 picks the launcher by the template flag
        assert "MMA ? launch_mma<DIM>(" in src and ": launch_f32<DIM>(" in src


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mod", [FA, SS], ids=["flash_attention", "ssd_scan"])
def test_cpu_tensors_launch_no_route(mod, dtype):
    fn = _wrapper(mod)
    before, routes = fn.launches, dict(fn.route_launches)
    out = fn(*_operands(mod, dtype))
    assert fn.launches == before and fn.route_launches == routes
    assert set(fn.route_launches) == {"tensor_cores", "cuda_cores"}
    assert (out if mod is FA else out[0]).dtype == dtype


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mod", [FA, SS], ids=["flash_attention", "ssd_scan"])
def test_launch_counts_its_route(mod, dtype, monkeypatch):
    """``_launch`` hands the C entry the dtype's code and counts one launch,
    on the dtype's route only (a stand-in entry point on CPU tensors)."""
    fn = _wrapper(mod)
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "route_launches", dict.fromkeys(mod.ROUTES.values(), 0))
    seen = []

    def entry(*args):
        seen.append(args)
        return 0

    ops = _operands(mod, dtype)
    if mod is FA:
        mod._launch(entry, *ops, True, 0, None)
        code = seen[0][4]
    else:
        mod._launch(entry, *ops, 8, None)
        code = seen[0][6]
    assert code == mod._DTYPES[dtype]
    want = dict.fromkeys(mod.ROUTES.values(), 0)
    want[mod.ROUTES[dtype]] = 1
    assert fn.launches == 1 and fn.route_launches == want


@pytest.mark.parametrize("mod", [FA, SS], ids=["flash_attention", "ssd_scan"])
def test_failed_launch_counts_nothing(mod, monkeypatch):
    fn = _wrapper(mod)
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "route_launches", dict.fromkeys(mod.ROUTES.values(), 0))
    ops = _operands(mod, torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        if mod is FA:
            mod._launch(lambda *a: 1, *ops, True, 0, None)
        else:
            mod._launch(lambda *a: 1, *ops, 8, None)
    assert fn.launches == 0 and set(fn.route_launches.values()) == {0}
