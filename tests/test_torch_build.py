"""The port's CUDA build module on the CPU: a missing nvcc raises (nothing
falls back), and ``build.entry`` binds a C entry point once, with the
wrapper's argument types and an int result; a library's name follows its source
and the shared headers."""
import ctypes
import types

import pytest

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ssd_scan as SS


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_bound", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.entry("ssd_scan", "ssd_scan_fwd", SS.ARGTYPES)


def test_entry_binds_once(monkeypatch):
    lib = types.SimpleNamespace(flash_attention_fwd=types.SimpleNamespace())
    loads = []
    monkeypatch.setattr(build, "load", lambda name, defines=(): loads.append(name) or lib)
    monkeypatch.setattr(build, "_bound", {})
    fn = build.entry("flash_attention", "flash_attention_fwd", FA.ARGTYPES)
    assert build.entry("flash_attention", "flash_attention_fwd", FA.ARGTYPES) is fn
    assert loads == ["flash_attention"]
    assert fn.argtypes == FA.ARGTYPES and fn.restype is ctypes.c_int


def test_library_path_follows_the_shared_headers(monkeypatch, tmp_path):
    """An edit to a shared header (``csrc/*.cuh``, the inline PTX) gives
    every source a new library name, so no stale build is loaded."""
    for src in build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build.library_path(n) for n in ("flash_attention", "ssd_scan")}
    assert before == {n: build.library_path(n) for n in before}
    (tmp_path / "ptx.cuh").write_text((tmp_path / "ptx.cuh").read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)


def test_macro_variants_build_beside_the_main_library(monkeypatch, tmp_path):
    """A build with ``-D`` macros (the rings' diagnostic build) gets a
    library and a log of its own, keyed by the macros; the main build's
    names do not change."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    main = build.library_path("ssd_scan")
    diag = build.library_path("ssd_scan", ("RING_DIAG",))
    delay = build.library_path("ssd_scan", ("RING_DIAG", "RING_DIAG_DELAY_NS=4000"))
    assert len({main, diag, delay}) == 3
    assert main.name.startswith("libssd_scan-") and diag.name.startswith("libssd_scan-")
    assert build.log_path("ssd_scan") == tmp_path / "ssd_scan.log"
    assert build.log_path("ssd_scan", ("RING_DIAG",)) != build.log_path("ssd_scan")
    assert "-DRING_DIAG" in build._flags(("RING_DIAG",)) and build._flags() == build.FLAGS
