"""Build the port's CUDA C++ kernels (``kernels/csrc/*.cu``) at first use and
load them with ctypes.

Each source is compiled by ``nvcc`` straight to a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a``, into ``build/kernels`` in the checkout (ignored by git). The
library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
rather than confused with an old build. ``nvcc``'s
output, with ptxas's register and shared-memory report, is kept beside the
library as ``<name>.log``. A missing ``nvcc`` or a failed compile raises:
nothing falls back to a plain version.

``defines`` (``-D`` macros) build a variant of a source beside its main
build, such as the rings' diagnostic build (``RING_DIAG``, ``csrc/ptx.cuh``)
that ``tools/kernel_stress.py --diag`` asks for; nothing on the port's
paths passes any.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}
_bound: dict[tuple[str, str, tuple[str, ...]], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME); the "
                           "port's CUDA kernels are built from source at first use")
    return path


def _flags(defines=()) -> tuple[str, ...]:
    return FLAGS + tuple(f"-D{d}" for d in defines)


def _variant(defines=()) -> str:
    """The file-name suffix of a build with these macros ("" for none)."""
    return "-" + hashlib.sha256(" ".join(defines).encode()).hexdigest()[:8] if defines else ""


def library_path(name: str, defines=()) -> Path:
    """Where ``csrc/<name>.cu`` is built to, keyed by its source, the
    shared headers and the flags."""
    text = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    text += " ".join(_flags(defines)).encode()
    return BUILD_DIR / f"lib{name}{_variant(defines)}-{hashlib.sha256(text).hexdigest()[:16]}.so"


def log_path(name: str, defines=()) -> Path:
    """nvcc's output of the last build of ``csrc/<name>.cu`` with these macros."""
    return BUILD_DIR / f"{name}{_variant(defines)}.log"


def build(names, defines=()) -> dict[str, Path]:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together; raise if any fails. Returns name -> library."""
    paths = {n: library_path(n, defines) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
    procs = {}
    for n, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(defines), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        log_path(n, defines).write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str, defines=()) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (building it first if needed)."""
    key = (name, tuple(defines))
    if key not in _loaded:
        _loaded[key] = ctypes.CDLL(str(build([name], defines)[name]))
    return _loaded[key]


def entry(name: str, symbol: str, argtypes, defines=()):
    """The C function ``symbol`` of ``csrc/<name>.cu`` (built and loaded at
    first use), bound with ``argtypes`` and an int result: the CUDA error
    of its launch."""
    key = (name, symbol, tuple(defines))
    if key not in _bound:
        fn = getattr(load(name, defines), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[key] = fn
    return _bound[key]
