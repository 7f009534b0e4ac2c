"""The PyTorch port stands alone: no file of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX, jaxlib or anything of the JAX package
``repro`` (the machine with the card has no JAX). An AST walk, so a guarded
or function-local import is caught too. ``torch.testing._internal`` (the
dry runs' fake process group) is torch's own."""
import ast
import sys
from pathlib import Path

import jax  # noqa: F401  (the port's test files all import both frameworks)
import pytest
import torch  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_has_the_slice_modules():
    pkg = ROOT / "src" / "repro_torch"
    for rel in ("configs/base.py", "configs/gemma_2b.py", "core/sde.py",
                "core/schedules.py", "core/coeffs.py", "core/plan.py",
                "core/adaptive.py", "core/sampler.py", "kernels/runtime.py",
                "kernels/ref.py", "kernels/deis_step.py", "kernels/ops.py",
                "kernels/build.py", "kernels/flash_attention.py",
                "kernels/ssd_scan.py", "kernels/csrc/flash_attention.cu",
                "kernels/csrc/ssd_scan.cu", "kernels/csrc/ptx.cuh", "configs/mamba2_2p7b.py",
                "models/layers.py", "models/transformer.py", "models/convert.py",
                "models/ssm.py", "diffusion/lm.py", "obs/metrics.py",
                "obs/trace.py", "obs/export.py", "serving/engine.py",
                "serving/driver.py", "configs/h2o_danube_3_4b.py",
                "training/steps.py", "training/checkpoint.py", "launch/serve.py",
                "configs/mixtral_8x7b.py", "configs/grok_1_314b.py",
                "configs/jamba_1p5_large.py", "configs/whisper_tiny.py",
                "configs/paligemma_3b.py", "configs/glm4_9b.py",
                "configs/granite_3_8b.py", "configs/cifar10_scorenet.py",
                "configs/granite_4p0_h_small.py",
                "training/optimizer.py", "data/pipeline.py", "launch/train.py",
                "diffusion/analytic.py", "diffusion/score_net.py",
                "core/likelihood.py", "core/matrix_sde.py", "launch/mesh.py",
                "sharding/__init__.py", "sharding/rules.py",
                "sharding/expert_parallel.py", "sharding/tensor_parallel.py",
                "launch/dryrun.py", "launch/hillclimb.py", "core/solvers.py",
                "obs/bench.py", "analysis/__init__.py", "analysis/__main__.py",
                "analysis/base.py", "analysis/config.py", "analysis/host_sync.py",
                "analysis/recompile.py", "analysis/locks.py", "analysis/plan_leaves.py",
                "analysis/kernel_routing.py", "analysis/cli.py"):
        assert (pkg / rel).is_file(), rel


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    roots = set(_imported_roots(ast.parse(path.read_text(), str(path))))
    bad = sorted(r for r in roots if r in FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_analyzer_imports_only_the_standard_library():
    """``repro_torch.analysis`` parses source and imports none of it: the
    standard library, its own modules and ``repro_torch.obs.bench`` only
    (no torch, numpy, JAX or reference module)."""
    allowed = set(sys.stdlib_module_names) | {"repro_torch"}
    for path in sorted((ROOT / "src" / "repro_torch" / "analysis").glob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        roots = set(_imported_roots(tree))
        assert roots <= allowed, f"{path.name} imports {sorted(roots - allowed)}"
        port = {(n.module, a.name) for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.level == 0
                and (n.module or "").startswith("repro_torch") for a in n.names}
        assert port <= {("repro_torch.obs", "bench")}, f"{path.name} imports {sorted(port)}"
