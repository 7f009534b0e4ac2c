"""No module the benchmark loads is JAX's or the JAX package's (top-level
names compared whole: the port's name begins with the JAX package's), no
reference module imports the program, and the command fails without the
program beside it."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def test_a_whole_run_loads_no_jax(tmp_path):
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from chipbench.tests import _tiny\n"
        "from pathlib import Path\n"
        "import torch; torch.set_num_threads(2)\n"
        f"res = _tiny.run('tiny-moe.closed', _tiny.write(Path({str(tmp_path)!r})), seconds=1.0)\n"
        "from chipbench import run\n"
        "print(json.dumps({'bad': run.forbidden_modules(), 'correct': res['correct'],\n"
        "                  'repro_torch': 'repro_torch' in sys.modules}))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "correct": True, "repro_torch": True}


def test_forbidden_names_compare_whole():
    sys.path.insert(0, str(ROOT))
    from chipbench import run
    assert run.FORBIDDEN == {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" not in {m.split(".")[0] for m in ["repro_torch.core"]} & run.FORBIDDEN


def test_command_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cmd = man["command"] + ["--workload", man["workloads"][0]["name"], "--seed", "1",
                            "--seconds", "1", "--trace", "0"]
    cmd[0] = sys.executable
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert not out.stdout.strip().startswith("{")


@pytest.mark.parametrize("path", sorted((ROOT / "chipbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_modules_import_nothing_of_the_program(path):
    """Every reference module (``model`` and each architecture's) is written
    from the equations: no import of the port, of JAX or of the JAX package."""
    import ast
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, names
