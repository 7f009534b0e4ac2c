"""Discovery: everything the harness runs is found by name in data files.

- ``configs/<config>.json``: a model configuration (the source's sizes as
  run, ``reduced``, ``assumed``, the deployment) with the port's
  ``ModelConfig`` fields under ``model``;
- ``mixes/<mix>.json``: a traffic mix's parameters, read by
  :mod:`chipbench.traffic`;
- ``cells/<cell>.json``: a cell, naming its config and mix and the load
  (closed-loop clients) and the limits of its correctness check;
- ``metrics/<metric>.py``: the reader of a per-layer metric
  (``<name>.py``, or ``<base>.py`` for a metric ``<base>.<variant>``);
- ``reference/<arch>.py``: the reference module of an architecture, named
  by a configuration's top-level ``"arch"`` (default ``model``): its
  ``Net`` and, optionally, its ``layer_leaves`` (:mod:`chipbench.weights`)
  and ``layer_flops`` (:mod:`chipbench.flops`);
- ``BENCHMARK.json`` at the checkout's root: which end-to-end and
  per-layer metrics each cell reports.

A later change adds a configuration, architecture, mix, metric or cell by
adding files (and entries in ``BENCHMARK.json``); no file here names one.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(kind: str, name: str, base: Path = HERE) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        have = sorted(p.stem for p in (base / kind).glob("*.json"))
        raise FileNotFoundError(f"no {kind[:-1]} {name!r} (have {have})")
    return json.loads(path.read_text())


def load_cell(name: str, base: Path = HERE) -> dict:
    """The cell ``name`` with its ``config`` and ``mix`` dicts and its
    configuration's reference module (``arch_module``) resolved."""
    cell = _load("cells", name, base)
    cell["name"] = name
    cell["config_data"] = _load("configs", cell["config"], base)
    cell["mix_data"] = _load("mixes", cell["mix"], base)
    cell["arch_module"] = arch_module(cell["config_data"].get("arch", "model"), base)
    return cell


_ARCHS: dict = {}


def arch_module(name: str = "model", base: Path = HERE):
    """The reference module ``reference/<name>.py`` of an architecture, from
    ``base`` or else from the harness's own ``reference/``; it defines
    ``Net`` (``(w, m, prec)``, called ``(x, t, valid_len)``, with
    ``logits(x0)``) and may define ``layer_leaves(m, i, kinds, rnd, const)``
    and ``layer_flops(m, i, seq_len)``. Loaded once per file."""
    if not name.isidentifier():
        raise ValueError(f"reference module name {name!r} is no Python identifier")
    dirs = [base / "reference", HERE / "reference"]
    path = next((d / f"{name}.py" for d in dirs if (d / f"{name}.py").is_file()), None)
    if path is None:
        have = sorted({p.stem for d in dirs for p in d.glob("*.py")} - {"__init__"})
        raise FileNotFoundError(f"no reference module {name!r} (have {have})")
    path = path.resolve()
    if path not in _ARCHS:
        if path.parent == HERE / "reference":
            mod = importlib.import_module(f"{__package__}.reference.{name}")
        else:
            imp = importlib.util.spec_from_file_location(f"chipbench_arch_{name}", path)
            mod = importlib.util.module_from_spec(imp)
            imp.loader.exec_module(mod)
        if not hasattr(mod, "Net"):
            raise AttributeError(f"reference module {name!r} ({path}) defines no Net")
        _ARCHS[path] = mod
    return _ARCHS[path]


def names(kind: str, base: Path = HERE) -> list[str]:
    return sorted(p.stem for p in (base / kind).glob("*.json"))


def manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    return json.loads(path.read_text()) if path.is_file() else {}


def _reported(metric: dict, cell: str, e2e: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", None) in e2e if "moves" in metric else True


def cell_metrics(cell: str, default_e2e: list[str], root: Path = ROOT) -> tuple[list, list]:
    """(end-to-end names, per-layer names) the cell reports by ``BENCHMARK.json``;
    a cell it does not list reports ``default_e2e`` (what its traffic yields)
    and no per-layer metric."""
    man = manifest(root)
    if cell not in {w["name"] for w in man.get("workloads", [])}:
        return list(default_e2e), []
    e2e = [m["name"] for m in man["end_to_end"] if _reported(m, cell, set())]
    layer = [m["name"] for m in man["per_layer"] if _reported(m, cell, set(e2e))]
    return e2e, layer


def reader(metric: str, base: Path = HERE):
    """The reader module of a per-layer metric: ``metrics/<name>.py``, else
    ``metrics/<base>.py`` for ``<base>.<variant>``."""
    for stem in (metric, metric.split(".")[0]):
        path = base / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(f"chipbench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for per-layer metric {metric!r}")
