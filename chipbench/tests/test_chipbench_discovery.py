"""The harness finds configs, mixes, cells and readers by name, and
BENCHMARK.json agrees with the files it names."""
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from chipbench import spec  # noqa: E402
from chipbench.tests import _tiny  # noqa: E402

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves():
    for w in MAN["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell["config"] == w["config"]
        assert cell["config_data"]["name"] == w["config"]
        assert w["name"] == f"{w['config']}.{w['traffic']}"


def test_configs_match_their_files():
    for c in MAN["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in MAN["workloads"])


def test_names_units_and_keys():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [m["name"] for m in MAN[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in MAN["end_to_end"]} >= {"setup_s"}
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_reader_declares_what_benchmark_says(metric):
    m = next(x for x in MAN["per_layer"] if x["name"] == metric)
    mod = spec.reader(metric)
    variant = metric.split(".", 1)[1] if "." in metric else metric
    assert (mod.LAYER, mod.UNIT, mod.SOURCE) == (m["layer"], m["unit"], m["source"])
    moves = mod.MOVES[variant] if isinstance(mod.MOVES, dict) else mod.MOVES
    assert moves == m["moves"]
    e2e = {x["name"]: x for x in MAN["end_to_end"]}
    for cell in m["workloads"]:
        assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_every_cell_reports_what_it_must():
    for w in MAN["workloads"]:
        e2e, layer = spec.cell_metrics(w["name"], [])
        assert "setup_s" in e2e and len(e2e) >= 2 and layer


def test_dummy_cell_added_as_files(tmp_path):
    """A cell, config and mix added in another directory by files alone."""
    base = _tiny.write(tmp_path)
    assert "tiny-moe.closed" in spec.names("cells", base)
    cell = spec.load_cell("tiny-moe.closed", base)
    assert cell["config_data"]["model"]["arch_type"] == "moe"
    assert cell["mix_data"]["kind"] == "served"
    (base / "metrics" / "tiny_metric.py").write_text(
        "LAYER = 'x'\nUNIT = 'ms'\nMOVES = 'tokens_per_s'\nSOURCE = 'host_clock'\n"
        "def read(ctx):\n    return None\n")
    assert spec.reader("tiny_metric.batch", base).UNIT == "ms"
    with pytest.raises(FileNotFoundError):
        spec.load_cell("no-such.cell", base)
