"""Metrics export: the port's Prometheus text and NDJSON lines against the
JAX package's ``repro.obs.export`` for registries filled the same way.
Exact equality of the text (the NDJSON ``ts`` wall-clock field stripped)."""
import json

import jax  # noqa: F401  (the port's test files all import both frameworks)
import pytest

from repro.obs import export as RE
from repro.obs.metrics import MetricsRegistry as RefRegistry
from repro_torch.obs import export as PE
from repro_torch.obs.metrics import MetricsRegistry


def _fill(reg):
    c = reg.counter("serve_completed_total", help="requests finished")
    c.inc()
    c.inc(2.5)
    reg.counter("driver_shed_total", help="shed").inc(0)
    g = reg.gauge("serve_queue_depth", help="pending")
    g.set(7)
    g.inc(-2.25)
    h = reg.histogram("serve_solve_seconds", help="solve time")
    for v in (0.0004, 0.003, 0.02, 0.2, 0.2, 4.0, 99.0):
        h.observe(v)
    e = reg.histogram("serve_row_err", help="err", edges=(1e-6, 1e-3, 1.0))
    for v in (1e-7, 5e-4, 0.5, 2.0):
        e.observe(v)
    return reg


def _strip_ts(line):
    doc = json.loads(line)
    assert isinstance(doc.pop("ts"), float)
    return doc


def test_prometheus_text_matches_reference():
    assert PE.to_prometheus(_fill(MetricsRegistry())) == RE.to_prometheus(_fill(RefRegistry()))


def test_prometheus_empty_registry_matches_reference():
    assert PE.to_prometheus(MetricsRegistry()) == RE.to_prometheus(RefRegistry())


@pytest.mark.parametrize("extra", [None, {"arch": "gemma_2b"}])
def test_ndjson_line_matches_reference(extra):
    got = PE.to_ndjson_line(_fill(MetricsRegistry()), extra=extra)
    want = RE.to_ndjson_line(_fill(RefRegistry()), extra=extra)
    assert _strip_ts(got) == _strip_ts(want)
    # same key order and number formatting once ts is removed
    assert json.dumps(_strip_ts(got), sort_keys=True) == json.dumps(_strip_ts(want), sort_keys=True)


def test_ndjson_exporter_appends_like_reference(tmp_path):
    files = {}
    for name, mod, reg in (("port", PE, _fill(MetricsRegistry())),
                           ("ref", RE, _fill(RefRegistry()))):
        path = tmp_path / f"{name}.ndjson"
        with mod.NdjsonExporter(str(path), extra={"arch": "x"}) as ex:
            ex.write(reg)
            reg.counter("serve_completed_total").inc()
            ex.write(reg)
        with mod.NdjsonExporter(str(path)) as ex:   # a second run appends
            ex.write(reg)
        files[name] = [_strip_ts(ln) for ln in path.read_text().splitlines()]
    assert len(files["port"]) == 3
    assert files["port"] == files["ref"]
