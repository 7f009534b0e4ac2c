"""Render a :class:`~repro_torch.obs.metrics.MetricsRegistry` snapshot (a
copy of ``repro.obs.export``).

Two formats:

* :func:`to_prometheus` -- the Prometheus text exposition format (0.0.4):
  ``# HELP``/``# TYPE`` headers, ``_bucket{le="..."}`` cumulative series +
  ``_sum``/``_count`` for histograms. This is what the serving launcher's
  ``GET /metrics`` endpoint returns.
* :func:`to_ndjson_line` / :class:`NdjsonExporter` -- one JSON object per
  snapshot (timestamped), appended as a line to a file. NDJSON is the
  offline twin of /metrics: point a ``--metrics-ndjson PATH`` run at a file
  and every snapshot interval adds one greppable line.
"""
from __future__ import annotations

import json
import time
from typing import Optional

from .metrics import Counter, Gauge, Histogram, MetricsRegistry


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers without a trailing .0."""
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def to_prometheus(registry: MetricsRegistry) -> str:
    """Render the registry in the Prometheus text exposition format."""
    lines: list[str] = []
    for m in registry:
        if isinstance(m, Counter):
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} counter")
            lines.append(f"{m.name} {_fmt(m.value)}")
        elif isinstance(m, Gauge):
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} gauge")
            lines.append(f"{m.name} {_fmt(m.value)}")
        elif isinstance(m, Histogram):
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} histogram")
            cum = m.cumulative()
            for edge, c in zip(m.edges, cum):
                lines.append(f'{m.name}_bucket{{le="{_fmt(edge)}"}} {c}')
            lines.append(f'{m.name}_bucket{{le="+Inf"}} {cum[-1]}')
            lines.append(f"{m.name}_sum {_fmt(m.sum)}")
            lines.append(f"{m.name}_count {m.count}")
    return "\n".join(lines) + "\n"


def to_ndjson_line(registry: MetricsRegistry, *,
                   extra: Optional[dict] = None) -> str:
    """One NDJSON line: ``{"ts": <unix seconds>, "metrics": {...}}``.

    ``ts`` is wall-clock (``time.time()``) on purpose -- NDJSON lines are
    correlated with logs and dashboards across processes, where monotonic
    perf_counter origins differ. Durations INSIDE the metrics are all
    perf_counter-measured; only the snapshot label is wall-clock."""
    doc = {"ts": time.time(), "metrics": registry.snapshot()}
    if extra:
        doc.update(extra)
    return json.dumps(doc, sort_keys=True)


class NdjsonExporter:
    """Append-one-line-per-snapshot NDJSON writer.

    Opens lazily and appends, so several runs can share one trajectory
    file; ``write()`` is cheap enough to call per scrape or on a timer
    thread (one ``snapshot()`` + one buffered line)."""

    def __init__(self, path: str, *, extra: Optional[dict] = None):
        self.path = path
        self.extra = extra or {}
        self._fh = None

    def write(self, registry: MetricsRegistry) -> None:
        if self._fh is None:
            self._fh = open(self.path, "a")
        self._fh.write(to_ndjson_line(registry, extra=self.extra) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "NdjsonExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
