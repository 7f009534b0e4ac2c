"""Thread-aware metrics registry: counters, gauges, histograms (a copy of
``repro.obs.metrics``).

Design constraints (these are serving-hot-path objects):

* **Lock-free fast path.** ``Counter.inc`` / ``Gauge.set`` /
  ``Histogram.observe`` take no lock: each metric has ONE designated writer
  in the serving stack (the scheduler thread), so a plain read-modify-write
  under the GIL is race-free there. The few multi-writer sites (transport
  threads counting submits/sheds) already hold the driver's submit lock and
  increment inside it. Registration (``counter()``/``gauge()``/
  ``histogram()``) is the only locked operation -- it happens at
  construction time, never per step.
* **Consistent-enough snapshots.** ``snapshot()`` reads each metric's value
  without stopping writers: every individual value is a coherent Python
  object read, but values of *different* metrics may straddle a concurrent
  update (torn across metrics, never within one). For serving dashboards
  and the bench recorder that is the right trade -- a snapshot must never
  stall the scheduler.
* **Fixed histogram bucket edges.** Buckets are chosen at registration
  (``edges`` ascending, in seconds for the serving defaults) and never
  reshaped, so ``observe`` is a bisect + two adds and the Prometheus
  rendering is cumulative-by-construction.

Metric naming follows Prometheus conventions (``*_total`` counters,
``*_seconds`` histograms); the catalog the serving stack registers is
documented in ``docs/observability.md``.
"""
from __future__ import annotations

import bisect
import threading
from typing import Iterable, Optional

# default edges for serving latency-ish histograms (seconds): spans cold
# compiles (10s+) down to sub-ms scheduler work
DEFAULT_TIME_EDGES = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                      1.0, 2.5, 5.0, 10.0, 30.0)


class Counter:
    """Monotonic counter. ``inc`` is the lock-free fast path; ``reset`` is a
    test/benchmark affordance (warm-pass measurement re-zeroes engine
    counters) and intentionally NOT part of the Prometheus contract."""

    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self._value += v

    @property
    def value(self) -> float:
        return self._value

    def reset(self, v: float = 0.0) -> None:
        self._value = float(v)


class Gauge:
    """Last-write-wins instantaneous value (queue depth, occupancy)."""

    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self._value += v

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram: ``observe`` is bisect + two adds.

    ``edges`` are the ascending upper bounds of the finite buckets; an
    implicit ``+Inf`` bucket catches the tail. Counts are stored
    per-bucket (not cumulative) and cumulated at render time, so the hot
    path touches exactly one bucket slot."""

    __slots__ = ("name", "help", "edges", "_counts", "_sum", "_count")

    def __init__(self, name: str, help: str = "",
                 edges: Iterable[float] = DEFAULT_TIME_EDGES):
        edges = tuple(float(e) for e in edges)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram edges must be strictly ascending "
                             f"and non-empty, got {edges!r}")
        self.name, self.help, self.edges = name, help, edges
        self._counts = [0] * (len(edges) + 1)   # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        self._counts[bisect.bisect_left(self.edges, v)] += 1
        self._sum += v
        self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def counts(self) -> list[int]:
        """Per-bucket (not cumulative) counts, +Inf bucket last. A copy."""
        return list(self._counts)

    def cumulative(self) -> list[int]:
        """Cumulative bucket counts aligned with ``edges`` + the +Inf tail
        (the Prometheus ``le`` series)."""
        out, acc = [], 0
        for c in self._counts:
            acc += c
            out.append(acc)
        return out

    def reset(self) -> None:
        self._counts = [0] * (len(self.edges) + 1)
        self._sum = 0.0
        self._count = 0


class MetricsRegistry:
    """A named set of metrics with idempotent registration.

    ``counter(name)`` etc. return the existing metric when the name is
    already registered (so independent call sites can share one series)
    and raise if the name is bound to a different metric type. All
    registration goes through one lock; reads and the per-metric fast
    paths never touch it.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name: str, *args, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args, **kw)
                self._metrics[name] = m
            elif type(m) is not cls:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  edges: Iterable[float] = DEFAULT_TIME_EDGES) -> Histogram:
        return self._register(Histogram, name, help, edges)

    def get(self, name: str) -> Optional[object]:
        # repro: allow[RL003] GIL-atomic dict read; registration is the only writer
        return self._metrics.get(name)

    def __contains__(self, name: str) -> bool:
        # repro: allow[RL003] GIL-atomic membership test, same contract as get()
        return name in self._metrics

    def __iter__(self):
        # snapshot the dict under the lock; iteration itself is lock-free
        with self._lock:
            items = list(self._metrics.values())
        return iter(items)

    def snapshot(self) -> dict:
        """Plain-data view of every metric (JSON-ready).

        Counters/gauges map to floats; histograms to
        ``{"edges", "counts", "sum", "count"}`` with per-bucket (not
        cumulative) counts. Each metric's value is read coherently;
        different metrics may straddle a concurrent update (see module
        docstring)."""
        out: dict = {}
        for m in self:
            if isinstance(m, Histogram):
                out[m.name] = {"edges": list(m.edges),
                               "counts": list(m._counts),
                               "sum": m._sum, "count": m._count}
            else:
                out[m.name] = m.value
        return out
