"""Nestable span timers for the port's host-side phases (a copy of
``repro.obs.trace`` that annotates ``torch.profiler`` traces).

A :class:`Tracer` times named spans -- engine ticks, group-step dispatch,
join/compact boundary work, the one-shot generator's phases down to the
SSM mixer's parts -- and feeds each duration into a per-span-path histogram
of a :class:`~repro_torch.obs.metrics.MetricsRegistry`. Spans nest
(``sample_tokens`` > ``sample.step`` > ``eps``); the tracer keeps a
thread-local stack so the recorded name is the dotted path of its
ancestry, which is what ``docs/observability.md`` documents as the span
hierarchy.

Two hard rules:

* spans time HOST-side work only. Kernels are launched asynchronously, so
  a span around a launch measures the launch; no span synchronises with
  the device or records a CUDA event.
* with ``annotate=True`` each span also enters a
  ``torch.profiler.record_function`` range named by its path, so the spans
  show up in a ``torch.profiler`` trace on the launching thread, and device
  time can be put down to the span open at each kernel's launch. The range
  adds no sync.

``NULL_TRACER`` is the disabled instance: its ``span()`` is a reusable
no-op context manager (no ``record_function``, no allocation), so
instrumented code never branches on "is tracing on" -- it just always runs
``with tracer.span(...):``.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from .metrics import MetricsRegistry, DEFAULT_TIME_EDGES

from torch.profiler import record_function as _record_function


class _NullSpan:
    """Reusable no-op context manager (one shared instance, zero alloc)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One timed span: perf_counter on enter/exit, duration observed into
    the tracer's histogram for the span's dotted path. The parent path is
    carried explicitly (not recomputed from the dotted string) so span
    NAMES may themselves contain dots."""
    __slots__ = ("_tracer", "_path", "_parent", "_t0", "_ann")

    def __init__(self, tracer: "Tracer", path: str, parent: str):
        self._tracer = tracer
        self._path = path
        self._parent = parent
        self._ann = None

    def __enter__(self):
        tr = self._tracer
        tr._stack.path = self._path
        if tr.annotate:
            self._ann = _record_function(self._path)
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        tr = self._tracer
        if self._ann is not None:
            self._ann.__exit__(*exc)
        tr._observe(self._path, dt)
        tr._stack.path = self._parent
        return False


class Tracer:
    """Span-timer bound to a metrics registry.

    ``tracer.span("tick")`` inside ``tracer.span("serve")`` records into the
    histogram ``<prefix>span_seconds`` under the dotted path ``serve.tick``
    -- one histogram per distinct path, registered lazily. The nesting
    stack is thread-local, so transport threads and the scheduler thread
    can trace concurrently without mixing ancestries.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 prefix: str = "trace_", annotate: bool = False,
                 edges=DEFAULT_TIME_EDGES):
        self.registry = registry or MetricsRegistry()
        self.prefix = prefix
        self.annotate = annotate
        self._edges = edges
        self._stack = threading.local()
        self._stack.path = ""

    # thread-local access: a thread that never opened a span has no .path
    def _current(self) -> str:
        return getattr(self._stack, "path", "")

    def span(self, name: str) -> _Span:
        parent = self._current()
        return _Span(self, f"{parent}.{name}" if parent else name, parent)

    def _observe(self, path: str, dt: float) -> None:
        self.registry.histogram(
            f"{self.prefix}{path}_seconds",
            help=f"span duration: {path}", edges=self._edges).observe(dt)

    def span_names(self) -> list[str]:
        """Dotted span paths recorded so far (for tests/docs)."""
        pre, suf = self.prefix, "_seconds"
        return sorted(m.name[len(pre):-len(suf)] for m in self.registry
                      if m.name.startswith(pre) and m.name.endswith(suf))


class _NullTracer(Tracer):
    """Disabled tracer: ``span()`` returns a shared no-op context manager."""

    def __init__(self):
        super().__init__(MetricsRegistry())

    def span(self, name: str):  # type: ignore[override]
        return _NULL_SPAN


NULL_TRACER = _NullTracer()
