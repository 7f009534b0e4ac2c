"""Observability for the port: the metrics registry and span tracer,
copied from ``repro.obs`` (spans annotate ``torch.profiler`` traces).

The tracer loads on first use: ``obs.bench`` and ``obs.metrics`` need no
torch, so the static analyzer's ``--bench`` record imports none."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "Tracer", "NULL_TRACER"]


def __getattr__(name):
    if name in ("Tracer", "NULL_TRACER"):
        from . import trace
        return getattr(trace, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
