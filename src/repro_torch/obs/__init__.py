"""Observability for the port: the metrics registry and span tracer,
copied from ``repro.obs`` (spans annotate ``torch.profiler`` traces)."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import Tracer, NULL_TRACER

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "Tracer", "NULL_TRACER"]
