"""The traced window: ``torch.profiler`` over the measured window, reduced to
device busy time, time by kind of kernel, and idle gaps by what the host
was doing.

The traced window is ``TRACE_S`` seconds of the measured one (the
profiler's reading of a whole 51 s window took a served mixtral run past
360 s): a served run's last ``TRACE_S``, a one-shot run's calls that
start in its last ``TRACE_S``. It is marked by the
benchmark's own range ``chipbench.window``; a
device operation is a kernel, a copy or a memset (CUDA activity), clipped
to the window; busy time is the length of their union. An idle gap is a
stretch of the window with no device operation; it is named by the
innermost host range open at its middle: the program's spans (``admit``,
``dispatch``, ``step_wait``, ...) as a :class:`SpanSink` recorded them on
the driver's thread, else the benchmark's own (``chipbench.sample``),
refined by the outermost PyTorch operator open there on the thread that
started the profiler (``aten::...``), or ``none``.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
import time

import torch

WINDOW = "chipbench.window"
TRACE_S = 20.0      # seconds of a window that a traced run traces
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")

# kind of a device operation, by its name (first match wins)
CATEGORIES = (
    ("K1", re.compile(r"fused_ab_kernel")),
    ("K2", re.compile(r"flash_fwd")),
    ("K3", re.compile(r"ssd_scan")),
    ("gemm", re.compile(r"gemm|nvjet|xmma|cutlass|cublas|Kernel2|bmm|matmul", re.I)),
    ("softmax", re.compile(r"softmax", re.I)),
    ("reduce", re.compile(r"reduce|norm|topk|sort|scan|cumsum|arg", re.I)),
    ("copy", re.compile(r"copy|memcpy|memset|cat|index|gather|scatter|fill", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled|pointwise", re.I)),
)


def category(name: str) -> str:
    for cat, pat in CATEGORIES:
        if pat.search(name):
            return cat
    return "other"


@dataclasses.dataclass
class Trace:
    """What a traced window read: ``ops`` (name, start, end) in seconds from
    the window's start, clipped to it; ``window_s``; ``busy_s``; ``gaps``
    (label, seconds)."""
    window_s: float
    ops: list
    busy_s: float
    gaps: list

    def time_of(self, pattern: str) -> tuple[float, int]:
        """(seconds, launches) of device operations whose name matches."""
        pat = re.compile(pattern)
        hit = [e - s for n, s, e in self.ops if pat.search(n)]
        return sum(hit), len(hit)

    def by_category(self) -> dict:
        out: dict = {}
        for n, s, e in self.ops:
            c = category(n)
            out[c] = out.get(c, 0.0) + (e - s)
        return out

    def breakdown(self, top: int = 10) -> dict:
        cats = sorted(self.by_category().items(), key=lambda kv: -kv[1])[:top]
        gaps: dict = {}
        for label, dt in self.gaps:
            gaps[label] = gaps.get(label, 0.0) + dt
        longest = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in cats],
                "idle_gaps": [[k, v] for k, v in longest]}


@contextlib.contextmanager
def window_range():
    with torch.profiler.record_function(WINDOW):
        yield


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def _kind(ev) -> str:
    """The event's activity kind (older releases of torch name no kind:
    then a CUDA event is a kernel, a CPU event an operator, either a range
    where it is a user annotation)."""
    if hasattr(ev, "activity_type"):
        return str(ev.activity_type())
    cuda = "CUDA" in str(ev.device_type())
    if ev.is_user_annotation():
        return "gpu_user_annotation" if cuda else "user_annotation"
    return "kernel" if cuda else "cpu_op"


class SpanSink:
    """Host spans recorded by the benchmark's tracer on any thread, as
    (start_ns, end_ns, name) on the Unix clock the profiler's events use
    (the profiler itself records operators of the thread it started on
    only, and the served engine runs on the driver's own thread)."""

    def __init__(self):
        self.spans: list = []

    def tracer(self, registry):
        """A tracer of the program's kind (``repro_torch.obs.trace.Tracer``)
        whose spans also land here."""
        from repro_torch.obs.trace import Tracer
        sink = self.spans

        class _Span:
            def __init__(self, inner, path):
                self.inner, self.path = inner, path

            def __enter__(self):
                self.t = time.time_ns()
                return self.inner.__enter__()

            def __exit__(self, *exc):
                out = self.inner.__exit__(*exc)
                sink.append((self.t, time.time_ns(), self.path))
                return out

        class _Tracer(Tracer):
            def span(self, name):
                parent = self._current()
                return _Span(super().span(name), f"{parent}.{name}" if parent else name)

        return _Tracer(registry)


def reduce(prof, extra_ranges=()) -> Trace:
    """Reduce a finished profile to a :class:`Trace` of its window;
    ``extra_ranges`` are host spans from a :class:`SpanSink`."""
    evs = prof.profiler.kineto_results.events()
    win = [e for e in evs if e.name() == WINDOW and _kind(e) != "gpu_user_annotation"]
    if not win:
        raise RuntimeError(f"the profile holds no {WINDOW} range")
    t0, t1 = win[0].start_ns(), win[0].end_ns()
    ops, ranges, aten = [], [], []
    for e in evs:
        s, en = e.start_ns(), e.end_ns()
        if en <= t0 or s >= t1:
            continue
        kind = _kind(e)
        if kind in DEVICE_KINDS:
            ops.append((e.name(), (max(s, t0) - t0) * 1e-9, (min(en, t1) - t0) * 1e-9))
        elif kind == "user_annotation" and e.name() != WINDOW:
            ranges.append((s, en, e.name()))
        elif kind == "cpu_op":
            aten.append((s, en, e.name()))
    ops.sort(key=lambda o: o[1])
    busy, spans = 0.0, []
    cur_s = cur_e = None
    for _, s, e in ops:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                spans.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        spans.append((cur_s, cur_e))
    window_s = (t1 - t0) * 1e-9
    holes, prev = [], 0.0
    for s, e in spans + [(window_s, window_s)]:
        if s > prev:
            holes.append((prev, s))
        prev = max(prev, e)
    ranges += [r for r in extra_ranges if r[1] > t0 and r[0] < t1]
    ranges.sort()
    aten.sort()
    gaps = [(_label(t0 + int((a + b) * 0.5e9), ranges, aten), b - a) for a, b in holes]
    return Trace(window_s=window_s, ops=ops, busy_s=busy, gaps=gaps)


def _open_at(t: int, spans: list, innermost: bool):
    """The innermost (latest-starting) or outermost span open at ``t``."""
    i = bisect.bisect_right(spans, (t, float("inf"), "")) - 1
    found = None
    for j in range(i, max(-1, i - 200), -1):
        s, e, name = spans[j]
        if s <= t < e:
            if innermost:
                return name
            found = name
    return found


def _label(t: int, ranges: list, aten: list) -> str:
    name = _open_at(t, ranges, innermost=True)
    if name is None or name.startswith("chipbench."):
        op = _open_at(t, aten, innermost=False)
        if op is not None:
            return f"{name} > {op}" if name else op
    return name or "none"
