"""Device time put down to the program's spans by launch, and the three
span-fed metrics that read it.

A program that is handed ``repro_torch.obs.trace.Tracer(annotate=True)``
records each span as a ``torch.profiler`` range on the thread that runs it
(``sample_tokens.sample.step.eps.layer.ssm.scan``, ...). The card runs a
kernel some time after its launch, often after the launching range has
closed, so a device operation is never matched to a range by the overlap
of clocks. Here it is put down to the innermost program range open on its
launching thread at the instant of its launch: the CUDA runtime or driver
API call (``cudaLaunchKernel``, ``cuLaunchKernelEx``, ``cudaMemcpyAsync``,
...) that carries the same correlation id. A launch outside every program
range counts under ``none``; the benchmark's own ranges (``chipbench.*``)
are not program ranges.

Not wired into the benchmark's runs: ``drive.oneshot`` hands the program
no tracer, ``trace.reduce`` keeps no launches, and ``BENCHMARK.json`` lists
none of the three metrics. ``python3 -m chipbench.spans`` runs a one-shot
cell as a wired harness would, with those seams substituted in its own
process (:func:`wired`), and prints the benchmark's result line with the
three metrics.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import sys
from typing import Optional

NONE = "none"
ROOT = "sample_tokens"
BENCH_PREFIX = "chipbench."
# a CUDA runtime or driver API call: cudaLaunchKernel, cuLaunchKernelEx, ...
LAUNCH = re.compile(r"^cu(da)?[A-Z]")


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def _program_ranges(events) -> list:
    """(start_ns, end_ns, path, thread) of the program's ranges."""
    return [(e.start_ns(), e.end_ns(), e.name(), e.start_thread_id()) for e in events
            if e.is_user_annotation() and not _is_device(e)
            and not e.name().startswith(BENCH_PREFIX) and e.end_ns() > e.start_ns()]


def _innermost(ranges: list, points: list) -> list:
    """The innermost range open at each ``(t_ns, thread)`` point, on that
    thread (``thread`` None: on any thread, the latest to open), or
    ``none``. A sweep with one stack per thread (a thread's ranges nest);
    at one instant ranges end first, then start, then points are read."""
    marks = [(s, 1, i, th) for i, (s, _, _, th) in enumerate(ranges)]
    marks += [(e, 0, i, th) for i, (_, e, _, th) in enumerate(ranges)]
    marks += [(t, 2, j, th) for j, (t, th) in enumerate(points)]
    marks.sort(key=lambda m: (m[0], m[1]))
    stacks: dict = {}
    out = [NONE] * len(points)
    for _, kind, i, th in marks:
        if kind == 2:
            tops = ([stacks.get(th)] if th is not None else list(stacks.values()))
            tops = [st[-1] for st in tops if st]
            if tops:
                out[i] = ranges[max(tops, key=lambda r: ranges[r][0])][2]
            continue
        stack = stacks.setdefault(th, [])
        if kind == 1:
            stack.append(i)
        elif i in stack:
            del stack[len(stack) - 1 - stack[::-1].index(i)]
    return out


def attribute(events, t0: int, t1: int) -> list:
    """``(name, seconds, path)`` of each device operation of ``events`` (a
    profile's kineto events) that overlaps ``[t0, t1)`` ns, clipped to it;
    ``path`` is the innermost program range open on the launching thread
    at the launch, or ``none``. An operation whose launch the profile does
    not hold is left out."""
    launches = {e.correlation_id(): (e.start_ns(), e.start_thread_id()) for e in events
                if not _is_device(e) and not e.is_user_annotation() and LAUNCH.match(e.name())}
    kept, points = [], []
    for e in events:
        if not _is_device(e) or e.is_user_annotation():
            continue
        s, en = max(e.start_ns(), t0), min(e.end_ns(), t1)
        launch = launches.get(e.correlation_id())
        if en > s and launch is not None:
            kept.append((e.name(), (en - s) * 1e-9))
            points.append(launch)
    paths = _innermost(_program_ranges(events), points)
    return [(name, sec, path) for (name, sec), path in zip(kept, paths)]


def idle_by_span(events, tr, t0: int) -> dict:
    """Idle seconds of a reduced trace ``tr`` (its window opening at ``t0``
    ns) by the innermost program range open at each gap's middle, on any
    thread, however long the range: a check of the trace's own gap labels,
    which look back a bounded number of ranges."""
    holes, prev = [], 0.0
    for _, s, e in sorted(tr.ops, key=lambda o: o[1]) + [(None, tr.window_s, tr.window_s)]:
        if s > prev:
            holes.append((prev, s))
        prev = max(prev, e)
    paths = _innermost(_program_ranges(events),
                       [(t0 + int((a + b) * 0.5e9), None) for a, b in holes])
    return totals([(None, b - a, path) for (a, b), path in zip(holes, paths)])


def totals(ops: list) -> dict:
    """Span path -> device seconds of :func:`attribute`'s operations."""
    out: dict = {}
    for _, sec, path in ops:
        out[path] = out.get(path, 0.0) + sec
    return out


def by_span(events, t0: int, t1: int) -> dict:
    """Span path -> device seconds in ``[t0, t1)`` ns (see :func:`attribute`)."""
    return totals(attribute(events, t0, t1))


def _under(path: str, span: str) -> bool:
    """Whether ``path`` is the span ``span`` (a dotted suffix) or lies in it."""
    return path.endswith("." + span) or ("." + span + ".") in path


def _per_ktok(ctx, pick) -> Optional[float]:
    spans = getattr(ctx.trace, "by_span", None) if ctx.trace is not None else None
    if not spans:
        return None
    toks, _ = ctx.work(traced=True)
    if not toks:
        return None
    return sum(v for p, v in spans.items() if pick(p)) * 1e6 / toks


def ssm_mixer_ms_per_ktok(ctx) -> Optional[float]:
    """Device ms under ``...layer.ssm`` and its parts, per 1000 real
    token-NFEs of the traced calls."""
    return _per_ktok(ctx, lambda p: p.startswith(ROOT) and _under(p, "layer.ssm"))


def ssm_pointwise_ms_per_ktok(ctx) -> Optional[float]:
    """Device ms under ``...layer.ssm.pre`` and ``...layer.ssm.post``, per
    1000 real token-NFEs of the traced calls."""
    return _per_ktok(ctx, lambda p: p.startswith(ROOT) and (
        _under(p, "layer.ssm.pre") or _under(p, "layer.ssm.post")))


def oneshot_idle_ms_per_call(ctx) -> Optional[float]:
    """Idle ms a call under the program's spans (gap labels that start with
    ``sample_tokens``), over the calls that end in the traced window; the
    gaps under the benchmark's own ranges alone are left out."""
    if ctx.trace is None or ctx.kind != "oneshot":
        return None
    prog = [dt for label, dt in ctx.trace.gaps if label.startswith(ROOT)]
    toks, _ = ctx.work(traced=True)
    calls = toks // (int(ctx.mix["batch"]) * int(ctx.mix["seq_len"]) * int(ctx.mix["nfe"]))
    if not prog or not calls:
        return None
    return sum(prog) * 1e3 / calls


METRICS = {"ssm_mixer_ms_per_ktok.batch": ssm_mixer_ms_per_ktok,
           "ssm_pointwise_ms_per_ktok.batch": ssm_pointwise_ms_per_ktok,
           "oneshot_idle_ms_per_call.batch": oneshot_idle_ms_per_call}


# ------------------------------------------------------------- the wired run
@contextlib.contextmanager
def wired(tracer, seen: dict):
    """A wired harness, in this process only: ``drive.oneshot`` hands
    ``sample_tokens`` ``tracer``; the trace's reduction also fills
    ``by_span`` (each operation's attribution and :func:`checks` go into
    ``seen``); the cell also reports :data:`METRICS`, read by the
    functions here."""
    import types

    import repro_torch.diffusion.lm as LM

    from . import spec
    from . import trace as TR
    saved = (LM.sample_tokens, TR.reduce, spec.cell_metrics, spec.reader)
    sample_tokens, reduce, cell_metrics, reader = saved

    def traced_sample_tokens(*args, **kw):
        return sample_tokens(*args, tracer=tracer, **kw)

    def reduce_by_span(prof, extra_ranges=()):
        tr = reduce(prof, extra_ranges)
        evs = prof.profiler.kineto_results.events()
        win = next(e for e in evs if e.name() == TR.WINDOW and not _is_device(e))
        seen["ops"] = attribute(evs, win.start_ns(), win.end_ns())
        tr.by_span = totals(seen["ops"])
        seen["checks"] = checks(seen["ops"], tr)
        seen["checks"]["idle_by_span"] = idle_by_span(evs, tr, win.start_ns())
        return tr

    def cell_metrics_too(*args, **kw):
        e2e, layer = cell_metrics(*args, **kw)
        return e2e, layer + list(METRICS)

    def reader_too(metric, *args, **kw):
        if metric in METRICS:
            return types.SimpleNamespace(UNIT="ms", read=METRICS[metric])
        return reader(metric, *args, **kw)

    LM.sample_tokens, TR.reduce = traced_sample_tokens, reduce_by_span
    spec.cell_metrics, spec.reader = cell_metrics_too, reader_too
    try:
        yield
    finally:
        LM.sample_tokens, TR.reduce, spec.cell_metrics, spec.reader = saved


def checks(ops: list, tr) -> dict:
    """What the attribution must show: ``by_span`` sums to the window's
    device-op total, nearly all of it under a program span; the paths K1's
    and K3's time went to; device seconds by span and kind of kernel."""
    from .trace import category
    total = sum(e - s for _, s, e in tr.ops)
    kinds: dict = {}
    for name, sec, path in ops:
        d = kinds.setdefault(path, {})
        d[category(name)] = d.get(category(name), 0.0) + sec
    attributed = sum(tr.by_span.values())
    return {"device_op_s": total, "by_span_s": attributed,
            "by_span_over_total": attributed / total if total else None,
            "program_share": (attributed - tr.by_span.get(NONE, 0.0)) / total if total else None,
            "k1_paths": sorted({p for n, _, p in ops if category(n) == "K1"}),
            "k3_paths": sorted({p for n, _, p in ops if category(n) == "K3"}),
            "by_span": dict(sorted(tr.by_span.items(), key=lambda kv: -kv[1])),
            "by_span_kind": kinds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run a one-shot cell with the program's spans "
                                 "on, as a wired harness would, and print its result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1,
                    help="0: the untraced window with the tracer passed (what tracing costs)")
    ap.add_argument("--out", default=None,
                    help="also write the result, the span checks and the span counts here")
    args = ap.parse_args(argv)
    from . import run
    run.setup_env()
    import torch
    if not torch.cuda.is_available():
        print("chipbench.spans: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.trace import Tracer
    tracer, seen = Tracer(MetricsRegistry(), annotate=True), {}
    with wired(tracer, seen):
        result = run.run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(result), flush=True)
    if args.out:
        counts = {p: tracer.registry.get(f"trace_{p}_seconds").count
                  for p in tracer.span_names()}
        with open(args.out, "w") as f:
            json.dump({"result": result, "span_checks": seen.get("checks"),
                       "span_counts": counts}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
