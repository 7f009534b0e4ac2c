"""Run one cell of the benchmark and print its result as the last line.

    python -m chipbench.run --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout on a machine with the cards the cell asks
for. It makes the weights on the card from the seed, warms up the cell's
own shapes and traffic (``setup_s``: from process start to the window),
measures for ``--seconds``, reads the program's peak memory, frees the
program's state and then holds a sample of the window's outputs against the
plain reference. ``--trace 1`` runs the same window under the profiler and
reports the per-layer metrics instead of the end-to-end ones.

Exit codes: 0 with a result; 2 without the cards the cell needs; 3 when a
module of the JAX package or JAX itself was loaded; 1 on any other failure.
Nothing is printed as a result in those cases.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

T_IMPORT = time.perf_counter()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, float(Path("/proc/uptime").read_text().split()[0]) - start)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_IMPORT = _process_age()


def log(msg: str) -> None:
    """A progress line on standard error, with the seconds since process start."""
    print(f"chipbench [{AGE_AT_IMPORT + time.perf_counter() - T_IMPORT:8.2f} s] {msg}",
          file=sys.stderr, flush=True)


def setup_env(root: Path = ROOT) -> None:
    """The program's source on the path; Triton's cache at a fixed place in
    the checkout (the CUDA kernels build into ``build/kernels`` there)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Context:
    """What a per-layer metric's reader may read: the cell, its traffic kind,
    config and reference module (``arch``), the window (records or samples,
    length, counters at both ends), the trace, and the arithmetic modules."""

    def __init__(self, cell, kind, model, mix, window):
        from . import bounds, flops
        from .reference import quadrature
        self.cell, self.kind, self.model, self.mix, self.window = cell, kind, model, mix, window
        self.arch = cell["arch_module"]
        self.trace = window.trace
        self.bounds, self.flops, self.quadrature = bounds, flops, quadrature

    def counter_delta(self, name: str):
        """A program counter's (or histogram's ``sum``/``count``) change over
        the window, or None when the program did not record it."""
        a, b = self.window.counters
        if not a or not b or name not in b:
            return None
        va, vb = a.get(name), b[name]
        if isinstance(vb, dict):
            va = va or {"sum": 0.0, "count": 0}
            return {"sum": vb["sum"] - va["sum"], "count": vb["count"] - va["count"]}
        return vb - (va or 0.0)

    def work(self, traced: bool = False):
        """(real token-NFEs, useful FLOPs) of the work finished in the window,
        or in its traced part (``traced``)."""
        span = self.trace.window_s if traced else self.window.window_s
        w0 = self.window.w0 + (self.window.trace_off if traced else 0.0)
        if self.kind == "oneshot":
            b, s, nfe = int(self.mix["batch"]), int(self.mix["seq_len"]), int(self.mix["nfe"])
            n = sum(1 for r in self.window.records if w0 < r["done"] <= w0 + span + 0.05)
            return n * b * s * nfe, n * b * self.flops.sample_flops(self.model, s, nfe, self.arch)
        reqs = [r for r in self.window.records if r.ok and w0 <= r.done <= w0 + span]
        return (sum(r.spec.seq_len * r.spec.nfe for r in reqs),
                sum(self.flops.sample_flops(self.model, r.spec.seq_len, r.spec.nfe, self.arch)
                    for r in reqs))


def _kind(cell: dict) -> str:
    if cell["mix_data"]["kind"] == "oneshot":
        return "oneshot"
    return cell["arrival"]["kind"]


DEFAULT_E2E = {"closed": ["served_tokens_per_s", "setup_s"],
               "oneshot": ["tokens_per_s", "setup_s"]}


def _end_to_end(kind, window, mix, setup_s) -> tuple[dict, int, int]:
    """(metrics, attempted, failed) on the host clock: a one-shot window's
    tokens over its length; a served window's real tokens of the requests
    finished in it over its length, and every request that ended after it
    opened (drained ones too) as attempted."""
    out = {"setup_s": (setup_s, "s")}
    if kind == "oneshot":
        n = len(window.records)
        toks = n * int(mix["batch"]) * int(mix["seq_len"])
        out["tokens_per_s"] = (toks / window.window_s, "tokens/s")
        return out, n, 0
    w0, w1 = window.w0, window.w0 + window.window_s
    ended = [r for r in window.records if r.done is not None and r.done >= w0]
    done = [r for r in ended if r.ok and r.done <= w1]
    out["served_tokens_per_s"] = (sum(r.spec.seq_len for r in done) / window.window_s,
                                  "tokens/s")
    return out, len(ended), sum(not r.ok for r in ended)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             base: Path = HERE, root: Path = ROOT, overrides=None, after_check=None) -> dict:
    """Run cell ``name`` and return its result dict (without printing).
    ``device``: a torch device (the card by default); ``base``: where the
    configs, mixes, cells and readers lie; ``root``: where BENCHMARK.json lies;
    ``overrides``: keys replaced in the cell (the control tool's shorter
    warm-up); ``after_check(weights, model, mix, picked, arch)``: called with
    what the check compared, its return put under the result's ``control``."""
    import torch

    from . import check, drive, spec
    from . import trace as TR
    from . import weights as W
    from repro_torch.configs.base import config_from_dict

    device = torch.device(device or "cuda")
    cell = dict(spec.load_cell(name, base), **(overrides or {}))
    kind, mix, model = _kind(cell), cell["mix_data"], cell["config_data"]["model"]
    arch = cell["arch_module"]
    e2e_names, layer_names = spec.cell_metrics(name, DEFAULT_E2E[kind], root)
    cfg = config_from_dict(model)
    params = W.make(model, seed, device, arch)
    log(f"weights of {cell['config']} made ({W.n_params(model, arch)} parameters)")
    sink = None
    if kind == "oneshot":
        window = drive.oneshot(params, cfg, mix, seed, seconds, trace, device)
    else:
        from repro_torch.core import VPSDE
        from repro_torch.obs.metrics import MetricsRegistry
        from repro_torch.serving.engine import DiffusionServeEngine
        reg = MetricsRegistry()
        sink = TR.SpanSink() if trace else None
        engine = DiffusionServeEngine(
            params, cfg, sde=VPSDE(), max_group=int(mix["max_group"]),
            seq_len_buckets=tuple(mix["buckets"]), metrics=reg,
            tracer=sink.tracer(reg) if sink else None, device=device)
        with torch.no_grad():
            drive.warm_served(engine, mix, seed)
        log("one request of each (solver, bucket) served")
        window = drive.served(engine, mix, cell, seed, seconds, trace, sink)
        del engine
    setup_s = AGE_AT_IMPORT + (window.t_open - T_IMPORT)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
        name_dev = torch.cuda.get_device_name(device)
    else:
        peak, name_dev = 0, "cpu"
    metrics, attempted, failed = _end_to_end(kind, window, mix, setup_s)
    log(f"window closed and drained: setup_s {setup_s:.3f}, {attempted} attempted, {failed} failed")

    # the program's state goes before the reference runs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limits = cell.get("check", {}).get("limits", {})
    if kind == "oneshot":
        picked = check.oneshot_sample(window.records, seed)
        numbers = check.check_oneshot(params, model, mix, picked, arch)
    else:
        picked = check.served_sample(window.records, window.w0, seed,
                                     int(cell.get("check", {}).get("sample_tokens", 600)))
        numbers = check.check_served(params, model, picked, arch)
    log(f"reference checked: {numbers}")
    control = after_check(params, model, mix, picked, arch) if after_check else None
    ok, rows = check.verdict(numbers, limits)
    rows.append(("failed_requests", failed, 0))
    correct = ok and failed == 0

    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        ctx = Context(cell, kind, model, mix, window)
        got = {}
        for m in layer_names:
            mod = spec.reader(m, base)
            v = mod.read(ctx)
            if v is not None:
                got[m] = {"value": float(v), "unit": mod.UNIT}
        result["metrics"] = got
    else:
        result["metrics"] = {k: {"value": float(v), "unit": u} for k, (v, u) in metrics.items()
                             if k in e2e_names}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": name_dev,
           "count": 1, "memory_peak_bytes": peak}
    if trace and window.trace is not None:
        dev.update(busy_s=window.trace.busy_s, window_s=window.trace.window_s)
        result["breakdown"] = window.trace.breakdown()
    result["device"] = dev
    result["notes"] = {"window_s": window.window_s,
                       "rows_checked": numbers.get("rows_checked"),
                       "tokens_checked": numbers.get("tokens_checked"),
                       "all_check_numbers": {k: v for k, v in numbers.items()
                                             if k not in ("rows_checked", "tokens_checked")}}
    if control is not None:
        result["control"] = control
    result["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_env()
    import torch

    from . import spec
    chips = next((w.get("chips", 1) for w in spec.manifest().get("workloads", [])
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"chipbench: cell {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"chipbench: modules of {bad} were loaded in this process", file=sys.stderr)
        return 3
    for k, c in result["check"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
