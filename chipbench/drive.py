"""The measured windows: served traffic from closed-loop clients through
the port's ``ServeDriver``, and one-shot sampling through ``sample_tokens``.

Times are host-clock seconds from the start of the cell's traffic. A
served run sends ``warm_s`` seconds of the cell's own traffic first and
goes straight on into the window, so the window opens on a server in its
steady state; what was sent in the warm-up is not counted.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
import time
from typing import Optional

import numpy as np
import torch

from . import trace as TR
from . import traffic


@dataclasses.dataclass
class Rec:
    """One request as the client saw it (seconds from the traffic's start):
    when it was sent and done; its tokens or its error."""
    spec: traffic.Spec
    uid: int
    sent: float
    done: Optional[float] = None
    tokens: Optional[np.ndarray] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.tokens is not None


@dataclasses.dataclass
class Window:
    """What a window produced: its records (or samples), its length, the
    program's counters at its two ends, the trace."""
    records: list
    w0: float
    window_s: float
    counters: tuple = ({}, {})
    trace: Optional[TR.Trace] = None
    t_open: float = 0.0     # perf_counter() at the window's opening
    trace_off: float = 0.0  # where the traced part starts, seconds into the window


async def _finish(handle, rec: Rec, t0: float, limit: float):
    try:
        res = await asyncio.wait_for(handle.result(), timeout=max(0.0, t0 + limit - time.perf_counter()))
        rec.tokens = np.asarray(res.tokens)
    except asyncio.TimeoutError:
        rec.error = "not done within the drain limit"
    except Exception as exc:                     # noqa: BLE001 - a failed request is a record
        rec.error = f"{type(exc).__name__}: {exc}"
    rec.done = time.perf_counter() - t0


class _Profile:
    """The profiler over the window (a no-op when tracing is off)."""

    def __init__(self, on: bool):
        self.prof = TR.profiler() if on else None
        self.range = None
        self.running = False

    def prime(self):
        """Start and stop a profiler once, in set-up: the first start in a
        process initialises the device tracing, seconds on the card."""
        if self.prof is not None:
            first = TR.profiler()
            first.start()
            first.stop()

    def begin(self):
        if self.prof is not None:
            self.prof.start()
            self.running = True

    def open(self):
        if self.prof is not None:
            self.range = TR.window_range()
            self.range.__enter__()

    def stop(self):
        """Close the window's range and stop the profiler (once)."""
        if self.running:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.range.__exit__(None, None, None)
            self.prof.stop()
            self.running = False

    def result(self, extra_ranges=()):
        return TR.reduce(self.prof, extra_ranges) if self.prof is not None else None


def served(engine, mix: dict, cell: dict, seed: int, seconds: float, trace: bool,
           sink: Optional[TR.SpanSink] = None, drain_s: float = 60.0) -> Window:
    """Serve the cell's traffic from ``arrival.clients`` closed-loop clients,
    each sending its next request when its last returns: ``warm_s`` of it,
    then the window of ``seconds``; drain every request sent, up to
    ``drain_s`` past the close. ``sink``: where the engine's tracer put its
    spans (a traced run)."""
    from repro_torch.serving.driver import ServeDriver
    from repro_torch.serving.engine import Request

    warm_s = float(cell.get("warm_s", 5.0))
    end = warm_s + seconds
    prof = _Profile(trace)
    snaps = [None, None]
    uid = itertools.count()
    records: list[Rec] = []
    trace_off = [0.0]
    specs = traffic.stream(mix, seed, 3)

    async def mark(at, i, t0):
        await asyncio.sleep(max(0.0, t0 + at - time.perf_counter()))
        snaps[i] = engine.metrics.snapshot()

    async def trace_end(t0):
        # the last TRACE_S of the window; stopping the profiler holds this
        # loop while it reads the trace, which is past the close
        await asyncio.sleep(max(0.0, t0 + warm_s + max(0.0, seconds - TR.TRACE_S)
                                - time.perf_counter()))
        prof.begin()
        prof.open()
        trace_off[0] = time.perf_counter() - t0 - warm_s
        await asyncio.sleep(max(0.0, t0 + end - time.perf_counter()))
        prof.stop()

    async def client(t0):
        while time.perf_counter() - t0 < end:
            spec = next(specs)
            rec = Rec(spec, next(uid), time.perf_counter() - t0)
            records.append(rec)
            h = await drv.submit_async(Request(uid=rec.uid, seq_len=spec.seq_len, nfe=spec.nfe,
                                               solver=spec.solver, seed=spec.seed))
            await _finish(h, rec, t0, end + drain_s)

    async def closed_loop(t0):
        marks = [asyncio.create_task(mark(warm_s, 0, t0)), asyncio.create_task(mark(end, 1, t0)),
                 asyncio.create_task(trace_end(t0))]
        await asyncio.gather(*marks, *[client(t0) for _ in range(int(cell["arrival"]["clients"]))])

    drv = ServeDriver(engine)
    prof.prime()
    with drv:
        t0 = time.perf_counter()
        asyncio.run(closed_loop(t0))
    return Window(records=records, w0=warm_s, window_s=seconds, counters=tuple(snaps),
                  trace=prof.result(sink.spans if sink else ()), t_open=t0 + warm_s,
                  trace_off=trace_off[0])


def warm_served(engine, mix: dict, seed: int) -> None:
    """One request of each (solver, bucket) pair of the mix, all at once,
    at the mix's smallest NFE, drained."""
    from repro_torch.serving.engine import Request
    reqs = [Request(uid=i, seq_len=b, nfe=min(mix["nfe"]), solver=s, seed=seed + i)
            for i, (s, b) in enumerate(itertools.product(mix["solvers"], mix["buckets"]))]
    engine.serve(reqs)


def oneshot(params, cfg, mix: dict, seed: int, seconds: float, trace: bool,
            device) -> Window:
    """One-shot samples back to back: one to warm up, then the window, which
    closes at the first sample to end at or after ``seconds``. Keeps every
    sample's tokens and x0 (on the device), its generator seeds and when it
    ended. A traced run traces the calls that start in the window's last
    ``TRACE_S`` and reads the trace after the window."""
    from repro_torch.core import VPSDE, get_timesteps, make_plan, solver_stages
    from repro_torch.diffusion.lm import sample_tokens

    sde = VPSDE()
    solver, nfe = mix["solver"], int(mix["nfe"])
    plan = make_plan(solver, sde, get_timesteps(sde, max(1, nfe // solver_stages(solver))),
                     **({"fused": True} if solver_stages(solver) == 1 else {}))
    rng = np.random.default_rng([int(seed) % 2 ** 63, 4])

    def one(i):
        seeds = [int(v) for v in rng.integers(0, 2 ** 62, size=2)]
        gens = tuple(torch.Generator(device=device).manual_seed(s) for s in seeds)
        with torch.profiler.record_function("chipbench.sample"):
            toks, x0 = sample_tokens(params, cfg, plan, gens, batch=int(mix["batch"]),
                                     seq_len=int(mix["seq_len"]), prior_std=sde.prior_std(),
                                     use_kernels=bool(mix.get("use_kernels", True)))
            toks = toks.cpu().numpy()
        return {"seeds": seeds, "tokens": toks, "x0": x0}

    with torch.no_grad():
        one(-1)
        if device.type == "cuda":
            torch.cuda.synchronize()
        prof = _Profile(trace)
        prof.prime()
        t0 = time.perf_counter()
        samples, trace_off = [], 0.0
        while True:
            if not prof.running and time.perf_counter() - t0 >= seconds - TR.TRACE_S:
                prof.begin()                  # the calls of the window's last TRACE_S
                prof.open()
                trace_off = time.perf_counter() - t0
            samples.append(one(len(samples)))
            samples[-1]["done"] = time.perf_counter() - t0
            if samples[-1]["done"] >= seconds:
                break
        window_s = time.perf_counter() - t0
        prof.stop()
    return Window(records=samples, w0=0.0, window_s=window_s, trace=prof.result(),
                  t_open=t0, trace_off=trace_off)
