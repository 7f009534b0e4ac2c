"""Async request-transport driver around :class:`DiffusionServeEngine` (the
counterpart of ``repro.serving.driver``).

The engine is a synchronous scheduler: ``submit()`` enqueues, ``tick()``
advances. :class:`ServeDriver` turns that into a *service*: a dedicated
executor thread owns the engine and runs the tick loop, while any number of
transport threads (HTTP handlers, asyncio tasks, tests) hand requests over a
thread-safe inbox and get back a :class:`ServeStream` -- a per-request
future for the final :class:`~repro_torch.serving.engine.Result` plus an
ordered stream of :class:`~repro_torch.serving.engine.StepEvent` progress
(optionally with partial decodes).

Threading contract
------------------

* ONE thread (the driver's) ever touches the engine and therefore the
  device. PyTorch keeps the current CUDA device and the grad mode per
  thread, so the scheduler thread sets the engine's device and runs its
  whole loop under ``torch.no_grad()``. Transports only enqueue
  (``queue.Queue``) and wait on futures; tokens reach them as numpy arrays
  (``Result.tokens``, ``StepEvent.tokens``), so no tensor crosses threads
  and no locking of engine state is needed.
* ``submit()`` is thread-safe and non-blocking; ``submit_async()`` is its
  asyncio twin (the returned handle supports ``async for`` over events and
  ``await handle.result()``).
* Per-request event fan-out happens on the scheduler thread between solver
  steps (the engine's ``on_step`` contract): each event is sliced down to
  the request's own row and progress (``k`` capped at the request's true
  step count in a ragged group) and pushed to that request's stream.

Ordering/reproducibility guarantee: the driver adds no randomness and never
reorders a request's own events; samples remain a pure function of
``(solver, nfe, eta, seed, seq_len)`` exactly as in the synchronous engine
-- priorities, deadlines, admission timing and compaction only change WHEN
steps run (see the engine module docstring).

Failure contract: engine-side validation errors (unknown solver, ddim_eta
without eta) are caught on the scheduler thread and delivered to the ONE
offending request's future as the original exception; other in-flight
requests are unaffected (contrast with the synchronous ``serve()``'s
all-or-nothing batch validation). A tick that raises fails every in-flight
request with the error; ``driver_crash_total`` counts such ticks. Without
a mesh the driver then resets the engine and keeps serving (fail open), so
a caller that must not serve through a broken device checks the counter.
With a mesh it fails closed: the engine has destroyed the process groups
(so every follower's ``follow()`` raises), the scheduler thread ends, and
every later submission fails at once with a ``RuntimeError``.

Request-axis mesh: with a sharded engine (``DiffusionServeEngine(mesh=)``)
the driver runs on the mesh's rank 0, whose scheduler thread is the only
caller of collectives (each ``tick`` broadcasts its inputs to the other
ranks, which run ``engine.follow()``); transport threads never call one.
While idle the scheduler sends a heartbeat every ``HEARTBEAT_S`` (a quarter
of the control group's timeout), so no follower waits in a broadcast for
as long as that timeout.

Backpressure contract: with ``max_pending=n`` the driver bounds its
in-flight set (submitted but unfinished requests). The (n+1)-th concurrent
submission is shed in O(1) at submit time: its handle's future fails with
:class:`QueueFull` and its event stream closes empty; nothing is enqueued,
the scheduler never sees it, and every admitted request proceeds untouched.
Both ``submit`` and ``submit_async`` shed identically.
"""
from __future__ import annotations

import asyncio
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Iterator, Optional

import torch

from ..launch.mesh import CONTROL_TIMEOUT
from .engine import (Cancelled, DeadlineExceeded, DiffusionServeEngine,
                     Request, Result, StepEvent)

# an idle leader's beat to its followers, well inside their wait's timeout
HEARTBEAT_S = CONTROL_TIMEOUT.total_seconds() / 4

_CLOSE = object()   # stream sentinel: no more events
_CANCEL = object()  # inbox sentinel: (sentinel, uid) cancellation order


class QueueFull(RuntimeError):
    """Raised on a request's handle when the driver sheds it for backpressure.

    Delivered through the rejected request's own :class:`ServeStream` future
    (``handle.result()`` re-raises it; the event stream closes empty) -- the
    driver itself never crashes and every other in-flight request is
    unaffected. Clients treat it like HTTP 429: back off and resubmit.
    """


class ServeStream:
    """Per-request handle: an event stream plus a future for the Result.

    Iterating (``for ev in stream``) yields :class:`StepEvent`\\ s scoped to
    THIS request (``uids == (uid,)``, ``n_steps`` = the request's own step
    count, ``tokens`` = its own row when the driver streams decodes) and
    ends when the request finishes or fails. ``result()`` blocks for the
    final :class:`Result` (or re-raises the request's validation error).
    Both may be consumed from any thread, together or independently.
    """

    def __init__(self, uid: int):
        self.uid = uid
        self._events: queue.Queue = queue.Queue()
        self._future: Future = Future()

    # ---- producer side (driver thread) ----
    def _push(self, event: StepEvent) -> None:
        self._events.put(event)

    def _finish(self, result: Result) -> None:
        if self._future.done():           # already failed (e.g. by _crash)
            return
        self._future.set_result(result)   # result first: visible the moment
        self._events.put(_CLOSE)          # ... iteration ends

    def _fail(self, exc: BaseException) -> None:
        if self._future.done():
            return
        self._future.set_exception(exc)
        self._events.put(_CLOSE)

    # ---- consumer side (any thread) ----
    def result(self, timeout: Optional[float] = None) -> Result:
        """Block until the request finishes; raises its validation error."""
        return self._future.result(timeout)

    def done(self) -> bool:
        """True once the request has finished or failed."""
        return self._future.done()

    def events(self) -> Iterator[StepEvent]:
        """Yield this request's StepEvents in order until completion."""
        while True:
            ev = self._events.get()
            if ev is _CLOSE:
                return
            yield ev

    def __iter__(self) -> Iterator[StepEvent]:
        return self.events()


class AsyncServeStream:
    """Asyncio view of a :class:`ServeStream`.

    ``async for ev in handle`` iterates events; ``await handle.result()``
    awaits the final Result. Event waits are delegated to a worker thread
    (``asyncio.to_thread``) so the loop is never blocked by the scheduler.
    """

    def __init__(self, stream: ServeStream):
        self._stream = stream
        self.uid = stream.uid

    def __aiter__(self):
        return self

    async def __anext__(self) -> StepEvent:
        # Cancellation-safe: poll with non-blocking gets + short sleeps
        # instead of parking a worker thread in Queue.get() -- a cancelled
        # to_thread future leaves its thread blocked, and that orphan would
        # later swallow the next event (or the close sentinel). Solver steps
        # are O(10ms+), so a few-ms poll adds no measurable latency.
        while True:
            try:
                ev = self._stream._events.get_nowait()
            except queue.Empty:
                await asyncio.sleep(0.002)
                continue
            if ev is _CLOSE:
                raise StopAsyncIteration
            return ev

    async def result(self) -> Result:
        """Await the final Result (re-raises the request's validation error)."""
        return await asyncio.wrap_future(self._stream._future)

    def done(self) -> bool:
        """True once the request has finished or failed."""
        return self._stream.done()


class ServeDriver:
    """Run a :class:`DiffusionServeEngine` on a dedicated scheduler thread.

    Usage (sync transport)::

        with ServeDriver(engine, stream_decode=True) as drv:
            h = drv.submit(Request(uid=0, seq_len=32, nfe=10, solver="tab3"))
            for ev in h:                      # streamed progress
                print(ev.k, "/", ev.n_steps)
            tokens = h.result().tokens

    Usage (asyncio transport)::

        h = await drv.submit_async(Request(...))
        async for ev in h: ...
        res = await h.result()

    The driver is the natural place to throttle the scheduler for latency:
    construct the engine with ``steps_per_tick=k`` and the driver's tick
    loop becomes earliest-deadline-first over in-flight groups (with
    starvation aging), admitting newly transported requests at every step
    boundary.
    """

    def __init__(self, engine: DiffusionServeEngine, *,
                 stream_decode: bool = False, idle_wait_s: float = 0.005,
                 max_pending: int | None = None):
        """``max_pending``: bound on in-flight requests (submitted, not yet
        finished). ``None`` = unbounded (the pre-backpressure behavior).
        Submissions over the bound are shed instantly: the returned handle's
        future fails with :class:`QueueFull` and nothing reaches the
        scheduler thread, so an ingest burst can neither grow the inbox
        without limit nor crash the driver."""
        self.engine = engine
        self.stream_decode = stream_decode
        self.idle_wait_s = idle_wait_s
        self.max_pending = max_pending
        # repro: allow[RL003] set once by the scheduler thread when a mesh engine fails closed (the ownership table predates the port)
        self._failed: Optional[BaseException] = None
        self._inbox: queue.Queue = queue.Queue()
        self._streams: dict[int, ServeStream] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Driver metrics live in the ENGINE's registry so one /metrics scrape
        # (or NDJSON snapshot) covers the whole serving stack.
        self.metrics = engine.metrics
        self._m_submitted = self.metrics.counter(
            "driver_submitted_total", help="requests accepted by the driver")
        self._m_shed = self.metrics.counter(
            "driver_shed_total",
            help="requests shed at submit time (QueueFull backpressure)")
        self._h_loop = self.metrics.histogram(
            "driver_loop_seconds",
            help="scheduler-loop iteration latency (drain + tick + fanout)")
        self._m_crash = self.metrics.counter(
            "driver_crash_total",
            help="ticks that raised (their in-flight requests failed)")

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ServeDriver":
        """Start the scheduler thread (idempotent).

        The check-then-spawn runs under ``_lock``: two concurrent first
        ``submit()`` calls would otherwise both see ``_thread is None`` and
        start two scheduler threads over a single-threaded engine."""
        with self._lock:
            if self._failed is None and (self._thread is None
                                         or not self._thread.is_alive()):
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="deis-serve-driver", daemon=True)
                self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        """Drain: finish everything submitted, then stop the thread.

        If ``timeout`` expires while the scheduler is still mid-solve the
        thread reference is KEPT, so a later ``submit()``/``start()`` cannot
        spawn a second scheduler thread over a live one (the engine is
        single-threaded by contract)."""
        self._stop.set()
        with self._lock:
            thread = self._thread
        if thread is not None:
            thread.join(timeout)  # join outside the lock: submit() must not
            if not thread.is_alive():  # block behind a draining scheduler
                with self._lock:
                    if self._thread is thread:
                        self._thread = None

    def __enter__(self) -> "ServeDriver":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ transport
    def submit(self, request: Request) -> ServeStream:
        """Thread-safe, non-blocking submission; returns the request handle.

        ``request.uid`` must be unique among in-flight requests (it keys the
        event fan-out). Validation happens on the scheduler thread; errors
        surface on the returned handle, not here. Backpressure also surfaces
        on the handle: over ``max_pending`` in-flight requests, the handle
        comes back already failed with :class:`QueueFull` (fast shed -- the
        request never touches the scheduler)."""
        stream = ServeStream(request.uid)
        with self._lock:
            if self._failed is not None:
                stream._fail(self._closed_error(self._failed))
                return stream
            if request.uid in self._streams:
                raise ValueError(f"request uid {request.uid} is already "
                                 "in flight")
            if self.max_pending is not None and \
                    len(self._streams) >= self.max_pending:
                self._m_shed.inc()
                stream._fail(QueueFull(
                    f"driver at max_pending={self.max_pending} in-flight "
                    f"requests; request uid {request.uid} shed -- back off "
                    "and resubmit"))
                return stream
            self._streams[request.uid] = stream
            self._m_submitted.inc()
        self._inbox.put((request, stream))
        # start AFTER the put: if a concurrent stop() let the scheduler
        # thread observe (stop set, inbox empty) and exit between our
        # registration and the put, this restarts it and the new thread
        # drains the inbox -- no request can be stranded with an unresolved
        # future. (start() is idempotent while the thread lives.)
        self.start()
        return stream

    async def submit_async(self, request: Request) -> AsyncServeStream:
        """Asyncio twin of :meth:`submit` (same queue, same guarantees)."""
        return AsyncServeStream(self.submit(request))

    def cancel(self, uid: int) -> bool:
        """Request cancellation of an in-flight request (thread-safe,
        non-blocking, best-effort).

        The order rides the SAME inbox as submissions, so it can never
        outrun its own request: by the time the scheduler processes it, the
        request has been handed to the engine (FIFO), and
        ``engine.cancel`` either drops it from pending or retires its
        mid-flight row through the deadline-eviction machinery. The
        request's handle then fails with :class:`Cancelled` (partial Result
        attached) and its event stream closes -- the same per-request
        failure shape as a deadline eviction.

        Returns True when ``uid`` was in flight at call time; False is a
        no-op (already finished, shed, or never submitted -- any
        already-delivered Result stands). Cancellation that loses the race
        with the request's own completion is also a no-op: the sample wins.
        """
        with self._lock:
            live = uid in self._streams
        if live:
            self._inbox.put((_CANCEL, uid))
            self.start()
        return live

    def stats(self) -> dict:
        """Scheduler counters (safe snapshot; values may lag one tick).

        All counts come from the shared metrics registry (engine + driver
        write into the same one); the historical keys are kept so existing
        callers and the HTTP ``/stats`` route are unaffected."""
        eng = self.engine
        with self._lock:
            in_flight = len(self._streams)
        return {"ticks": eng.ticks, "executors": eng.num_executors,
                "wasted_row_steps": eng.wasted_row_steps,
                "joined_requests": eng.joined_requests,
                "in_flight": in_flight,
                "max_pending": self.max_pending,
                "submitted": int(self._m_submitted.value),
                "shed": int(self._m_shed.value),
                "completed": int(eng._m_completed.value),
                "deadline_evicted": int(eng._m_evicted.value),
                "cancelled": int(eng._m_cancelled.value),
                "early_exit": int(eng._m_early.value),
                "saved_nfe": int(eng._m_saved_nfe.value)}

    # ------------------------------------------------------------ scheduler
    def _drain_inbox(self, block: bool) -> None:
        try:
            first = self._inbox.get(timeout=self.idle_wait_s) if block \
                else self._inbox.get_nowait()
        except queue.Empty:
            return
        batch = [first]
        while True:
            try:
                batch.append(self._inbox.get_nowait())
            except queue.Empty:
                break
        for req, stream in batch:
            if req is _CANCEL:
                # stream here is the uid; engine emits the cancelled Result
                # at the next tick (False = already finished: no-op, the
                # delivered Result stands)
                self.engine.cancel(stream)
                continue
            try:
                self.engine.submit(req)
            except Exception as e:  # per-request failure, not batch-fatal
                with self._lock:
                    self._streams.pop(req.uid, None)
                stream._fail(e)

    def _fanout(self, event: StepEvent) -> None:
        """Engine ``on_step`` callback: slice the group event per request.

        ``row_k`` carries each request's OWN completed step count (a joiner
        spliced into an in-flight group counts from its admission tick), and
        ``row_seq_lens`` its true length (bucketed admission solves at the
        bucket edge; streamed decodes are masked back to the request)."""
        for i, uid in enumerate(event.uids):
            with self._lock:
                stream = self._streams.get(uid)
            if stream is None:
                continue   # submitted directly to the engine, or finished
            row_n = event.row_steps[i] if event.row_steps else event.n_steps
            row_k = event.row_k[i] if event.row_k else event.k
            if row_k > row_n:
                continue   # retired row still riding an uncompacted group
            tok = event.tokens[i] if event.tokens is not None else None
            if tok is not None and event.row_seq_lens:
                tok = tok[:event.row_seq_lens[i]]
            err = (event.row_err[i],) if event.row_err is not None else None
            stream._push(dataclasses.replace(
                event, uids=(uid,), k=min(row_k, row_n), n_steps=row_n,
                tokens=tok, row_steps=None, row_k=None, row_seq_lens=None,
                row_err=err))

    @staticmethod
    def _closed_error(failed: BaseException) -> RuntimeError:
        err = RuntimeError("the driver stopped: a tick failed on the mesh "
                           f"({failed!r}) and its process groups are gone")
        err.__cause__ = failed
        return err

    def _crash(self, exc: BaseException) -> bool:
        """A tick blew up: the engine's in-flight state is unreliable, so
        fail EVERY in-flight request with the error (no silent thread death,
        no futures stranded forever) and reset the scheduler queues --
        including requests still in the inbox, which are drained and failed
        too (their streams are already registered; leaving them queued would
        resubmit them against their already-failed futures). Without a mesh
        the engine is reset and the driver keeps serving later submissions;
        with one it has failed closed, and so does the driver (returns True:
        the scheduler stops)."""
        self._m_crash.inc()
        closed = self.engine.mesh is not None
        with self._lock:
            streams, self._streams = self._streams, {}
            if closed:
                self._failed = exc
        while True:
            try:
                self._inbox.get_nowait()
            except queue.Empty:
                break
        if not closed:
            self.engine.reset()
        for stream in streams.values():
            stream._fail(exc)
        return closed

    def _run(self) -> None:
        device = self.engine.device
        if device.type == "cuda":
            torch.cuda.set_device(device)
        with torch.no_grad():
            self._loop()

    def _loop(self) -> None:
        last_beat = time.perf_counter()
        while True:
            busy = self.engine.busy
            self._drain_inbox(block=not busy)
            try:
                if self.engine.mesh is not None and not self.engine.busy and \
                        time.perf_counter() - last_beat > HEARTBEAT_S:
                    self.engine.heartbeat()
                    last_beat = time.perf_counter()
                results = None
                if self.engine.busy:
                    last_beat = t0 = time.perf_counter()
                    results = self.engine.tick(
                        on_step=self._fanout,
                        stream_decode=self.stream_decode)
            except Exception as e:   # noqa: BLE001 - fail open, or closed on a mesh
                if self._crash(e):
                    return
                continue
            if results is not None:
                for res in results:
                    with self._lock:
                        stream = self._streams.pop(res.uid, None)
                    if stream is None:
                        continue
                    if res.cancelled:
                        exc = Cancelled(
                            f"request uid {res.uid} cancelled after "
                            f"{res.latency_s:.3f}s of solve time")
                        exc.result = res
                        stream._fail(exc)
                    elif res.deadline_exceeded:
                        # Deadline eviction is a per-request outcome, never a
                        # driver crash: the engine recycled the row and this
                        # request's own future carries the error (with the
                        # partial Result attached for latency accounting).
                        exc = DeadlineExceeded(
                            f"request uid {res.uid} evicted: absolute "
                            f"deadline passed after {res.latency_s:.3f}s of "
                            "solve time")
                        exc.result = res
                        stream._fail(exc)
                    else:
                        stream._finish(res)
                self._h_loop.observe(time.perf_counter() - t0)
            elif self._stop.is_set() and self._inbox.empty():
                return
