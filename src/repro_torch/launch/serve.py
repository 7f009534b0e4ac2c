"""Serving launcher on PyTorch: AR decode or the DEIS diffusion sampling
service (the counterpart of ``repro.launch.serve`` on one device).

Runs on the CUDA card; ``--device cpu`` runs it on the CPU (with
``--reduced`` for the small float32 model). Three diffusion transports:

  sync (default)  -- drain a request list through the engine in-process:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma_2b \
        --mode diffusion --nfe 10 --solver tab3 --requests 8

  driver          -- asyncio demo over the ServeDriver: mixed-priority
                     ragged-NFE requests submitted concurrently via
                     ``submit_async``, per-request progress streamed back:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma_2b \
        --transport driver --requests 6

  http            -- an HTTP endpoint on the driver: POST JSON to
                     /v1/generate ({"seq_len":32,"nfe":10,"solver":"tab3",
                     "seed":0,"priority":0,"deadline_s":null,"stream":true});
                     with "stream" the response is NDJSON StepEvents followed
                     by the final result line; POST /v1/cancel {"uid": n};
                     GET /metrics (Prometheus text) and GET /stats (JSON):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma_2b \
        --transport http --port 8433

AR mode (greedy prefill + decode over the KV / SSM cache):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma_2b \
        --mode ar --requests 4 --max-new 16

On the CPU add ``--device cpu --reduced``.

Request-axis data parallelism (diffusion mode), one process per device:
    torchrun --nproc_per_node=N -m repro_torch.launch.serve --arch gemma_2b \
        --data-parallel --transport driver
Each rank serves on ``cuda:LOCAL_RANK`` with an NCCL data group and a gloo
control group (gloo for both with ``--device cpu``); without torchrun's
environment the process runs a one-rank group. Rank 0 owns every
transport and prints everything; the other ranks follow its ticks. A vlm arch
(paligemma_3b) serves as a text-only decoder, without its image prefix, as
in the reference; an encdec arch (whisper_tiny) raises, since the engines
take no encoder frames (run it through ``sample_tokens(frames=)`` or the
prefill and decode steps).
"""
from __future__ import annotations

import argparse
import asyncio
import itertools
import json
import threading

import numpy as np
import torch.distributed as dist

from ..configs.base import ARCH_IDS, PORT_ARCH_IDS, get_config
from ..device import resolve_device
from ..models import transformer as T
from ..obs.export import NdjsonExporter, to_prometheus
from ..obs.trace import Tracer
from ..serving.driver import QueueFull, ServeDriver
from ..serving.engine import ARServeEngine, DiffusionServeEngine, Request
from ..training import checkpoint as CKPT
from .mesh import init_process_group


def make_http_server(driver: ServeDriver, port: int = 0):
    """HTTP-ish transport: a threaded stdlib server feeding the driver.

    GET /metrics returns the full serving registry (engine + driver) in the
    Prometheus text exposition format; GET /stats returns the driver's
    summary counters as JSON.

    POST /v1/generate with a JSON body of Request fields (seq_len, nfe,
    solver, eta, seed, priority, deadline_s). Set ``"stream": true`` for an
    NDJSON response: one ``{"event":"step","k":..,"n_steps":..}`` line per
    solver step of the request (its own progress, even inside a ragged
    group), then a ``{"event":"result",...}`` line with tokens and the
    latency/NFE accounting. Without ``stream``, one JSON document with the
    final result. Invalid requests get a 400 carrying the engine's
    validation message. Returns the (not yet serving) HTTPServer; callers
    run ``serve_forever()`` (and may read the bound port off
    ``server.server_address`` when asking for port 0).

    Every handler thread only ever touches the driver's thread-safe
    ``submit``/``cancel``/``stats``, the returned handle and the metrics
    registry -- the device stays on the scheduler thread.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    uids = itertools.count()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.0"   # close-delimited streaming bodies

        def log_message(self, *a):       # keep scheduler logs readable
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            # Scrape routes. Handler threads only READ the shared registry
            # (counter/gauge reads are single attribute loads under the GIL;
            # snapshot copies) -- the scheduler thread stays the one writer.
            if self.path == "/metrics":
                body = to_prometheus(driver.engine.metrics).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if self.path == "/stats":
                return self._json(200, driver.stats())
            return self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path in ("/cancel", "/v1/cancel"):
                # body {"uid": n}: best-effort cancellation of an in-flight
                # request (uids are server-assigned; streaming clients read
                # theirs off the NDJSON step lines). Races with completion
                # resolve in favor of the sample -- "cancelled": false then.
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    body = json.loads(self.rfile.read(n) or b"{}")
                    uid = int(body["uid"])
                except (KeyError, ValueError, TypeError,
                        json.JSONDecodeError) as e:
                    return self._json(400, {"error": f"bad cancel body: {e}"})
                return self._json(200, {"uid": uid,
                                        "cancelled": driver.cancel(uid)})
            if self.path not in ("/generate", "/v1/generate"):
                return self._json(404, {"error": f"no route {self.path}"})
            try:
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n) or b"{}")
                req = Request(
                    uid=next(uids),
                    seq_len=int(body.get("seq_len", 32)),
                    nfe=int(body.get("nfe", 10)),
                    solver=str(body.get("solver", "tab3")),
                    eta=body.get("eta"),
                    seed=int(body.get("seed", 0)),
                    priority=int(body.get("priority", 0)),
                    deadline_s=body.get("deadline_s"))
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                return self._json(400, {"error": f"bad request body: {e}"})
            handle = driver.submit(req)
            if not body.get("stream"):
                try:
                    res = handle.result()
                except QueueFull as e:                 # backpressure shed
                    return self._json(429, {"error": str(e)})
                except (ValueError, TypeError) as e:   # request validation
                    return self._json(400, {"error": str(e)})
                except Exception as e:   # server fault (e.g. failed tick)
                    return self._json(500, {"error": str(e)})
                return self._json(200, _result_json(res))
            # backpressure shed resolves the handle synchronously at submit;
            # catch it BEFORE streaming headers so clients get the documented
            # 429 instead of a 200 with a generic error event
            if handle.done():
                try:
                    handle.result()
                except QueueFull as e:
                    return self._json(429, {"error": str(e)})
                except Exception:
                    pass        # other early failures stream as error events
            # NDJSON streaming: headers first, then a line per step event
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            for ev in handle:
                line = {"event": "step", "uid": req.uid, "k": ev.k,
                        "n_steps": ev.n_steps}
                if ev.tokens is not None:
                    line["tokens"] = np.asarray(ev.tokens).tolist()
                # +inf (no estimate yet) has no strict-JSON literal: the
                # err field appears only once a genuine estimate exists
                if ev.row_err is not None and np.isfinite(ev.row_err[0]):
                    line["err"] = float(ev.row_err[0])
                self.wfile.write((json.dumps(line) + "\n").encode())
                self.wfile.flush()
            try:
                res = handle.result()
            except Exception as e:
                self.wfile.write((json.dumps(
                    {"event": "error", "uid": req.uid, "error": str(e)})
                    + "\n").encode())
                return
            self.wfile.write((json.dumps(
                {"event": "result", **_result_json(res)}) + "\n").encode())

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def _result_json(res) -> dict:
    return {"uid": res.uid, "tokens": np.asarray(res.tokens).tolist(),
            "latency_s": res.latency_s, "nfe": res.nfe,
            "compile_s": res.compile_s, "early_exit": res.early_exit,
            "final_err": res.final_err}


async def _driver_demo(driver: ServeDriver, n_requests: int, seq_len: int):
    """Mixed-priority ragged-NFE workload over ``submit_async``."""
    nfes = [4, 8, 12]
    handles = []
    for i in range(n_requests):
        req = Request(uid=i, seq_len=seq_len, nfe=nfes[i % len(nfes)],
                      solver="ddim", seed=i, priority=i % 2,
                      deadline_s=2.0 if i % 2 else None)
        handles.append(await driver.submit_async(req))

    async def consume(h):
        async for ev in h:
            print(f"  req {h.uid}: step {ev.k}/{ev.n_steps}")
        res = await h.result()
        print(f"req {res.uid}: nfe={res.nfe} solve={res.latency_s:.2f}s")
        return res

    return await asyncio.gather(*[consume(h) for h in handles])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS + PORT_ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", choices=["ar", "diffusion"], default="diffusion")
    ap.add_argument("--transport", choices=["sync", "driver", "http"],
                    default="sync")
    ap.add_argument("--port", type=int, default=8433)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--nfe", type=int, default=10)
    ap.add_argument("--solver", default="tab3")
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--steps-per-tick", type=int, default=None,
                    help="throttle: groups stepped per tick (enables EDF)")
    ap.add_argument("--no-compaction", action="store_true")
    ap.add_argument("--no-join", action="store_true",
                    help="disable continuous admission (joining pending "
                         "requests into in-flight groups at compaction "
                         "boundaries)")
    ap.add_argument("--seq-len-buckets", default=None,
                    help="comma-separated ascending edges (e.g. 32,64,128): "
                         "request seq_lens round up to a bucket edge so "
                         "nearby lengths share one compiled executor; "
                         "decodes are masked back to each request's length")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="driver backpressure: bound on in-flight requests; "
                         "over it, submits are shed with QueueFull (HTTP 429)")
    ap.add_argument("--early-exit-tol", type=float, default=None,
                    help="retire rows early once their embedded local-error "
                         "estimate drops to TOL (plans compile with "
                         "error_estimate=True; solvers without an embedded "
                         "pair always run their full budget). Results carry "
                         "early_exit/final_err; saved NFEs are counted in "
                         "serve_saved_nfe_total")
    ap.add_argument("--early-exit-min-k", type=int, default=2,
                    help="own-steps floor before the estimate is trusted")
    ap.add_argument("--early-exit-norm", choices=["abs", "rel"], default="abs",
                    help="abs: err <= tol; rel: err <= tol * |x|_inf per row")
    ap.add_argument("--enforce-deadlines", action="store_true",
                    help="evict requests whose absolute deadline passes "
                         "(pending or mid-flight); each evicted request "
                         "fails with DeadlineExceeded on its own handle")
    ap.add_argument("--metrics-ndjson", default=None, metavar="PATH",
                    help="append NDJSON metric snapshots to PATH: every "
                         "--metrics-interval seconds for the http transport, "
                         "one final snapshot for sync/driver")
    ap.add_argument("--metrics-interval", type=float, default=5.0,
                    help="seconds between NDJSON snapshots (http transport)")
    ap.add_argument("--trace-annotate", action="store_true",
                    help="mirror engine spans into torch.profiler "
                         "record_function ranges so they attach to device "
                         "work in torch.profiler traces")
    ap.add_argument("--data-parallel", action="store_true",
                    help="shard stacked solves over the request axis on a "
                         "('data',) mesh over every rank (one process per "
                         "device, e.g. under torchrun; without its "
                         "environment, a one-rank group in this process)")
    ap.add_argument("--dist-init-method", default="env://",
                    help="init method of the process group under a "
                         "launcher's RANK / WORLD_SIZE environment (default "
                         "env://, the MASTER_ADDR / MASTER_PORT torchrun sets)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs "
                         "the port on the CPU explicitly)")
    args = ap.parse_args(argv)
    sharded = args.data_parallel and args.mode == "diffusion"
    if sharded:
        device = init_process_group(args.device, args.dist_init_method)
    else:
        device = resolve_device(args.device)
    try:
        _serve(args, device, sharded)
        if sharded:
            dist.barrier()      # every rank past its last collective before teardown
    finally:
        if sharded and dist.is_initialized():   # a mesh engine that failed
            dist.destroy_process_group()        # closed has destroyed it


def _serve(args, device, sharded: bool) -> None:
    leader = not sharded or dist.get_rank() == 0

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.with_(objective="diffusion" if args.mode == "diffusion" else "ar")
    params = T.init_params(cfg, 0, device)
    if args.ckpt_dir and leader:    # a sharded engine broadcasts rank 0's
        params, _ = CKPT.restore(args.ckpt_dir, params)
        print(f"restored params from {args.ckpt_dir}")

    if args.mode == "diffusion":
        mesh = None
        if sharded:
            from .mesh import make_request_mesh
            mesh = make_request_mesh()
            if leader:
                print(f"request-parallel mesh: {dist.get_world_size()} devices on "
                      "axis 'data' (group sizes round up to multiples)")
        buckets = tuple(int(e) for e in args.seq_len_buckets.split(",")) \
            if args.seq_len_buckets else None
        retire = None
        if args.early_exit_tol is not None:
            from ..core.adaptive import RetirePolicy
            retire = RetirePolicy(tol=args.early_exit_tol,
                                  min_k=args.early_exit_min_k,
                                  norm=args.early_exit_norm)
            if leader:
                print(f"early exit on: {retire}")
        eng = DiffusionServeEngine(params, cfg,
                                   steps_per_tick=args.steps_per_tick,
                                   compaction=not args.no_compaction,
                                   join=not args.no_join,
                                   seq_len_buckets=buckets, mesh=mesh,
                                   enforce_deadlines=args.enforce_deadlines,
                                   retire=retire, device=device)
        if not leader:
            eng.follow()
            return
        try:
            _serve_diffusion(args, cfg, eng, retire)
        finally:
            eng.close()
    else:
        eng = ARServeEngine(params, cfg, max_len=args.seq_len + args.max_new,
                            device=device)
        rng = np.random.RandomState(0)
        reqs = [Request(uid=i, prompt=rng.randint(0, cfg.vocab_size, 8),
                        max_new_tokens=args.max_new) for i in range(args.requests)]
        results = eng.serve(reqs)
        for r in results[:4]:
            print(f"req {r.uid}: latency={r.latency_s:.2f}s tokens={r.tokens[:10]}")
        print(f"served {len(results)} requests")


def _serve_diffusion(args, cfg, eng, retire) -> None:
    """The diffusion transports over ``eng`` (on the leader under a mesh)."""
    if args.trace_annotate:
        eng.tracer = Tracer(eng.metrics, annotate=True)
    exporter = NdjsonExporter(args.metrics_ndjson,
                              extra={"arch": args.arch}) \
        if args.metrics_ndjson else None
    if args.transport == "http":
        with ServeDriver(eng, max_pending=args.max_pending) as driver:
            server = make_http_server(driver, args.port)
            host, port = server.server_address
            print(f"serving DEIS on http://{host}:{port}/v1/generate "
                  "(POST JSON; GET /metrics for Prometheus text; "
                  "Ctrl-C to stop)")
            stop_snap = threading.Event()
            if exporter is not None:
                def _snap_loop():
                    while not stop_snap.wait(args.metrics_interval):
                        exporter.write(eng.metrics)
                threading.Thread(target=_snap_loop, daemon=True,
                                 name="metrics-ndjson").start()
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                stop_snap.set()
                server.shutdown()
                if exporter is not None:
                    exporter.write(eng.metrics)   # final snapshot
                    exporter.close()
        return
    if args.transport == "driver":
        with ServeDriver(eng, max_pending=args.max_pending) as driver:
            results = asyncio.run(
                _driver_demo(driver, args.requests, args.seq_len))
            print(f"served {len(results)} requests; "
                  f"stats={driver.stats()}")
        if exporter is not None:
            exporter.write(eng.metrics)
            exporter.close()
        return
    reqs = [Request(uid=i, seq_len=args.seq_len, nfe=args.nfe,
                    solver=args.solver, seed=i) for i in range(args.requests)]
    results = eng.serve(
        reqs, on_step=lambda e: print(
            f"  step {e.k}/{e.n_steps} for uids {e.uids}"))
    for r in results[:4]:
        print(f"req {r.uid}: nfe={r.nfe} solve={r.latency_s:.2f}s "
              f"compile={r.compile_s:.2f}s early_exit={r.early_exit} "
              f"tokens[:10]={r.tokens[:10]}")
    print(f"served {len(results)} requests")
    if retire is not None:
        m = eng.metrics
        print(f"early exits: "
              f"{int(m.get('serve_early_exit_total').value)}/"
              f"{len(results)}, saved NFEs: "
              f"{int(m.get('serve_saved_nfe_total').value)}")
    if exporter is not None:
        exporter.write(eng.metrics)
        exporter.close()


if __name__ == "__main__":
    main()
