"""The port's ServeDriver and HTTP transport on the CPU (reduced gemma-2b,
float32): the transport contracts of ``tests/test_driver.py`` (streams
bitwise equal to the sync engine, async submission, per-request
validation errors, surviving a tick crash through ``reset()``, duplicate
in-flight uids, backpressure on the sync and async paths), the HTTP round
trip with ``/v1/cancel``, ``/metrics``, ``/stats`` and 404, and one test
across frameworks: the JAX package's server and the port's, given the same
bodies, answer with the same status codes, event kinds, ``k`` sequences,
JSON keys and metric names (the port adds ``driver_crash_total``). Tokens
are compared bitwise within the port only (the frameworks draw different
priors)."""
import asyncio
import contextlib
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.launch.serve import make_http_server as ref_make_http_server
from repro.models import transformer as RT
from repro.serving.driver import ServeDriver as RefServeDriver
from repro.serving.engine import DiffusionServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.launch.serve import make_http_server
from repro_torch.models.transformer import init_params
from repro_torch.serving.driver import QueueFull, ServeDriver
from repro_torch.serving.engine import DiffusionServeEngine, Request

CFG = get_config("gemma_2b").reduced().with_(objective="diffusion")


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, 0, "cpu")


def _engine(params, **kw):
    return DiffusionServeEngine(params, CFG, device="cpu", **kw)


def test_driver_streams_and_matches_sync_engine(params):
    eng = _engine(params)
    with ServeDriver(eng) as drv:
        h1 = drv.submit(Request(uid=0, seq_len=8, nfe=3, solver="ddim", seed=1))
        h2 = drv.submit(Request(uid=1, seq_len=8, nfe=6, solver="ddim", seed=2))
        evs = list(h1.events())
        assert [e.k for e in evs] == [1, 2, 3]          # own step count
        assert all(e.n_steps == 3 and e.uids == (0,) for e in evs)
        r1, r2 = h1.result(), h2.result()
    assert (r1.nfe, r2.nfe) == (3, 6)
    sync = _engine(params)
    s1 = sync.serve([Request(uid=0, seq_len=8, nfe=3, solver="ddim", seed=1)])
    s2 = sync.serve([Request(uid=1, seq_len=8, nfe=6, solver="ddim", seed=2)])
    np.testing.assert_array_equal(r1.tokens, s1[0].tokens)
    np.testing.assert_array_equal(r2.tokens, s2[0].tokens)


def test_driver_streams_decodes_as_numpy(params):
    """With stream_decode each event carries the request's own partial
    decode as a numpy row cut to its true length (a bucketed solve)."""
    eng = _engine(params, seq_len_buckets=(8, 16))
    with ServeDriver(eng, stream_decode=True) as drv:
        h = drv.submit(Request(uid=3, seq_len=11, nfe=4, solver="tab2", seed=4))
        evs = list(h)
        res = h.result()
    assert [e.k for e in evs] == [1, 2, 3, 4]
    assert all(isinstance(e.tokens, np.ndarray) and e.tokens.shape == (11,) for e in evs)
    np.testing.assert_array_equal(evs[-1].tokens, res.tokens)


def test_driver_async_submission(params):
    eng = _engine(params)

    async def go(drv):
        h = await drv.submit_async(
            Request(uid=7, seq_len=8, nfe=4, solver="euler", seed=3))
        ks = [ev.k async for ev in h]
        return ks, await h.result()

    with ServeDriver(eng) as drv:
        ks, res = asyncio.run(go(drv))
    assert ks == [1, 2, 3, 4] and res.nfe == 4 and res.tokens.shape == (8,)


def test_driver_validation_error_is_per_request(params):
    eng = _engine(params)
    with ServeDriver(eng) as drv:
        good = drv.submit(Request(uid=0, seq_len=8, nfe=3, solver="ddim", seed=0))
        bad = drv.submit(Request(uid=1, seq_len=8, nfe=3, solver="nope"))
        with pytest.raises(ValueError, match="unknown solver"):
            bad.result(timeout=30)
        assert list(bad.events()) == []               # stream closed, empty
        assert good.result().tokens.shape == (8,)
        with pytest.raises(ValueError, match="eta"):
            drv.submit(Request(uid=2, seq_len=8, nfe=3,
                               solver="ddim_eta")).result(timeout=30)


def test_driver_survives_tick_crash(params):
    """A tick that raises fails the in-flight futures, resets the engine
    (``reset()``), counts ``driver_crash_total`` and keeps serving."""
    eng = _engine(params)
    real_tick = eng.tick
    boom = {"armed": True}

    def exploding_tick(**kw):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("device fell over")
        return real_tick(**kw)

    eng.tick = exploding_tick
    with ServeDriver(eng) as drv:
        h = drv.submit(Request(uid=0, seq_len=8, nfe=3, solver="ddim", seed=0))
        with pytest.raises(RuntimeError, match="fell over"):
            h.result(timeout=60)
        assert list(h.events()) == []                 # stream closed
        assert not eng.busy                           # reset() cleared the queues
        h2 = drv.submit(Request(uid=1, seq_len=8, nfe=3, solver="ddim", seed=0))
        assert h2.result(timeout=120).tokens.shape == (8,)
        assert eng.metrics.get("driver_crash_total").value == 1


def test_engine_reset_clears_queues(params):
    eng = _engine(params)
    for i in range(3):
        eng.submit(Request(uid=i, seq_len=8, nfe=4, solver="ddim", seed=i))
    eng.tick()
    eng.submit(Request(uid=9, seq_len=8, nfe=4, solver="ddim", seed=9))
    eng.cancel(0)
    assert eng.busy
    eng.reset()
    assert not eng.busy and eng.tick() == []
    snap = eng.metrics.snapshot()
    assert (snap["serve_queue_depth"], snap["serve_active_groups"],
            snap["serve_group_occupancy"]) == (0, 0, 0)
    assert eng.num_executors == 1                     # caches survive


def test_driver_rejects_duplicate_inflight_uid(params):
    eng = _engine(params)
    with ServeDriver(eng) as drv:
        h = drv.submit(Request(uid=5, seq_len=8, nfe=3, solver="ddim", seed=0))
        with pytest.raises(ValueError, match="already"):
            drv.submit(Request(uid=5, seq_len=8, nfe=3, solver="ddim", seed=1))
        h.result()
        drv.submit(Request(uid=5, seq_len=8, nfe=3, solver="ddim", seed=1)).result()


def test_driver_backpressure_sheds_over_max_pending(params):
    eng = _engine(params)
    with ServeDriver(eng, max_pending=2) as drv:
        h1 = drv.submit(Request(uid=0, seq_len=8, nfe=3, solver="ddim", seed=1))
        h2 = drv.submit(Request(uid=1, seq_len=8, nfe=3, solver="ddim", seed=2))
        shed = drv.submit(Request(uid=2, seq_len=8, nfe=3, solver="ddim", seed=3))
        assert shed.done()
        with pytest.raises(QueueFull, match="max_pending"):
            shed.result(timeout=1)
        assert list(shed.events()) == []
        r1, r2 = h1.result(), h2.result()
        assert r1.tokens.shape == (8,) and r2.tokens.shape == (8,)
        again = drv.submit(Request(uid=2, seq_len=8, nfe=3, solver="ddim", seed=3))
        assert again.result(timeout=120).tokens.shape == (8,)
        want = _engine(params).serve([Request(uid=2, seq_len=8, nfe=3, solver="ddim",
                                              seed=3)])[0]
        np.testing.assert_array_equal(again.result().tokens, want.tokens)
        assert drv.stats()["shed"] == 1


def test_driver_backpressure_async_path(params):
    eng = _engine(params)

    async def go(drv):
        h1 = await drv.submit_async(Request(uid=0, seq_len=8, nfe=4, solver="ddim", seed=0))
        shed = await drv.submit_async(Request(uid=1, seq_len=8, nfe=4, solver="ddim", seed=1))
        assert shed.done()
        evs = [ev async for ev in shed]
        with pytest.raises(QueueFull, match="shed"):
            await shed.result()
        return evs, await h1.result()

    with ServeDriver(eng, max_pending=1) as drv:
        evs, res = asyncio.run(go(drv))
    assert evs == [] and res.tokens.shape == (8,)


def test_driver_scheduler_thread_runs_without_grad(params):
    """Grad mode is per thread in PyTorch: the scheduler thread runs its
    loop under no_grad even when the caller's thread records autograd."""
    seen = []
    eng = _engine(params)
    real_tick = eng.tick

    def tick(**kw):
        seen.append(torch.is_grad_enabled())
        return real_tick(**kw)

    eng.tick = tick
    assert torch.is_grad_enabled()
    with ServeDriver(eng) as drv:
        drv.submit(Request(uid=0, seq_len=8, nfe=2, solver="ddim", seed=0)).result()
    assert seen and not any(seen)


# ----------------------------------------------------------------- HTTP
@contextlib.contextmanager
def _http(server_fn, driver):
    server = server_fn(driver, 0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()


def _call(url, body=None, raw=None):
    """(status, decoded body) of a GET (body None) or a POST."""
    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    try:
        resp = urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=300)
        return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _lines(text):
    return [json.loads(ln) for ln in text.strip().split("\n")]


def _metric_names(text):
    return {ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")}


def test_http_transport_roundtrip(params):
    eng = _engine(params)
    with ServeDriver(eng) as drv, _http(make_http_server, drv) as base:
        url = f"{base}/v1/generate"
        body = {"seq_len": 8, "nfe": 3, "solver": "ddim", "seed": 1}
        code, text = _call(url, body)
        out = json.loads(text)
        assert code == 200 and out["nfe"] == 3 and len(out["tokens"]) == 8
        want = _engine(params).serve([Request(uid=0, seq_len=8, nfe=3, solver="ddim",
                                              seed=1)])[0]
        assert out["tokens"] == want.tokens.tolist()      # bitwise the sync engine

        code, text = _call(url, {**body, "stream": True})
        objs = _lines(text)
        assert [o["event"] for o in objs] == ["step"] * 3 + ["result"]
        assert [o["k"] for o in objs[:-1]] == [1, 2, 3]
        assert objs[-1]["tokens"] == out["tokens"]

        code, text = _call(url, {**body, "solver": "nope", "stream": True})
        assert code == 200 and _lines(text)[-1]["event"] == "error"
        assert _call(url, {**body, "solver": "nope"})[0] == 400
        assert _call(url, raw=b"{not json")[0] == 400
        assert _call(f"{base}/nope")[0] == 404
        assert _call(f"{base}/v1/nope", body)[0] == 404

        code, text = _call(f"{base}/stats")
        stats = json.loads(text)
        assert code == 200 and stats["completed"] == 2 and stats["submitted"] == 4
        code, text = _call(f"{base}/metrics")
        assert code == 200
        assert {"serve_completed_total", "driver_submitted_total", "driver_loop_seconds",
                "driver_crash_total"} <= _metric_names(text)
        assert "serve_completed_total 2\n" in text


def test_http_cancel_and_backpressure(params):
    """A long streamed request is cancelled through POST /v1/cancel: the
    answer says ``cancelled: true`` and the stream ends in an error event.
    While it runs, a second request is shed with 429 (max_pending 1)."""
    eng = _engine(params)
    with ServeDriver(eng, max_pending=1) as drv, _http(make_http_server, drv) as base:
        resp = urllib.request.urlopen(urllib.request.Request(
            f"{base}/v1/generate", data=json.dumps(
                {"seq_len": 8, "nfe": 2000, "solver": "ddim", "stream": True}).encode()),
            timeout=300)
        first = json.loads(resp.readline())
        assert first["event"] == "step" and first["k"] == 1
        code, text = _call(f"{base}/v1/generate", {"seq_len": 8, "nfe": 2})
        assert code == 429 and "max_pending" in json.loads(text)["error"]
        code, text = _call(f"{base}/v1/cancel", {"uid": first["uid"]})
        assert code == 200 and json.loads(text) == {"uid": first["uid"], "cancelled": True}
        rest = _lines(resp.read().decode())
        assert rest[-1]["event"] == "error" and "cancelled" in rest[-1]["error"]
        assert all(o["event"] == "step" for o in rest[:-1])
        assert json.loads(_call(f"{base}/v1/cancel", {"uid": first["uid"]})[1])["cancelled"] is False
        assert _call(f"{base}/v1/cancel", {"nope": 1})[0] == 400
        stats = json.loads(_call(f"{base}/stats")[1])
        assert (stats["submitted"], stats["shed"], stats["cancelled"], stats["completed"]) == (1, 1, 1, 0)


def _ref_driver():
    rcfg = ref_get_config("gemma_2b").reduced().with_(objective="diffusion")
    return RefServeDriver(RefEngine(RT.init_params(rcfg, jax.random.PRNGKey(0)), rcfg),
                          max_pending=1)


def _transport_session(server_fn, driver):
    """The same bodies against a server; returns what the frameworks must
    agree on (status codes, event kinds, k sequences, JSON keys, metric
    names)."""
    seen = []
    body = {"seq_len": 8, "nfe": 3, "solver": "ddim", "seed": 1}
    with driver, _http(server_fn, driver) as base:
        url = f"{base}/v1/generate"
        code, text = _call(url, body)
        seen.append(("json", code, sorted(json.loads(text))))
        code, text = _call(url, {**body, "solver": "tab2", "nfe": 4, "stream": True})
        objs = _lines(text)
        seen.append(("stream", code, [o["event"] for o in objs], [o.get("k") for o in objs],
                     [sorted(o) for o in objs]))
        code, text = _call(url, {**body, "solver": "nope", "stream": True})
        seen.append(("stream-bad", code, [o["event"] for o in _lines(text)]))
        for b in ({**body, "solver": "nope"}, {**body, "solver": "ddim_eta"},
                  {**body, "nfe": "x"}):
            code, text = _call(url, b)
            seen.append(("bad", code, sorted(json.loads(text))))
        seen.append(("raw", _call(url, raw=b"[")[0]))
        seen.append(("404", _call(f"{base}/x")[0], _call(f"{base}/x", body)[0]))
        resp = urllib.request.urlopen(urllib.request.Request(url, data=json.dumps(
            {**body, "nfe": 5000, "stream": True}).encode()), timeout=600)
        first = json.loads(resp.readline())
        seen.append(("429", _call(url, body)[0]))
        code, text = _call(f"{base}/v1/cancel", {"uid": first["uid"]})
        seen.append(("cancel", code, json.loads(text)["cancelled"]))
        seen.append(("cancelled", [o["event"] for o in _lines(resp.read().decode())][-1]))
        seen.append(("cancel-bad", _call(f"{base}/v1/cancel", {})[0]))
        code, text = _call(f"{base}/stats")
        stats = json.loads(text)
        seen.append(("stats", code, sorted(stats)))
        seen.append(("counts", {k: stats[k] for k in ("submitted", "shed", "cancelled",
                                                       "completed", "in_flight")}))
        code, text = _call(f"{base}/metrics")
        names = _metric_names(text)
    return seen, names


def test_transport_matches_reference_server(params):
    got, port_names = _transport_session(make_http_server,
                                         ServeDriver(_engine(params), max_pending=1))
    want, ref_names = _transport_session(ref_make_http_server, _ref_driver())
    assert got == want
    assert port_names == ref_names | {"driver_crash_total"}
