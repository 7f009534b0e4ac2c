"""Request-axis data parallelism of the port on the CPU: 2 and 4 gloo ranks
on reduced gemma-2b, the counterparts of the JAX package's 8-device mesh
scripts (``tests/test_sharded_executor.py``, ``tests/test_serving_fuzz.py``).

The reference's own sharded path fails on the installed jax, so the port is
held to the UNSHARDED engine, which the reference claims equal: on the CPU
the port's eps-net is batch-invariant bitwise, so every sharded solve must
equal the port's own unsharded one bitwise -- under ragged NFE, joins,
compaction, early exit, cancels and deadlines, with every group's batch a
multiple of the data size w and no new executor on a warm replay. One case
goes across frameworks: the sharded engine against the reference's
unsharded ``DiffusionServeEngine`` on the reference's weights and priors
(tokens equal, as ``tests/test_torch_serving.py`` holds the one-shot
stream).

Each world size is one spawn of w processes (a ``file://`` store under
``tmp_path``, a time limit of its own); the child runs every check in turn
and each rank writes each check's outcome, reported here as one case each
(ok only when ok on every rank). The last check fails the mesh on purpose:
rank 0's tick raises mid-tick, and every rank must leave its collectives.
"""
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.gemma_2b import get_config as ref_config
from repro.core import VPSDE as RVPSDE
from repro.core import make_plan as ref_make_plan
from repro.core import stack_plans as ref_stack
from repro.diffusion import lm as RLM
from repro.models.transformer import init_params as ref_init
from repro.serving.engine import DiffusionServeEngine as RefEngine
from repro.serving.engine import Request as RefRequest
from repro_torch.configs import get_config
from repro_torch.core import get_timesteps
from repro_torch.launch import mesh as M
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import DiffusionServeEngine, Request

SRC = str(Path(__file__).resolve().parents[1] / "src")
SPAWN_TIMEOUT_S = 240
CFG = get_config("gemma_2b").reduced().with_(objective="diffusion")
# across frameworks: deterministic ab requests, no buckets (the prior is the
# reference's own draw at the request's length, injected into the port)
REF_REQUESTS = [dict(uid=i, seq_len=12, nfe=[3, 6][i % 2], solver="tab2", seed=20 + i)
                for i in range(4)]


def spawn(script: str, world: int, tmp: Path, timeout: float = SPAWN_TIMEOUT_S,
          args=()) -> list[str]:
    """Run ``script`` as ranks 0..world-1 of a gloo group over a ``file://``
    store in ``tmp``; each rank's output goes to its own log. Returns the
    logs; raises when a rank fails or the time limit passes (every rank is
    killed then)."""
    path = tmp / "child.py"
    path.write_text(script)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1")
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(path), str(r), str(world), str(tmp / "store"),
                 *map(str, args)], stdout=f, stderr=subprocess.STDOUT, env=env))
    end = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = [log.read_text() for log in logs]
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"ranks exited {codes}:\n" + "\n".join(
            f"--- rank {r}\n{t[-4000:]}" for r, t in enumerate(text)))
    return text


_CHILD = r'''
import faulthandler, json, sys, traceback
import numpy as np
import torch
import torch.distributed as dist

rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
ref_path, out_path = sys.argv[4], sys.argv[5]
torch.set_num_threads(1)
faulthandler.dump_traceback_later(float(sys.argv[6]), exit=True)   # a hang shows where
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
from repro_torch.configs import get_config
from repro_torch.core import (RetirePolicy, VPSDE, get_timesteps, init_state,
                              make_plan, sample, stack_plans, step)
from repro_torch.core import sampler as S
from repro_torch.core.plan import join_rows, take_rows
from repro_torch.diffusion import lm as DLM
from repro_torch.diffusion.analytic import GaussianData
from repro_torch.launch.mesh import (control_group, make_host_mesh,
                                     make_request_mesh, mesh_fingerprint)
from repro_torch.models.transformer import init_params
from repro_torch.serving.driver import ServeDriver
from repro_torch.serving.engine import DiffusionServeEngine, Request

MESH = make_request_mesh()
LEAD = rank == 0
CFG = get_config("gemma_2b").reduced().with_(objective="diffusion")
PARAMS = init_params(CFG, 0, "cpu")
SDE = VPSDE()
results, extra = {}, {}


def check(fn):
    try:
        fn()
        results[fn.__name__] = "ok"
    except Exception:
        results[fn.__name__] = traceback.format_exc()
    return fn


def sharded(drive, **kw):
    """drive(eng) on the leader over a mesh engine (the others follow);
    the leader's value, None elsewhere."""
    eng = DiffusionServeEngine(PARAMS, CFG, mesh=MESH, device="cpu", **kw)
    if not LEAD:
        eng.follow()
        return None, eng
    try:
        return drive(eng), eng
    except Exception:
        traceback.print_exc()       # the followers now wait in a collective
        sys.stdout.flush()
        raise
    finally:
        eng.close()


def plain(**kw):
    return DiffusionServeEngine(PARAMS, CFG, device="cpu", **kw)


def by_uid(res):
    return {r.uid: r for r in res}


def same_tokens(got, want):
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens, err_msg=str(uid))


def drive_ticks(workload):
    """Submit at arrival ticks, tick until drained."""
    def run(eng):
        pending = sorted(workload, key=lambda a: a[0])
        i, t, res = 0, 0, []
        while i < len(pending) or eng.busy:
            while i < len(pending) and pending[i][0] <= t:
                eng.submit(pending[i][1])
                i += 1
            res += eng.tick()
            t += 1
            assert t < 2000
        return by_uid(res)
    return run


@check
def mesh_and_fingerprint():
    fp = mesh_fingerprint(MESH)
    assert fp == ((("data", world),), tuple(range(world))), fp
    fps = [None] * world
    dist.all_gather_object(fps, fp)
    assert all(f == fp for f in fps)
    host = make_host_mesh(model=1)
    assert mesh_fingerprint(host) != fp
    assert control_group(MESH) is control_group(MESH)


@check
def sample_and_step_bitwise():
    ts = get_timesteps(SDE, 6, "quadratic")
    eps = GaussianData(SDE, mean=np.full(4, 1.5), var=np.full(4, 0.25)).eps_fn()
    n = 8
    xT = torch.randn((n, 4), generator=torch.Generator().manual_seed(0)) * SDE.prior_std()
    plans = [make_plan("em", SDE, ts) if i % 2 else
             make_plan("ddim_eta", SDE, ts, eta=1.0) for i in range(n)]
    stacked = stack_plans(plans)
    gens = lambda: [torch.Generator().manual_seed(100 + i) for i in range(n)]
    want = sample(stacked, eps, xT, gens())
    g_mesh = gens()
    got = sample(stacked, eps, xT, g_mesh, mesh=MESH)
    assert torch.equal(got, want)
    g_plain = gens()
    sample(stacked, eps, xT, g_plain)
    for a, b in zip(g_mesh, g_plain):      # every generator ends where the plain solve's does
        assert torch.equal(a.get_state(), b.get_state())
    for i in range(n):
        solo = sample(stack_plans([plans[i]]), eps, xT[i:i + 1],
                      [torch.Generator().manual_seed(100 + i)])
        assert torch.equal(got[i], solo[0]), i
    # per-step with a per-row k vector (rows at different counts)
    k0 = [i % 3 for i in range(n)]
    st_p = init_state(stacked, xT, gens())
    st_m = init_state(stacked, xT, gens())
    for k in range(stacked.n_steps - 2):
        kv = [k + d for d in k0]
        st_p = step(stacked, kv, st_p, eps)
        st_m = step(stacked, kv, st_m, eps, mesh=MESH)
        assert torch.equal(st_m.x, st_p.x) and torch.equal(st_m.hist, st_p.hist)
        assert torch.equal(st_m.err, st_p.err)


@check
def splices_move_rows():
    """take/join with shardings give each rank its block of the unsharded
    splice, uneven intermediate layouts included."""
    ts = get_timesteps(SDE, 5, "quadratic")
    n = 2 * world
    plans = [make_plan("em", SDE, ts) for _ in range(n)]
    stacked = stack_plans(plans)
    gens = DLM.request_generators(list(range(n)), "cpu")
    whole = DLM.init_sample_state(CFG, stacked, gens, seq_len=6, prior_std=1.0)
    whole = whole._replace(
        hist=torch.randn((2,) + tuple(whole.x.shape), generator=torch.Generator().manual_seed(1)),
        err=torch.arange(n, dtype=torch.float32))
    plan_sh, state_sh = S._request_shardings(stacked, whole, MESH)
    p_local, s_local = S.shard_state(stacked, whole, MESH)
    keep = [i for i in range(n) if i % 3 != 1]          # len not a multiple of w
    t_whole = S.take_state_rows(whole, keep)
    t_local = S.take_state_rows(s_local, keep, shardings=state_sh)
    extra_rows = (-len(keep)) % world + world
    new_plans = [make_plan("em", SDE, ts) for _ in range(extra_rows)]
    new = DLM.init_sample_state(CFG, stack_plans(new_plans),
                                DLM.request_generators([50 + i for i in range(extra_rows)], "cpu"),
                                seq_len=6, prior_std=1.0)
    new = new._replace(hist=torch.zeros((2,) + tuple(new.x.shape)))
    j_whole = S.join_state_rows(t_whole, new)
    j_local = S.join_state_rows(t_local, new, shardings=state_sh)
    # keep and join in one row move, as the engine's join does
    one_whole = S.join_state_rows(whole, new, rows=keep)
    one_local = S.join_state_rows(s_local, new, shardings=state_sh, rows=keep)
    # every collective is behind us: the checks
    for local, ref in ((t_local, t_whole), (j_local, j_whole), (one_local, j_whole),
                       (S.place_state(one_whole, state_sh), j_whole)):
        m = ref.x.shape[0]
        lo, hi = rank * m // world, (rank + 1) * m // world
        assert torch.equal(local.x, ref.x[lo:hi])
        assert torch.equal(local.hist, ref.hist[:, lo:hi])
        assert torch.equal(local.err, ref.err[lo:hi])
        assert len(local.key) == hi - lo
        for a, b in zip(local.key, ref.key[lo:hi]):
            assert torch.equal(a.get_state(), b.get_state())
    mine = slice(rank * 2, (rank + 1) * 2)          # shard_state: this rank's 2 of 2w rows
    assert torch.equal(s_local.x, whole.x[mine]) and torch.equal(p_local.ts, stacked.ts[mine])
    assert torch.equal(s_local.hist, whole.hist[:, mine]) and s_local.key == whole.key[mine]
    assert j_whole.x.shape[0] % world == 0
    m = j_whole.x.shape[0]
    p_take = take_rows(stacked, keep)
    p_join = join_rows(p_take, new_plans, shardings=plan_sh)
    assert torch.equal(p_join.ts, join_rows(p_take, new_plans).ts[rank * m // world:
                                                                 (rank + 1) * m // world])
    assert torch.equal(take_rows(stacked, list(range(n)), shardings=plan_sh).coeffs["s"],
                       stacked.coeffs["s"][rank * 2:(rank + 1) * 2])


@check
def max_group_below_data_size_raises():
    if world == 1:
        return
    try:
        DiffusionServeEngine(PARAMS, CFG, max_group=world - 1, mesh=MESH, device="cpu")
    except ValueError as e:
        assert "max_group" in str(e)
    else:
        raise AssertionError("max_group < data size must raise")


@check
def ragged_compaction_zero_warm_executors():
    reqs = [Request(uid=i, seq_len=16, nfe=[3, 7][i % 2], solver="ddim", seed=i)
            for i in range(16)]
    reqs += [Request(uid=100 + i, seq_len=16, nfe=4, solver="em", seed=50 + i)
             for i in range(3)]

    def drive(eng):
        got = by_uid(eng.serve(list(reqs)))
        n = eng.num_executors
        again = by_uid(eng.serve(list(reqs)))
        return got, again, n, eng.num_executors, sorted(k[1] for k in eng._compiled)

    out, eng = sharded(drive, max_group=16)
    pinned_out, pinned = sharded(lambda e: e.serve(
        [Request(uid=200 + i, seq_len=16, nfe=[3, 7][i % 2], solver="ddim", seed=i)
         for i in range(world)]))
    if not LEAD:
        return
    got, again, n, n_warm, batches = out
    want = by_uid(plain(max_group=16).serve(list(reqs)))
    same_tokens(got, want)
    same_tokens(again, want)
    assert n_warm == n, "warm sharded serve built an executor"
    assert all(b % world == 0 for b in batches), batches
    assert 8 in batches and 16 in batches, batches         # compaction hit 16 -> 8
    assert eng.metrics.snapshot()["serve_compactions_total"] >= 1
    assert pinned.wasted_row_steps == 0, pinned.wasted_row_steps


@check
def join_refills_group_at_fixed_batch():
    first = [Request(uid=i, seq_len=16, nfe=[3, 8][i % 2], solver="ddim", seed=i)
             for i in range(8)]
    late = [Request(uid=100 + i, seq_len=16, nfe=5, solver="euler", seed=50 + i)
            for i in range(4)]

    def drive(eng):
        out = []
        for r in first:
            eng.submit(r)
        for _ in range(3):
            out += eng.tick()          # the nfe-3 rows retire at tick 3; the joiners
                                       # then end with the veterans, at tick 8
        for r in late:
            eng.submit(r)
        while eng.busy:
            out += eng.tick()
        return by_uid(out)

    got, eng = sharded(drive, max_group=8)
    if not LEAD:
        return
    assert eng.joined_requests == 4, eng.joined_requests
    assert eng.wasted_row_steps == 0, eng.wasted_row_steps
    assert {k[1] for k in eng._compiled} == {8}, sorted(eng._compiled)
    solo = plain()
    for r in first + late:
        want = solo.serve([Request(uid=r.uid, seq_len=16, nfe=r.nfe, solver=r.solver,
                                   seed=r.seed)])[0]
        np.testing.assert_array_equal(got[r.uid].tokens, want.tokens)


@check
def heartbeat_between_submits():
    """Idle beats hand the followers the submits without a tick; a beat
    mid-solve changes nothing either."""
    reqs = [Request(uid=i, seq_len=8, nfe=[3, 5][i % 2], solver=["ddim", "tab2"][i % 2],
                    seed=30 + i) for i in range(6)]

    def drive(eng):
        out = []
        eng.heartbeat()
        for r in reqs[:3]:
            eng.submit(r)
        eng.heartbeat()
        out += eng.tick()
        for r in reqs[3:]:
            eng.submit(r)
            eng.heartbeat()
        while eng.busy:
            out += eng.tick()
        eng.heartbeat()
        return by_uid(out)

    got, _ = sharded(drive, max_group=8)
    if not LEAD:
        return
    solo = plain()
    for r in reqs:
        want = solo.serve([Request(uid=r.uid, seq_len=8, nfe=r.nfe, solver=r.solver,
                                   seed=r.seed)])[0]
        np.testing.assert_array_equal(got[r.uid].tokens, want.tokens)


def fuzz(join):
    rng = np.random.RandomState(3)
    workload = [(int(rng.randint(0, 5)), Request(
        uid=i, seq_len=int(rng.randint(5, 9)), nfe=int(rng.choice([3, 5, 7])),
        solver=["ddim", "dpm2m", "seeds1", "scire2", "sndeis2", "em"][i % 6],
        seed=int(rng.randint(100)), priority=int(rng.randint(2))))
        for i in range(10)]
    run = drive_ticks(workload)
    kw = dict(max_group=16, seq_len_buckets=(8,), join=join)

    def drive(eng):
        got = run(eng)
        n = eng.num_executors
        again = run(eng)
        return got, again, n, eng.num_executors, sorted({k[1] for k in eng._compiled})

    out, eng = sharded(drive, **kw)
    if not LEAD:
        return
    got, again, n, n_warm, batches = out
    want = run(plain(**kw))
    same_tokens(got, want)
    same_tokens(again, want)
    assert eng.wasted_row_steps == 0
    assert all(b % world == 0 for b in batches), batches
    assert n_warm == n, "warm sharded fuzz replay built an executor"


@check
def fuzz_joins_on():
    fuzz(True)


@check
def fuzz_joins_off():
    fuzz(False)


@check
def early_exit_bitwise():
    rng = np.random.RandomState(7)
    workload = [(int(rng.randint(0, 5)), Request(
        uid=i, seq_len=int(rng.randint(5, 9)), nfe=int(rng.choice([5, 7, 9])),
        solver=["tab2", "ddim", "tab2"][i % 3],
        seed=int(rng.randint(100)), priority=int(rng.randint(2))))
        for i in range(10)]
    run = drive_ticks(workload)
    kw = dict(max_group=16, seq_len_buckets=(8,), retire=RetirePolicy(tol=1.0, min_k=2))

    def drive(eng):
        got = run(eng)
        saved, n = eng.metrics.snapshot()["serve_saved_nfe_total"], eng.num_executors
        run(eng)
        return got, saved, n, eng.num_executors

    out, eng = sharded(drive, **kw)
    if not LEAD:
        return
    got, saved, n, n_warm = out
    base = plain(**kw)
    want = run(base)
    assert any(r.early_exit for r in want.values())
    same_tokens(got, want)
    for uid in want:
        g, w = got[uid], want[uid]
        assert (g.nfe, g.early_exit, g.final_err) == (w.nfe, w.early_exit, w.final_err), uid
    assert saved == base.metrics.snapshot()["serve_saved_nfe_total"] > 0
    assert n_warm == n


@check
def cancels_and_deadlines_on_rank0():
    reqs = [Request(uid=i, seq_len=8, nfe=[4, 6][i % 2], solver="ddim", seed=i,
                    deadline_s=1e-6 if i in (1, 5) else None) for i in range(7)]

    def drive(eng):
        out = []
        for r in reqs:
            eng.submit(r)
        eng.submit(Request(uid=50, seq_len=8, nfe=4, solver="ddim", seed=50))
        assert eng.cancel(50)                  # still pending
        out += eng.tick()
        out += eng.tick()
        assert eng.cancel(2)                   # mid-flight
        assert not eng.cancel(999)
        while eng.busy:
            out += eng.tick()
        return by_uid(out)

    got, eng = sharded(drive, max_group=4, enforce_deadlines=True)
    counters = {k: v for k, v in eng.metrics.snapshot().items()
                if isinstance(v, (int, float)) and not k.endswith("seconds_total")
                and k != "serve_queue_depth"}
    every = [None] * world
    dist.all_gather_object(every, counters)
    if not LEAD:
        return
    assert all(c == every[0] for c in every), every     # every rank decided alike
    snap = eng.metrics.snapshot()
    assert snap["serve_submitted_total"] == 8
    assert snap["serve_submitted_total"] == snap["serve_completed_total"] + \
        snap["serve_deadline_evicted_total"] + snap["serve_cancelled_total"]
    assert snap["serve_deadline_evicted_total"] == 2 and snap["serve_cancelled_total"] == 2
    assert got[1].deadline_exceeded and got[5].deadline_exceeded
    assert got[2].cancelled and got[50].cancelled
    solo = plain()
    for r in reqs:
        if r.uid not in (1, 2, 5):
            want = solo.serve([Request(uid=r.uid, seq_len=8, nfe=r.nfe, solver="ddim",
                                       seed=r.seed)])[0]
            np.testing.assert_array_equal(got[r.uid].tokens, want.tokens)


@check
def against_reference_weights_and_priors():
    ref = torch.load(ref_path, weights_only=False)
    priors = ref["priors"]

    def new_state(self, plans, seeds, lens, seq_len):
        gens = DLM.request_generators(seeds, self.device)
        filler = torch.zeros((seq_len, CFG.d_model))      # inert rows' prior is unused
        x_T = torch.stack([torch.as_tensor(priors[s]) if s in priors else filler
                           for s in seeds])
        return DLM.init_sample_state(self.cfg, stack_plans(plans), gens,
                                     seq_len=seq_len, prior_std=SDE.prior_std(), x_T=x_T)

    own = DiffusionServeEngine._new_state
    DiffusionServeEngine._new_state = new_state
    try:
        eng = DiffusionServeEngine(ref["params"], CFG, mesh=MESH, device="cpu")
        if not LEAD:
            eng.follow()
            return
        try:
            res = eng.serve([Request(**r) for r in ref["requests"]])
        finally:
            eng.close()
    finally:
        DiffusionServeEngine._new_state = own
    extra["reference_tokens"] = {str(r.uid): r.tokens.tolist() for r in res}


@check
def driver_fails_closed():
    """Last (it tears the groups down): rank 0's tick raises after its
    broadcast, while the followers wait in the token gather. The driver
    fails every in-flight request and stops, later submissions fail at
    once, and every rank's process groups are gone."""
    eng = DiffusionServeEngine(PARAMS, CFG, mesh=MESH, device="cpu")
    if not LEAD:
        try:
            eng.follow()
        except Exception:
            pass
        else:
            raise AssertionError("follow() returned after the leader failed")
        assert not dist.is_initialized()
        return

    def boom(*a):
        raise RuntimeError("injected decode failure")
    eng._decode_rows = boom
    drv = ServeDriver(eng)
    handles = [drv.submit(Request(uid=i, seq_len=8, nfe=3, solver="ddim", seed=i))
               for i in range(3)]
    for h in handles:
        try:
            h.result(timeout=60)
        except RuntimeError as e:
            assert "injected" in str(e), e
        else:
            raise AssertionError("a request survived the failed tick")
    drv._thread.join(timeout=60)
    assert not drv._thread.is_alive(), "the scheduler kept running"
    late = drv.submit(Request(uid=99, seq_len=8, nfe=3, solver="ddim", seed=0))
    try:
        late.result(timeout=1)
    except RuntimeError as e:
        assert "process groups are gone" in str(e), e
    else:
        raise AssertionError("a submission after the failure was served")
    assert eng.metrics.snapshot()["driver_crash_total"] == 1
    assert not dist.is_initialized()
    eng.close()                 # a no-op once failed closed


with open(f"{out_path}.{rank}", "w") as f:
    json.dump({"results": results, **extra}, f)
if dist.is_initialized():
    dist.barrier()      # every rank past its last collective before teardown
    dist.destroy_process_group()
'''

CHECKS = ["mesh_and_fingerprint", "sample_and_step_bitwise", "splices_move_rows",
          "max_group_below_data_size_raises", "ragged_compaction_zero_warm_executors",
          "join_refills_group_at_fixed_batch", "heartbeat_between_submits",
          "fuzz_joins_on", "fuzz_joins_off", "early_exit_bitwise",
          "cancels_and_deadlines_on_rank0", "against_reference_weights_and_priors",
          "driver_fails_closed"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's weights (converted), its priors per seed and its
    unsharded engine's tokens for ``REF_REQUESTS``."""
    rcfg = ref_config().reduced().with_(objective="diffusion")
    rp = ref_init(rcfg, jax.random.PRNGKey(0))
    priors = {}
    ts = get_timesteps(RVPSDE(), 3, "quadratic")
    for r in REF_REQUESTS:
        plan = ref_stack([ref_make_plan("tab2", RVPSDE(), ts)])
        x = RLM.init_sample_state(rcfg, plan, RLM.request_keys([r["seed"]]),
                                  seq_len=r["seq_len"], prior_std=RVPSDE().prior_std(),
                                  valid_lens=[r["seq_len"]]).x
        priors[r["seed"]] = np.array(x[0])
    eng = RefEngine(rp, rcfg, fused=False)
    want = {r.uid: np.asarray(r.tokens)
            for r in eng.serve([RefRequest(**r) for r in REF_REQUESTS])}
    path = tmp_path_factory.mktemp("ref") / "reference.pt"
    torch.save({"params": params_from_numpy(jax.tree.map(np.asarray, rp), CFG, "cpu"),
                "priors": priors, "requests": REF_REQUESTS}, path)
    return path, want


_RUNS: dict = {}


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    def get(world):
        if world not in _RUNS:
            tmp = tmp_path_factory.mktemp(f"w{world}")
            out = tmp / "result.json"
            try:
                spawn(_CHILD, world, tmp, args=(reference[0], out, SPAWN_TIMEOUT_S - 30))
                ranks = [json.loads(Path(f"{out}.{r}").read_text()) for r in range(world)]
                _RUNS[world] = dict(ranks[0], results={
                    c: next((o for o in (rk["results"].get(c, "missing") for rk in ranks)
                             if o != "ok"), "ok") for c in CHECKS})
            except AssertionError as e:     # every case of this world fails with it
                _RUNS[world] = e
        if isinstance(_RUNS[world], Exception):
            raise _RUNS[world]
        return _RUNS[world]
    return get


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("check", CHECKS)
def test_sharded_serving(runs, world, check):
    outcome = runs(world)["results"][check]
    assert outcome == "ok", outcome


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_engine_matches_reference_engine(runs, reference, world):
    """The sharded engine on the reference's weights and priors gives the
    reference's unsharded engine's tokens."""
    got = runs(world)["reference_tokens"]
    want = reference[1]
    assert sorted(got) == sorted(str(u) for u in want)
    for uid, toks in want.items():
        np.testing.assert_array_equal(np.asarray(got[str(uid)]), toks)


def test_control_group_is_fresh_in_each_world():
    """Two process-group lifetimes in one process: each sharded engine gets
    a live control group of its own world (none cached past its teardown),
    and serves the unsharded engine's tokens."""
    import torch.distributed as dist
    params = init_params(CFG, 0, "cpu")
    reqs = [Request(uid=i, seq_len=8, nfe=3, solver="ddim", seed=i) for i in range(2)]
    want = {r.uid: r.tokens for r in
            DiffusionServeEngine(params, CFG, device="cpu").serve(list(reqs))}
    for _ in range(2):
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        try:
            mesh = M.make_request_mesh()
            eng = DiffusionServeEngine(params, CFG, mesh=mesh, device="cpu")
            got = {r.uid: r.tokens for r in eng.serve(list(reqs))}
            eng.close()
        finally:
            dist.destroy_process_group()
        del mesh, eng
        gc.collect()
        assert len(M._CONTROL) == 0, "a control group outlived its world"
        assert got.keys() == want.keys()
        for uid in want:
            np.testing.assert_array_equal(got[uid], want[uid])
