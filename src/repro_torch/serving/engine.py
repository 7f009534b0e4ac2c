"""Serving engines on PyTorch: the streaming continuous-batching DEIS
sampling service and the autoregressive greedy decoder.

The counterpart of ``repro.serving.engine``: ``DiffusionServeEngine``
(with the request-axis mesh, see "Request-axis data parallelism" below)
and ``ARServeEngine`` (prefill, then one token at a time against the KV /
SSM cache). The diffusion engine's semantics are the reference's:

Admission.  ``submit()`` enqueues; at every ``tick()`` pending requests are
admitted into *groups* at a step boundary. A group stacks up to
``max_group`` requests whose plans share one :attr:`SolverPlan.family` and
whose (bucketed) ``seq_len`` matches; solver names and NFE budgets may
differ (shorter plans are padded to the bucket's longest grid). Each
request draws its prior and its solve noise from its own generators,
derived from ``Request.seed`` alone, so samples are per-request
reproducible regardless of batch composition, joining or compaction.
At every compaction boundary pending same-bucket requests may **join** a
surviving in-flight group; the executor steps every row at its own count
(a per-row ``k`` vector). ``seq_len_buckets=(...)`` rounds request lengths
up to bucket edges; a per-row ``lens`` vector masks each row's padded tail
out of attention, and every decode is cut back to the true ``seq_len``.
MoE capacity stays per row over the bucket's whole length, the padded tail
included (as in the reference): a bucketed MoE row keeps a bucket-shape
dependence, and rows never share capacity.

Scheduling.  A tick selects up to ``steps_per_tick`` groups (default all)
ordered by effective priority (with starvation aging), earliest absolute
deadline, then admission order, and advances each by one solver step.

Completion, compaction, early exit.  Rows finish at their own step count;
with ``compaction=True`` the group is row-gathered down to its survivors
(or refilled by joiners) at the next boundary. ``retire=RetirePolicy(...)``
builds every plan with ``error_estimate=True`` and retires converged rows
early; ``enforce_deadlines`` evicts expired rows (a Result flagged
``deadline_exceeded``); ``cancel(uid)`` retires a request (flagged
``cancelled``). Conservation: submitted == completed + evicted + cancelled.

Executors.  The reference AOT-compiles one executor per ``(signature,
batch, seq_len)``. Here an executor is a cached plain callable (one eager
step over the eps-network) under the same key, so "zero warm recompiles"
reads as zero new cache entries on a warm replay; the hit/miss counters
are the reference's. ``compile_s`` is the time to build that callable
(near zero); first-call costs on the card (cuBLAS heuristics, the Triton
kernel's build) land in the first steps' solve time.

Conditioning.  As in the reference, the engines pass no ``prefix`` or
``frames``: a vlm config (paligemma) serves as a text-only decoder, and an
encdec config (whisper), whose forward needs the encoder's frames, is
refused by both engines (:func:`check_servable`); run it through
``sample_tokens(frames=)`` or the prefill and decode steps.

Request-axis data parallelism (``mesh=``).  SPMD over torch.distributed:
one process per device, each holding the same parameters (rank 0's,
broadcast once at construction) and running the same engine. Rank 0 (the
leader) alone takes ``submit``/``cancel``/``tick``/``serve``; the other
ranks run :meth:`DiffusionServeEngine.follow`. At the top of every tick
the leader broadcasts that tick's inputs over the mesh's gloo control
group: the submits, cancels and resets since the last tick (each submit
with its submit time), the uids its wall clock has found past their
deadline, and its clock reading. Every rank then makes the same
admission, grouping, rounding and selection from the same inputs. A
group's R rows (a multiple of the data size w, filled with inert rows)
are cut into contiguous blocks; rank r steps rows ``[r R/w, (r+1) R/w)``
with plain local tensors. After each group step the error estimates the
host reads are all-gathered, so every rank retires, compacts and joins the
same rows; finished rows are decoded on their owner and their tokens
gathered to the leader, which alone returns Results. Rows move between
ranks only when a compaction or a join gives them another owner
(``take_state_rows`` / ``join_state_rows`` with ``shardings``). Executors
are keyed on ``(signature, R, seq_len, mesh fingerprint)``, R global.
The mesh fails closed: a tick (or a follower's step) that raises leaves
the ranks at different collectives, which no group recovers from, so the
rank that raised destroys the process groups before it re-raises. Every
other rank's pending collective then raises too, and the engine refuses
further ticks.

Device.  The engine runs where its parameters lie: ``device=None`` means
CUDA, and raises without one. Every ``ab``-method plan is routed through
the fused AB-step kernel (:mod:`repro_torch.kernels.deis_step`). All
selected groups are dispatched before the engine waits on any: one
synchronisation per group step, then the host reads what it needs (the
finished rows' tokens, the error estimates).
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core import cached_make_plan, get_timesteps
from ..core import sampler as SAMPLER
from ..core.adaptive import RetirePolicy
from ..core.plan import (SolverPlan, inert_row, join_rows, pad_plan,
                         place_plan, solver_stages, stack_plans, take_rows)
from ..core.sde import SDE, VPSDE
from ..device import resolve_device
from ..diffusion import lm as DLM
from ..launch.mesh import control_group, data_group, mesh_fingerprint
from ..models.convert import tree_leaves
from ..obs.metrics import MetricsRegistry
from ..obs.trace import Tracer
from ..sharding.rules import axis_sizes, batch_axes, block_range
from ..training.steps import make_decode_step, make_prefill_step


class DeadlineExceeded(RuntimeError):
    """A request's absolute deadline passed before its solve finished.

    With ``enforce_deadlines=True`` the engine evicts the row and emits a
    :class:`Result` flagged ``deadline_exceeded=True``; the driver turns
    that flag into THIS exception on the request's own stream -- the
    scheduler thread never raises it."""


class Cancelled(RuntimeError):
    """A request was cancelled (``engine.cancel`` / ``driver.cancel``): the
    engine emits a :class:`Result` flagged ``cancelled=True`` and the driver
    turns it into THIS exception on the request's own stream."""


@dataclasses.dataclass
class Request:
    """One serving request (AR or diffusion; diffusion fields listed last).
    ``priority`` (higher first) and ``deadline_s`` (latency budget from
    submit time) change WHEN a request is stepped, never WHAT it computes:
    samples depend only on ``(solver, nfe, eta, seed, seq_len)``."""
    uid: int
    prompt: np.ndarray | None = None       # AR: token prompt
    max_new_tokens: int = 32               # AR: tokens to generate
    seq_len: int = 64
    nfe: int = 10
    solver: str = "tab3"
    eta: float | None = None               # required iff solver == "ddim_eta"
    seed: int = 0
    priority: int = 0
    deadline_s: float | None = None


@dataclasses.dataclass
class Result:
    """Final per-request outcome (fields as in the reference): ``latency_s``
    is the group's solve time since the request's own admission, ``nfe``
    the evals its own plan spent, ``queue_wait_s`` submit -> admission."""
    uid: int
    tokens: np.ndarray
    latency_s: float
    nfe: int = 0
    compile_s: float = 0.0
    queue_wait_s: float = 0.0
    deadline_exceeded: bool = False  # evicted: tokens empty, nfe 0
    cancelled: bool = False          # retired by cancel(): tokens empty, nfe 0
    early_exit: bool = False         # retired converged by the RetirePolicy
    final_err: float | None = None   # last local-error estimate, if any


@dataclasses.dataclass
class StepEvent:
    """Per-step progress emitted to the ``on_step`` serving callback (fields
    as in the reference; per-row tuples are aligned with ``uids``)."""
    uids: tuple
    k: int
    n_steps: int
    tokens: Optional[np.ndarray] = None
    row_steps: Optional[tuple] = None
    row_k: Optional[tuple] = None
    row_seq_lens: Optional[tuple] = None
    row_err: Optional[tuple] = None


def check_servable(cfg: ModelConfig) -> None:
    """Raise for an encdec config: the engines take no encoder ``frames``
    (the reference's engines pass none either, and its forward then fails)."""
    if cfg.arch_type == "encdec":
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: its forward needs the encoder's "
            "frames, which the serving engines do not take; run it through "
            "diffusion.lm.sample_tokens(frames=) or training.steps' prefill and "
            "decode steps with batch['frames']")


class ARServeEngine:
    """Greedy autoregressive decoding, one request after another: prefill
    the prompt, then one token per decode step against the cache (the
    reference's deliberately simple loop, without its unused ``max_batch``).
    ``max_len`` is the cache length of a positional (non-ring) attention
    layer. ``Result.latency_s`` is the request's ``perf_counter`` wall time,
    prefill included. Runs under ``torch.no_grad()``."""

    def __init__(self, params, cfg: ModelConfig, *, max_len: int = 512,
                 device=None):
        check_servable(cfg)
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.params, self.cfg = params, cfg
        self.max_len = max_len
        self._prefill = make_prefill_step(cfg)
        self._decode = make_decode_step(cfg)

    def _grow(self, layer: dict, prompt_len: int) -> dict:
        """Pad a prefilled attention layer's k and v along the sequence to
        ``max_len`` slots, unless they are a sliding-window ring (the
        reference pads axis 2 of its stacked leaves; a layer here has no
        stacked axis). SSM layers (all of mamba2's, seven in eight of
        jamba's) keep their fixed-size conv and state."""
        w = self.cfg.sliding_window
        out = dict(layer)
        for name in ("k", "v"):
            t = layer.get(name)
            if t is not None and t.shape[1] == prompt_len and not (w and t.shape[1] == w):
                out[name] = F.pad(t, (0, 0, 0, 0, 0, self.max_len - prompt_len))
        return out

    def serve(self, requests: list[Request]) -> list[Result]:
        """Run all requests to completion; returns Results (greedy decode)."""
        results: list[Result] = []
        with torch.no_grad():
            for req in requests:
                t0 = time.perf_counter()
                prompt = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long,
                                         device=self.device)[None]
                n = prompt.shape[1]
                logits, cache = self._prefill(self.params, {"tokens": prompt})
                cache = dict(cache, blocks=[self._grow(c, n) for c in cache["blocks"]])
                tok = torch.argmax(logits, -1)[:, None]
                out_tokens = [int(tok[0, 0])]   # each token is read as it is made
                pos = n
                for _ in range(req.max_new_tokens - 1):
                    logits, cache = self._decode(self.params, cache, tok, pos)
                    tok = torch.argmax(logits, -1)[:, None]
                    out_tokens.append(int(tok[0, 0]))
                    pos += 1
                results.append(Result(req.uid, np.asarray(out_tokens),
                                      time.perf_counter() - t0))
        return results


# err histogram edges: local-error estimates are small dimensionless
# magnitudes (x-space Linf), nothing like the registry's latency defaults
_ERR_EDGES = (1e-8, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0)

# pndm spends 3 extra evals on each of its 3 warmup steps, so its grid is
# nfe - 9 intervals (floored at the 4 steps PNDM requires)
_PNDM_WARMUP_EXTRA = 9


def _spent_nfe(method: str, row: "_Row", k_own: int) -> int:
    """Network evals a row has spent after ``k_own`` of its own steps."""
    if method == "rk":
        return k_own * max(1, row.nfe // max(1, row.n_steps))
    if method == "pndm":
        return k_own + 3 * min(k_own, 3)
    return k_own


@dataclasses.dataclass
class _Pending:
    """A submitted request waiting for admission (fresh group or join)."""
    req: Request
    plan: SolverPlan            # unstacked, at the request's own grid
    t_sub: float                # perf_counter at submit (deadline anchor)
    s_len: int                  # BUCKETED seq_len the solve runs at


@dataclasses.dataclass
class _Row:
    """Per-request bookkeeping inside a (possibly ragged) group. ``k0`` is
    the group step count at this row's admission: its own step count is
    ``g.k - k0``. ``pad`` rows are structural filler under a mesh (inert
    rows, ``req`` None, or a retired request's row kept so the batch stays
    a multiple of the data size): they emit nothing, appear in no
    StepEvent and are never counted as wasted steps."""
    req: Request | None
    n_steps: int                # TRUE solver steps of this request's own plan
    nfe: int                    # TRUE network evals (plan.nfe, pre-padding)
    deadline: float             # absolute deadline (inf when best-effort)
    done: bool = False          # Result already emitted
    pad: bool = False           # structural filler row
    k0: int = 0                 # group step count at this row's admission
    solve_s0: float = 0.0       # group solve_s at this row's admission
    wait_s: float = 0.0         # submit -> admission queue wait


@dataclasses.dataclass
class _Group:
    """One in-flight stacked solve (requests admitted together or joined)."""
    rows: list                  # list[_Row], aligned with the stacked axis
    sig: tuple                  # member plans' (padded, unstacked) signature
    bucket: tuple               # admission bucket key (plan.family, s_len)
    seq_len: int                # bucketed seq_len the stacked solve runs at
    plan: SolverPlan            # stacked, whole (every rank holds it)
    state: SAMPLER.SamplerState  # this rank's row block under a mesh
    fn: Callable                # executor: step(params, plan, k, state, lens)
    n_steps: int                # max live row k0 + n_steps (drain horizon)
    compile_s: float
    priority: int               # max member Request.priority
    deadline: float             # min member absolute deadline (inf if none)
    arrival: int                # admission sequence number (tie-break)
    k: int = 0                  # steps completed
    solve_s: float = 0.0        # accumulated solve wall-time (excl. compile)
    skipped: int = 0            # consecutive ticks not selected (aging)
    shardings: tuple = (None, None)   # (plan, state) NamedSharding trees
    exec_plan: SolverPlan | None = None   # this rank's block of ``plan``

    @property
    def real_idx(self) -> list:
        """Row indices of real (non-filler) rows."""
        return [i for i, r in enumerate(self.rows) if not r.pad]

    @property
    def uids(self) -> tuple:
        return tuple(self.rows[i].req.uid for i in self.real_idx)


def _wait(x: torch.Tensor) -> None:
    """Block until the work queued on ``x``'s stream has finished (no-op
    on the CPU, which computes eagerly)."""
    if x.is_cuda:
        # repro: allow[RL001] the tick's one wait per group step, after every group dispatched
        torch.cuda.current_stream(x.device).synchronize()


class DiffusionServeEngine:
    """Streaming continuous-batching DEIS sampling service (see the module
    docstring). ``serve`` drains a request list; ``submit`` + ``tick``
    expose the scheduler directly."""

    def __init__(self, params, cfg: ModelConfig, sde: Optional[SDE] = None,
                 schedule: str = "quadratic", max_group: int = 8,
                 steps_per_tick: int | None = None, aging_ticks: int = 8,
                 compaction: bool = True, join: bool = True,
                 seq_len_buckets=None, mesh=None,
                 enforce_deadlines: bool = False,
                 retire: RetirePolicy | None = None,
                 metrics: MetricsRegistry | None = None,
                 tracer: Tracer | None = None, device=None):
        """Arguments as in the reference engine (without ``fused``: every
        ``ab``-method plan takes the fused AB-step kernel), plus ``device``
        (None means CUDA; the parameters must already lie there).

        ``mesh``: a 1-axis ``('data',)`` DeviceMesh over every rank
        (:func:`repro_torch.launch.mesh.make_request_mesh`); collective:
        every rank constructs the engine with the same arguments, and rank
        0's parameters are broadcast into every other rank's (in place).
        Group sizes round up to a multiple of the data size w, and
        ``max_group < w`` raises."""
        if cfg.objective != "diffusion":
            raise ValueError("DiffusionServeEngine serves diffusion configs")
        check_servable(cfg)
        # repro: allow[RL003] immutable engine config; the ownership table predates the port
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.params, self.cfg = params, cfg
        self.sde = sde or VPSDE()
        self.schedule = schedule
        self.max_group = max_group
        # clamp: 0/negative would make tick() select nothing and busy-loop
        self.steps_per_tick = None if steps_per_tick is None \
            else max(1, steps_per_tick)
        self.aging_ticks = max(1, aging_ticks)
        self.compaction = compaction
        self.join = join
        if seq_len_buckets is not None:
            edges = tuple(int(e) for e in seq_len_buckets)
            if not edges or any(e < 1 for e in edges) or \
                    list(edges) != sorted(set(edges)):
                raise ValueError("seq_len_buckets must be strictly ascending "
                                 f"positive edges, got {seq_len_buckets!r}")
            seq_len_buckets = edges
        self.seq_len_buckets = seq_len_buckets
        self.mesh = mesh
        # repro: allow[RL003] immutable mesh identity: this rank, the leader's global rank, the gloo control group (the ownership table predates the port)
        self._rank, self._src, self._ctl = 0, 0, None
        # repro: allow[RL003] set once, on the thread that makes the collectives (the ownership table predates the port)
        self._failed = False        # a mesh engine that failed closed
        if mesh is not None:
            self._mesh_key = mesh_fingerprint(mesh)
            sizes = axis_sizes(mesh)
            self._data_size = math.prod(sizes[a] for a in batch_axes(mesh)) or 1
            if self._data_size > self.max_group:
                raise ValueError(
                    f"mesh data-axis size {self._data_size} exceeds "
                    f"max_group={self.max_group}: every group must round up "
                    "to a multiple of the axis, so the smallest placeable "
                    "group would already break the max_group bound. Raise "
                    "max_group or shrink the mesh.")
            # rounded-up groups never exceed max_group
            self._chunk_cap = (self.max_group // self._data_size) * self._data_size
            self._rank = mesh.get_local_rank(mesh.mesh_dim_names[0])
            self._src = int(mesh.mesh.flatten()[0])
            self._ctl = control_group(mesh)
            group = data_group(mesh)
            for leaf in tree_leaves(params):
                dist.broadcast(leaf, src=self._src, group=group)
        else:
            self._mesh_key = None
            self._data_size = 1
            self._chunk_cap = self.max_group
        # repro: allow[RL003] scheduler-thread state like the queues (the ownership table predates the port)
        self._ops: list = []        # leader: inputs since the last broadcast
        self._plans: dict = {}      # (solver, nfe, eta) -> SolverPlan
        self._compiled: dict = {}   # (signature, batch, seq_len, mesh) -> executor
        self._pending: deque = deque()   # deque[_Pending]
        self._active: list[_Group] = []
        self._arrivals = 0          # admission sequence counter
        self.enforce_deadlines = enforce_deadlines
        self.retire = retire
        # Results produced OUTSIDE a group step (deadline evictions,
        # cancellations, early exits), drained into the next tick's list
        self._boundary_results: list[Result] = []

        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(self.metrics)
        reg = self.metrics
        self._m_ticks = reg.counter(
            "serve_ticks_total", "scheduler ticks executed")
        self._m_wasted = reg.counter(
            "serve_wasted_row_steps_total",
            "steps burned on already-finished request rows (structural "
            "filler excluded)")
        self._m_joined = reg.counter(
            "serve_joined_requests_total",
            "requests admitted by joining an in-flight group")
        self._m_submitted = reg.counter(
            "serve_submitted_total", "requests accepted by submit()")
        self._m_completed = reg.counter(
            "serve_completed_total", "requests finished with a sample")
        self._m_evicted = reg.counter(
            "serve_deadline_evicted_total",
            "requests evicted by deadline enforcement")
        self._m_compactions = reg.counter(
            "serve_compactions_total", "mid-flight group compactions")
        self._m_cache_hits = reg.counter(
            "serve_compile_cache_hits_total",
            "executor lookups served by the executor cache")
        self._m_cache_misses = reg.counter(
            "serve_compile_cache_misses_total",
            "executor lookups that built a new executor")
        self._m_compile_s = reg.counter(
            "serve_compile_seconds_total",
            "cumulative executor build wall time")
        self._g_queue = reg.gauge(
            "serve_queue_depth", "requests pending admission")
        self._g_groups = reg.gauge(
            "serve_active_groups", "stacked groups in flight")
        self._g_occupancy = reg.gauge(
            "serve_group_occupancy",
            "live request rows / stacked row slots across active groups")
        self._m_cancelled = reg.counter(
            "serve_cancelled_total", "requests retired by cancel()")
        self._m_early = reg.counter(
            "serve_early_exit_total",
            "requests retired early by the RetirePolicy (converged rows)")
        self._m_saved_nfe = reg.counter(
            "serve_saved_nfe_total",
            "network evals saved by early exit (budgeted minus spent)")
        self._h_queue_wait = reg.histogram(
            "serve_queue_wait_seconds", "submit -> admission (join or fresh)")
        self._h_row_err = reg.histogram(
            "serve_row_err", "local-error estimate at row retirement",
            edges=_ERR_EDGES)
        self._h_solve = reg.histogram(
            "serve_solve_seconds",
            "per-request group solve time since its own admission")
        self._h_step = reg.histogram(
            "serve_step_seconds", "one group step, dispatch to ready")
        self._h_tick = reg.histogram(
            "serve_tick_seconds", "one full scheduler tick")

    # ---- int views over the registry
    @property
    def ticks(self) -> int:
        """Scheduler ticks executed (metric)."""
        return int(self._m_ticks.value)

    @property
    def wasted_row_steps(self) -> int:
        """Steps burned on already-finished rows (metric)."""
        return int(self._m_wasted.value)

    @property
    def joined_requests(self) -> int:
        """Requests admitted by joining an in-flight group (metric)."""
        return int(self._m_joined.value)

    # ----------------------------------------------------- control plane
    @property
    def _leader(self) -> bool:
        """True on the mesh's rank 0 (and without a mesh)."""
        return self._rank == 0

    def _need_leader(self, what: str) -> None:
        if not self._leader:
            raise RuntimeError(f"{what}() runs on the mesh's rank 0; the other "
                               "ranks run follow()")

    def _bcast(self, msg: dict) -> dict:
        """The leader's ``msg``, on every rank (gloo control group)."""
        box = [msg if self._leader else None]
        dist.broadcast_object_list(box, src=self._src, group=self._ctl)
        return box[0]

    def _take_ops(self) -> list:
        ops, self._ops = self._ops, []
        return ops

    def _replay(self, ops: list) -> None:
        """A follower applies the leader's inputs in the leader's order."""
        for op in ops:
            if op[0] == "submit":
                self._enqueue(op[1], op[2])
            elif op[0] == "cancel":
                self._cancel(op[1])
            else:
                self._reset()

    def _collective(self, fn, *args):
        """``fn(*args)`` on a mesh, failing closed: if it raises, the ranks
        are out of step, so the process groups are destroyed (each other
        rank's pending collective then raises) before the error goes on."""
        if self._failed:
            raise RuntimeError("this mesh engine failed closed after a rank "
                               "raised mid-tick; its process groups are gone")
        try:
            return fn(*args)
        except BaseException:
            self._failed = True
            if dist.is_initialized():
                dist.destroy_process_group()
            raise

    def follow(self) -> None:
        """The loop of every rank but the leader: apply each broadcast tick
        until the leader's :meth:`close`. Raises (with the process groups
        destroyed) when this rank's step or a collective fails, the
        leader's failure included."""
        if self._leader:
            raise RuntimeError("follow() runs on the ranks other than the mesh's rank 0")
        with torch.no_grad():
            self._collective(self._follow)

    def _follow(self) -> None:
        while True:
            msg = self._bcast(None)
            self._replay(msg["ops"])
            if msg["kind"] == "stop":
                return
            if msg["kind"] == "tick":
                self._tick(msg["now"], msg["evict"], None, msg["events"],
                           msg["stream"])

    def heartbeat(self) -> None:
        """Leader, idle: hand the followers the inputs so far without a
        tick, so none waits in a broadcast longer than the control group's
        timeout (``launch.mesh.CONTROL_TIMEOUT``)."""
        if self.mesh is not None:
            self._need_leader("heartbeat")
            self._collective(self._bcast, {"kind": "idle", "ops": self._take_ops()})

    def close(self) -> None:
        """Leader: release the followers from :meth:`follow` (no-op without
        a mesh, or once the engine has failed closed)."""
        if self.mesh is not None and not self._failed:
            self._need_leader("close")
            self._collective(self._bcast, {"kind": "stop", "ops": self._take_ops()})

    def _row_block(self, n: int) -> tuple[int, int]:
        """This rank's rows of an ``n``-row group (all of them unsharded)."""
        if self.mesh is None:
            return 0, n
        return block_range(n, self._data_size, self._rank)

    def _row_values(self, t: torch.Tensor) -> np.ndarray:
        """A per-row device vector of this rank's block, whole on the host
        of every rank (all-gathered over the control group: every group's
        blocks are equal, its batch being a multiple of the data size)."""
        # repro: allow[RL001] the host reads these values at a boundary by design
        v = t.detach().to("cpu", torch.float64)
        if self.mesh is not None:
            parts = [torch.empty_like(v) for _ in range(self._data_size)]
            dist.all_gather(parts, v, group=self._ctl)
            v = torch.cat(parts)
        return v.numpy()

    # ------------------------------------------------------------- plans
    def _plan(self, solver: str, nfe: int, eta: float | None) -> SolverPlan:
        """The request's plan on the engine's device in float32 (the serving
        dtype), memoised per ``(solver, nfe, eta)``."""
        if solver == "ddim_eta" and eta is None:
            raise ValueError("Request(solver='ddim_eta') requires an explicit "
                             "eta= (eta=0 deterministic, eta=1 ancestral)")
        key_ = (solver, nfe, eta)
        if key_ not in self._plans:
            if solver.lower() == "pndm":
                n_grid = max(4, nfe - _PNDM_WARMUP_EXTRA)
            else:
                n_grid = max(1, nfe // solver_stages(solver))
            ts = get_timesteps(self.sde, n_grid, self.schedule)
            kw = {"eta": eta} if solver == "ddim_eta" else {}
            if self.retire is not None:
                # uniform request across mixed traffic: families without an
                # embedded pair ignore it (their flag stays False)
                kw["error_estimate"] = True
            plan = cached_make_plan(solver, self.sde, ts, **kw)
            plan = plan.to(self.device, torch.float32)
            if plan.method == "ab":
                plan = dataclasses.replace(plan, fused=True)
            self._plans[key_] = plan
        return self._plans[key_]

    # --------------------------------------------------------- executors
    def _executor(self, sig, batch: int, seq_len: int) -> tuple[Callable, float]:
        """The cached single-step executor for this (signature, batch,
        seq_len, mesh), ``batch`` the group's whole row count; ``k`` and
        the per-row true lengths are arguments, so one executor serves
        every step of every group with this key."""
        key_ = (sig, batch, seq_len, self._mesh_key)
        if key_ in self._compiled:
            self._m_cache_hits.inc()
            return self._compiled[key_], 0.0
        self._m_cache_misses.inc()
        cfg = self.cfg
        t0 = time.perf_counter()
        with self.tracer.span("compile"):
            def run(params, plan_arg, k, st, lens):
                with torch.no_grad():
                    return SAMPLER.step(
                        plan_arg, k, st,
                        DLM.make_eps_fn(params, cfg, valid_len=lens))
        compile_s = time.perf_counter() - t0
        self._m_compile_s.inc(compile_s)
        self._compiled[key_] = run
        return run, compile_s

    # -------------------------------------------------------- scheduling
    def _bucket_len(self, seq_len: int) -> int:
        """Bucketed solve length: the first edge >= seq_len, or the exact
        length when no edge fits (or bucketing is off)."""
        if self.seq_len_buckets is not None:
            for edge in self.seq_len_buckets:
                if seq_len <= edge:
                    return edge
        return seq_len

    def submit(self, request: Request) -> None:
        """Validate and enqueue; the request is admitted at the next tick.
        Validation raises here, before the request enters the queue."""
        self._need_leader("submit")
        if request.seq_len < 1:
            raise ValueError(f"Request.seq_len must be >= 1, got "
                             f"{request.seq_len}")
        if request.nfe < 1:
            raise ValueError(f"Request.nfe must be >= 1, got {request.nfe}")
        t_sub = time.perf_counter()
        self._enqueue(request, t_sub)       # raises for a bad solver before queueing
        if self.mesh is not None:
            self._ops.append(("submit", request, t_sub))

    def _enqueue(self, request: Request, t_sub: float) -> None:
        plan = self._plan(request.solver, request.nfe,
                          request.eta if request.solver == "ddim_eta" else None)
        self._pending.append(_Pending(request, plan, t_sub,
                                      self._bucket_len(request.seq_len)))
        self._m_submitted.inc()
        self._g_queue.set(len(self._pending))

    @staticmethod
    def _abs_deadline(req: Request, t_submit: float) -> float:
        return math.inf if req.deadline_s is None else t_submit + req.deadline_s

    def _group_key(self, g: _Group) -> tuple:
        """Urgency ordering shared by ``_select`` and the boundary pass:
        effective priority desc (starvation aging), earliest absolute
        deadline, admission order."""
        return (-(g.priority + g.skipped // self.aging_ticks),
                g.deadline, g.arrival)

    def _expired(self, now: float) -> list:
        """Uids, pending or mid-flight, whose absolute deadline has passed."""
        out = [p.req.uid for p in self._pending
               if self._abs_deadline(p.req, p.t_sub) < now]
        out += [r.req.uid for g in self._active for r in g.rows
                if not (r.done or r.pad) and r.deadline < now]
        return out

    def _evict_expired(self, now: float, uids) -> None:
        """Deadline enforcement: shed pending requests and retire mid-flight
        rows in ``uids`` (the leader's :meth:`_expired` at ``now``; a
        ``deadline_exceeded`` Result each; the freed rows are compacted away
        at this boundary)."""
        uids = set(uids)
        empty = np.zeros(0, np.int64)
        still = deque()
        while self._pending:
            p = self._pending.popleft()
            if p.req.uid in uids:
                self._m_evicted.inc()
                self._h_queue_wait.observe(now - p.t_sub)
                self._boundary_results.append(Result(
                    p.req.uid, empty, 0.0, nfe=0,
                    queue_wait_s=now - p.t_sub, deadline_exceeded=True))
            else:
                still.append(p)
        self._pending = still
        for g in list(self._active):
            for r in g.rows:
                if r.done or r.pad or r.req.uid not in uids:
                    continue
                r.done = True
                self._m_evicted.inc()
                self._h_queue_wait.observe(r.wait_s)
                self._boundary_results.append(Result(
                    r.req.uid, empty, g.solve_s - r.solve_s0, nfe=0,
                    compile_s=g.compile_s, queue_wait_s=r.wait_s,
                    deadline_exceeded=True))
            if all(r.done for r in g.rows):
                self._active.remove(g)

    def cancel(self, uid: int) -> bool:
        """Cancel request ``uid``: drop it from the pending queue, or retire
        its mid-flight row (the slot recycles at the next boundary). Emits a
        Result flagged ``cancelled=True``; False when ``uid`` is unknown."""
        self._need_leader("cancel")
        if self.mesh is not None:
            self._ops.append(("cancel", uid))
        return self._cancel(uid)

    def _cancel(self, uid: int) -> bool:
        empty = np.zeros(0, np.int64)
        now = time.perf_counter()
        for p in list(self._pending):
            if p.req.uid == uid:
                self._pending.remove(p)
                self._g_queue.set(len(self._pending))
                self._m_cancelled.inc()
                self._h_queue_wait.observe(now - p.t_sub)
                self._boundary_results.append(Result(
                    uid, empty, 0.0, nfe=0, queue_wait_s=now - p.t_sub,
                    cancelled=True))
                return True
        for g in list(self._active):
            for r in g.rows:
                if r.done or r.pad or r.req.uid != uid:
                    continue
                r.done = True
                self._m_cancelled.inc()
                self._h_queue_wait.observe(r.wait_s)
                self._boundary_results.append(Result(
                    uid, empty, g.solve_s - r.solve_s0, nfe=0,
                    compile_s=g.compile_s, queue_wait_s=r.wait_s,
                    cancelled=True))
                if all(row.done for row in g.rows):
                    self._active.remove(g)
                return True
        return False

    def _decode_rows(self, g: _Group, rows: list) -> np.ndarray | None:
        """Tokens of rows ``rows`` of ``g``'s iterate, on the leader's host
        (None on the other ranks). Under a mesh each rank decodes the rows
        of its own block and the tokens are gathered to the leader."""
        lo, hi = self._row_block(len(g.rows))
        mine = [i for i in rows if lo <= i < hi]
        toks = None
        if mine:
            idx = torch.as_tensor([i - lo for i in mine], device=self.device)
            # repro: allow[RL001] finished rows leave the device here by design
            toks = np.asarray(DLM.decode_tokens(self.params, self.cfg,
                                                g.state.x[idx]).cpu())
        if self.mesh is None:
            return toks
        parts = [None] * self._data_size if self._leader else None
        dist.gather_object((mine, toks), parts, dst=self._src, group=self._ctl)
        if not self._leader:
            return None
        by_row = {i: t for ids, tk in parts if ids for i, t in zip(ids, tk)}
        return np.stack([by_row[i] for i in rows])

    @staticmethod
    def _tokens(toks, j: int, seq_len: int) -> np.ndarray:
        """Row ``j``'s tokens cut to ``seq_len`` (empty off the leader)."""
        return np.zeros(0, np.int64) if toks is None else toks[j][:seq_len]

    def _retire_converged(self) -> None:
        """Early-exit pass (``retire`` policy set): retire rows whose local
        error estimate has converged, before the boundary pass rebuilds
        groups, so a freed slot is a join slot the same tick. The decision
        is the policy's pure per-row function of ``(err, |x|_inf)`` after at
        least ``min_k`` own steps (both all-gathered under a mesh, so every
        rank decides alike)."""
        pol = self.retire
        for g in list(self._active):
            if not g.plan.error_estimate:
                continue
            cand = [i for i, r in enumerate(g.rows)
                    if not r.done and not r.pad
                    and pol.min_k <= g.k - r.k0 < r.n_steps]
            if not cand:
                continue
            # repro: allow[RL001] early-exit boundary: err fetch gates retirement
            err = np.asarray(self._row_values(g.state.err), np.float64)
            if pol.norm == "rel":
                x = g.state.x
                x_inf = self._row_values(x.abs().amax(dim=tuple(range(1, x.ndim))))
            else:
                x_inf = np.zeros(len(g.rows))
            mask = pol.converged(err[cand], x_inf[cand])
            hit = [i for i, m in zip(cand, mask) if m]
            if not hit:
                continue
            toks = self._decode_rows(g, hit)
            for j, i in enumerate(hit):
                r = g.rows[i]
                r.done = True
                spent = _spent_nfe(g.plan.method, r, g.k - r.k0)
                self._m_completed.inc()
                self._m_early.inc()
                self._m_saved_nfe.inc(max(0, r.nfe - spent))
                self._h_row_err.observe(float(err[i]))
                self._h_queue_wait.observe(r.wait_s)
                lat = g.solve_s - r.solve_s0
                self._h_solve.observe(lat)
                self._boundary_results.append(Result(
                    r.req.uid, self._tokens(toks, j, r.req.seq_len), lat,
                    nfe=spent, compile_s=g.compile_s, queue_wait_s=r.wait_s,
                    early_exit=True, final_err=float(err[i])))
            if all(r.done for r in g.rows):
                self._active.remove(g)

    def _new_state(self, plans: list, seeds: list, lens: list, seq_len: int):
        """Whole stacked initial state of fresh rows: each drawn from its
        own request's generators at its true length."""
        gens = DLM.request_generators(seeds, self.device)
        return DLM.init_sample_state(
            self.cfg, stack_plans(plans), gens, seq_len=seq_len,
            prior_std=self.sde.prior_std(), valid_lens=lens)

    def _admit(self, now: float, evict) -> None:
        """Admit everything pending (step-boundary admission).

        1. Eviction (of the uids ``evict``) and early-exit passes (when
           enabled).
        2. Boundary pass (``compaction`` on): every group carrying retired
           rows rebuilds before its next step -- pending same-bucket
           requests whose grids fit the group's horizon join it (``join``
           on), and what cannot be refilled compacts to its survivors.
        3. Fresh groups: remaining pending requests bucket by
           ``(plan.family, bucketed seq_len)`` and chunk at ``max_group``.

        Under a mesh each chunk or rebuilt group is rounded up to a multiple
        of the data size w with filler rows (inert rows, or retired rows
        kept), and chunks are cut at ``(max_group // w) * w``; a group that
        cannot shrink by a multiple keeps its retired rows as filler.
        """
        if self.enforce_deadlines:
            self._evict_expired(now, evict)
        if self.retire is not None:
            self._retire_converged()
        buckets: dict = {}
        while self._pending:
            p = self._pending.popleft()
            buckets.setdefault((p.plan.family, p.s_len), []).append(p)
        self._g_queue.set(0)
        for items in buckets.values():
            items.sort(key=lambda it: (-it.req.priority,
                                       self._abs_deadline(it.req, it.t_sub)))
        if self.compaction:
            for g in sorted(self._active, key=self._group_key):
                if not any(r.done for r in g.rows):
                    continue
                cands = buckets.get(g.bucket) if self.join else None
                if cands and self._join_group(g, cands, now):
                    continue
                keep = self._compact_target(g, [i for i, r in enumerate(g.rows)
                                                if not r.done])
                if keep is not None:
                    self._compact(g, keep)
                else:
                    # the group already sits at the smallest multiple of the
                    # data size: its retired rows are structural filler
                    for r in g.rows:
                        if r.done:
                            r.pad = True
        for (fam, s_len), items in buckets.items():
            for i in range(0, len(items), self._chunk_cap):
                chunk = items[i:i + self._chunk_cap]
                n_max = max(p.plan.n_steps for p in chunk)
                padded = [pad_plan(p.plan, n_max) for p in chunk]
                rows = [_Row(req=p.req, n_steps=p.plan.n_steps,
                             nfe=p.plan.nfe,
                             deadline=self._abs_deadline(p.req, p.t_sub),
                             wait_s=now - p.t_sub)
                        for p in chunk]
                seeds = [p.req.seed for p in chunk]
                lens = [p.req.seq_len for p in chunk]
                n_fill = (-len(chunk)) % self._data_size
                if n_fill:
                    padded += [inert_row(padded[0])] * n_fill
                    rows += [_Row(req=None, n_steps=n_max, nfe=0, deadline=math.inf,
                                  done=True, pad=True) for _ in range(n_fill)]
                    seeds += [0] * n_fill
                    lens += [s_len] * n_fill
                sig = padded[0].signature
                plan = stack_plans(padded)
                state = self._new_state(padded, seeds, lens, s_len)
                fn, compile_s = self._executor(sig, len(rows), s_len)
                shardings = (None, None)
                if self.mesh is not None:
                    shardings = SAMPLER._request_shardings(plan, state, self.mesh)
                    state = SAMPLER.place_state(state, shardings[1])
                reqs = [p.req for p in chunk]
                self._arrivals += 1
                self._active.append(_Group(
                    rows=rows, sig=sig, bucket=(fam, s_len), seq_len=s_len,
                    plan=plan, state=state, fn=fn,
                    n_steps=n_max, compile_s=compile_s,
                    priority=max(r.priority for r in reqs),
                    deadline=min(r.deadline for r in rows),
                    arrival=self._arrivals, shardings=shardings,
                    exec_plan=self._exec_plan(plan, shardings)))

    def _exec_plan(self, plan: SolverPlan, shardings: tuple) -> SolverPlan:
        """What the executor steps: this rank's block of ``plan``."""
        return plan if shardings[0] is None else place_plan(plan, shardings[0])

    def _join_group(self, g: _Group, cands: list, now: float) -> bool:
        """Splice pending requests into ``g`` at a compaction boundary.

        Joiners come from the front of the (urgency-sorted) bucket, skipping
        any whose grid exceeds the group's horizon. The survivors keep their
        relative order and move whole (``take_rows``), then the padded
        joiners are appended (``join_rows``); joiner rows record ``k0 = g.k``
        and ``solve_s0``. Under a mesh the rebuilt batch rounds up to a
        multiple of the data size, retired rows kept as filler first, then
        inert rows. Returns False when nothing could join."""
        live = [i for i, r in enumerate(g.rows) if not r.done]
        cap = self._chunk_cap - len(live)
        if cap <= 0:
            return False
        take, rest = [], []
        for p in cands:
            if len(take) < cap and p.plan.n_steps <= g.plan.n_steps:
                take.append(p)
            else:
                rest.append(p)
        if not take:
            return False
        cands[:] = rest
        keep, n_inert = self._round_keep(g, live, len(take))
        g.plan = take_rows(g.plan, keep)
        g.rows = [g.rows[i] for i in keep]
        for r in g.rows:
            if r.done:          # retained retired row: structural filler
                r.pad = True
        padded = [pad_plan(p.plan, g.plan.n_steps) for p in take]
        seeds = [p.req.seed for p in take]
        lens = [p.req.seq_len for p in take]
        new_rows = [_Row(req=p.req, n_steps=p.plan.n_steps, nfe=p.plan.nfe,
                         deadline=self._abs_deadline(p.req, p.t_sub),
                         k0=g.k, solve_s0=g.solve_s, wait_s=now - p.t_sub)
                    for p in take]
        if n_inert:
            padded += [inert_row(padded[0])] * n_inert
            seeds += [0] * n_inert
            lens += [g.seq_len] * n_inert
            new_rows += [_Row(req=None, n_steps=0, nfe=0, deadline=math.inf,
                              done=True, pad=True, k0=g.k) for _ in range(n_inert)]
        g.plan = join_rows(g.plan, padded)
        g.state = SAMPLER.join_state_rows(   # the kept rows and the joiners, one move
            g.state, self._new_state(padded, seeds, lens, g.seq_len),
            shardings=g.shardings[1], rows=keep)
        g.rows += new_rows
        self._regroup(g)
        self._m_joined.inc(len(take))
        return True

    def _round_keep(self, g: _Group, live: list[int],
                    n_new: int) -> tuple[list[int], int]:
        """Rebuild arithmetic shared by compaction and joining: the rebuilt
        batch is ``len(live) + n_new`` rounded up to a multiple of the data
        size, the gap filled with retired rows kept as filler (original
        filler first, then retired requests, lowest index first). Returns
        ``(keep, n_inert)``: the rows to gather (original order) and how
        many fresh inert rows must still be made (only when joining)."""
        target = len(live) + n_new
        target += (-target) % self._data_size
        fillers = [i for i, r in enumerate(g.rows) if r.done]
        fillers.sort(key=lambda i: (not g.rows[i].pad, i))
        reuse = fillers[:max(0, target - len(live) - n_new)]
        return sorted(live + reuse), target - len(live) - n_new - len(reuse)

    def _compact_target(self, g: _Group, live: list[int]) -> list[int] | None:
        """Rows to keep when compacting ``g``, or None to skip: unsharded,
        exactly the live rows; under a mesh a multiple of the data size, and
        None when that would not shrink the batch."""
        keep, _ = self._round_keep(g, live, 0)
        return None if len(keep) >= len(g.rows) else keep

    def _compact(self, g: _Group, keep: list[int]) -> None:
        """Re-pack the kept rows into a smaller (sig, batch, seq_len)
        executor: plan rows and state rows move whole, so the survivors'
        samples are bit-identical to an uncompacted solve."""
        self._m_compactions.inc()
        g.plan = take_rows(g.plan, keep)
        g.state = SAMPLER.take_state_rows(g.state, keep, shardings=g.shardings[1])
        g.rows = [g.rows[i] for i in keep]
        for r in g.rows:
            if r.done:
                r.pad = True        # retained retired row: structural filler
        self._regroup(g)

    def _regroup(self, g: _Group) -> None:
        """After a join or compaction: the group's horizon and urgency from
        its live rows, its executor plan, and the executor for its new
        batch."""
        live = [r for r in g.rows if not r.done]
        g.n_steps = max(r.k0 + r.n_steps for r in live)
        g.priority = max(r.req.priority for r in live)
        g.deadline = min(r.deadline for r in live)
        g.exec_plan = self._exec_plan(g.plan, g.shardings)
        g.fn, compile_s = self._executor(g.sig, len(g.rows), g.seq_len)
        g.compile_s += compile_s

    def _select(self) -> tuple[list[_Group], list[_Group]]:
        """Order active groups by urgency; return (stepped, skipped)."""
        order = sorted(self._active, key=self._group_key)
        if self.steps_per_tick is None:
            return order, []
        return order[:self.steps_per_tick], order[self.steps_per_tick:]

    @property
    def busy(self) -> bool:
        """True while any request is pending admission or mid-solve, or a
        boundary Result awaits drain."""
        return bool(self._pending or self._active or self._boundary_results)

    def reset(self) -> None:
        """Abort all pending and in-flight work (queues cleared; the plan and
        executor caches survive -- they are pure and reusable). This is the
        recovery point after a failed tick leaves group state unreliable:
        the driver calls it before failing the affected requests' futures
        (without a mesh: a mesh engine fails closed instead)."""
        self._need_leader("reset")
        if self.mesh is not None:
            self._ops.append(("reset",))
        self._reset()

    def _reset(self) -> None:
        self._pending.clear()
        self._active.clear()
        self._boundary_results.clear()
        self._g_queue.set(0)
        self._g_groups.set(0)
        self._g_occupancy.set(0.0)

    @property
    def num_executors(self) -> int:
        """Executors alive -- one per (plan.signature, batch, seq_len,
        mesh); growth during steady-state traffic means new executors."""
        # repro: allow[RL003] GIL-atomic len() for stats; one-tick staleness is fine
        return len(self._compiled)

    def tick(self, *, on_step=None, stream_decode: bool = False) -> list[Result]:
        """One scheduler tick: admit (join/compact at boundaries, else fresh
        groups), advance the selected groups one solver step each, emit
        Results for rows that finished.

        All selected group steps are dispatched before any is waited on;
        each group's ``solve_s`` is the time from its dispatch to its step
        being done on the device. Under a mesh the leader first broadcasts
        the tick's inputs, and a tick that raises fails closed (see the
        module docstring)."""
        self._need_leader("tick")
        now = time.perf_counter()
        events = on_step is not None
        stream = events and stream_decode
        evict = self._expired(now) if self.enforce_deadlines else ()
        if self.mesh is None:
            return self._tick(now, evict, on_step, events, stream)
        return self._collective(self._lead_tick, now, evict, on_step, events, stream)

    def _lead_tick(self, now, evict, on_step, events, stream) -> list[Result]:
        self._bcast({"kind": "tick", "ops": self._take_ops(), "now": now,
                     "evict": evict, "events": events, "stream": stream})
        return self._tick(now, evict, on_step, events, stream)

    def _tick(self, now: float, evict, on_step, events: bool,
              stream: bool) -> list[Result]:
        t_tick = time.perf_counter()
        with self.tracer.span("admit"):
            self._admit(now, evict)
        self._m_ticks.inc()
        finished: list[Result] = []
        if self._boundary_results:
            finished += self._boundary_results
            self._boundary_results = []
        stepped, skipped = self._select()
        for g in skipped:
            g.skipped += 1
        dispatched = []
        with self.tracer.span("dispatch"):
            for g in stepped:
                g.skipped = 0
                # with compaction on, the boundary pass has already removed
                # (or made filler of) every retired row, so this stays zero
                self._m_wasted.inc(sum(r.done and not r.pad for r in g.rows))
                lo, hi = self._row_block(len(g.rows))
                rows = g.rows[lo:hi]
                k_vec = [g.k - r.k0 for r in rows]
                lens_vec = torch.as_tensor(
                    [r.req.seq_len if r.req is not None else g.seq_len for r in rows],
                    device=self.device)
                t0 = time.perf_counter()
                g.state = g.fn(self.params, g.exec_plan, k_vec, g.state, lens_vec)
                dispatched.append((g, t0))
        for g, t0 in dispatched:
            with self.tracer.span("step_wait"):
                # the one wait per group step, after every group dispatched
                _wait(g.state.x)
            dt_step = time.perf_counter() - t0
            g.solve_s += dt_step
            self._h_step.observe(dt_step)
            g.k += 1
            newly = [i for i, r in enumerate(g.rows)
                     if not r.done and r.k0 + r.n_steps == g.k]
            real = g.real_idx
            stream_toks = None
            if stream:
                stream_toks = self._decode_rows(g, list(range(len(g.rows))))
            # one host pull of the per-row error estimates serves both the
            # step event and natural-finish final_err
            err_v = None
            if g.plan.error_estimate and (events or newly):
                err_v = self._row_values(g.state.err)
            if on_step is not None:
                on_step(StepEvent(
                    uids=g.uids, k=g.k, n_steps=g.n_steps,
                    tokens=stream_toks[real] if stream_toks is not None else None,
                    row_steps=tuple(g.rows[i].n_steps for i in real),
                    row_k=tuple(g.k - g.rows[i].k0 for i in real),
                    row_seq_lens=tuple(g.rows[i].req.seq_len for i in real),
                    row_err=tuple(float(err_v[i]) for i in real)
                    if err_v is not None else None))
            if newly:
                new_toks = (stream_toks[newly] if stream_toks is not None
                            else self._decode_rows(g, newly))
                for j, i in enumerate(newly):
                    row = g.rows[i]
                    row.done = True
                    # final_err is None (not +inf) when no estimate exists:
                    # Results serialize to strict JSON
                    f_err = None
                    if err_v is not None and math.isfinite(err_v[i]):
                        f_err = float(err_v[i])
                    res = Result(
                        row.req.uid, self._tokens(new_toks, j, row.req.seq_len),
                        g.solve_s - row.solve_s0, nfe=row.nfe,
                        compile_s=g.compile_s, queue_wait_s=row.wait_s,
                        final_err=f_err)
                    self._m_completed.inc()
                    self._h_queue_wait.observe(res.queue_wait_s)
                    self._h_solve.observe(res.latency_s)
                    finished.append(res)
            if all(r.done for r in g.rows):
                self._active.remove(g)
        self._g_groups.set(len(self._active))
        slots = sum(len(g.rows) for g in self._active)
        live = sum(sum(not r.done for r in g.rows) for g in self._active)
        self._g_occupancy.set(live / slots if slots else 0.0)
        self._h_tick.observe(time.perf_counter() - t_tick)
        return finished

    def serve(self, requests: list[Request], *, on_step=None,
              stream_decode: bool = False) -> list[Result]:
        """Submit ``requests`` and run the scheduler until all solves
        finish. Validation is all-or-nothing for this call."""
        self._need_leader("serve")
        n0, n_ops = len(self._pending), len(self._ops)
        try:
            for r in requests:
                self.submit(r)
        except Exception:
            while len(self._pending) > n0:
                self._pending.pop()
            del self._ops[n_ops:]
            raise
        results: list[Result] = []
        while self.busy:
            results += self.tick(on_step=on_step, stream_decode=stream_decode)
        return results
