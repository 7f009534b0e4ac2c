"""The port's policy for the analysis pass: which files are hot path
(RL001), what a tensor may be asked inside a branch test, who owns which
serving-stack attribute (RL003), and the plan's leaf-role registries
(RL004).

This is deliberately data, not code: adding a new hot module or a new
engine/driver attribute means editing a table here (and the checkers tell
you when you forgot -- RL003 fails on attributes missing from the ownership
table). Scope patterns are regexes matched against the END of the posix
path, so the tables work from any checkout root and on the test fixtures.
"""
from __future__ import annotations

import dataclasses


# ------------------------------------------------------------- RL001 scopes
# Sub-check groups. "sync" = explicit host syncs (.item(), .cpu(),
# .to("cpu"), .numpy(), .tolist(), stream/event/device synchronize(),
# np.asarray/np.array of device values, print); "coerce" = float()/int()/
# bool() of possibly-device values; "branch" = Python `if`/`while` on a
# tensor expression (an implicit bool(), which waits for the device).
SYNC = "sync"
COERCE = "coerce"
BRANCH = "branch"
ALL_CHECKS = frozenset({SYNC, COERCE, BRANCH})
SYNC_ONLY = frozenset({SYNC})


@dataclasses.dataclass(frozen=True)
class HotScope:
    """One hot-path region: a path pattern plus what is in scope there.

    ``functions``: only these def names are hot (None = whole module).
    ``entry``: ``(Class, method)`` -- the hot region is every method of
    Class reachable from that entry through self-calls, and every function
    of the module those methods call by name (used for the engine tick
    path, so scheduling helpers stay covered as they are added).
    """
    pattern: str
    checks: frozenset = ALL_CHECKS
    functions: tuple | None = None
    entry: tuple | None = None


# The solver executor (every step of every served group runs it), the plan
# splice and placement primitives serving calls between steps, the kernels
# and their plain versions, the observability fast path (spans/metrics sit
# inside the tick), and the engine tick path itself.
HOT_SCOPES = (
    HotScope(r"core/sampler\.py$"),
    HotScope(r"core/plan\.py$", functions=(
        # splice primitives + signature/role helpers run per tick inside the
        # serving loop, and the engine moves and places plans with to /
        # place_plan / _row_index; plan_* builders are host-side float64
        # precompute by contract and are RL004's concern instead.
        "astype", "stack_plans", "pad_plan", "take_rows", "join_rows",
        "inert_row", "_rowless_signature", "_leaf_role", "signature",
        "family", "n_steps", "batch", "history_len", "to", "place_plan",
        "_row_index")),
    HotScope(r"kernels/[^/]+\.py$"),
    HotScope(r"obs/(trace|metrics)\.py$", checks=SYNC_ONLY),
    HotScope(r"serving/engine\.py$",
             entry=("DiffusionServeEngine", "tick")),
)

# Tensor attributes and methods that return host metadata, not device
# values -- fine inside an `if` test, and host-side for the taint pass.
HOST_SAFE_TENSOR_ATTRS = frozenset({"shape", "ndim", "dtype", "device",
                                    "is_cuda"})
HOST_SAFE_TENSOR_METHODS = frozenset({"dim", "numel", "size"})
# torch functions that return host values (predicates, dtypes, devices).
HOST_SAFE_TORCH = frozenset({
    "is_tensor", "is_floating_point", "is_complex", "is_grad_enabled",
    "device", "Size", "finfo", "iinfo", "get_default_dtype",
    "promote_types", "can_cast", "cuda.is_available", "cuda.device_count",
    "cuda.current_device", "cuda.get_device_name",
    "distributed.is_initialized", "distributed.get_rank",
    "distributed.get_world_size"})


# ---------------------------------------------------------- RL003 ownership
@dataclasses.dataclass(frozen=True)
class Ownership:
    """Thread-ownership declaration for one serving-stack class.

    Buckets (fnmatch patterns over attribute names):
      ``config``    -- immutable after __init__; readable from any thread,
                       never reassigned outside __init__.
      ``scheduler`` -- scheduler-thread-only state; never touched from a
                       transport-reachable method.
      ``locked``    -- shared state; every access must sit inside
                       ``with self.<lock>:``  (except in __init__).
      ``atomic``    -- intrinsically thread-safe objects (queue.Queue,
                       threading.Event, metrics handles): any thread, no lock.

    ``transport_entries`` are the public thread-safe entry points; methods
    reachable from them (through self-calls and ``delegates``) inherit the
    transport context and must obey the scheduler-only restriction. ``"*"``
    means every method. ``scheduler_entries`` seed the scheduler context
    (the tick loop). ``delegates`` maps attribute -> class for cross-object
    call-graph edges (the driver holding the engine).
    """
    lock: str | None = None
    transport_entries: tuple = ()
    scheduler_entries: tuple = ()
    config: tuple = ()
    scheduler: tuple = ()
    locked: tuple = ()
    atomic: tuple = ()
    delegates: dict = dataclasses.field(default_factory=dict)


OWNERSHIP = {
    # The engine is single-threaded by contract: the driver's scheduler
    # thread owns it (and, under a mesh, makes its collectives). Anything
    # the driver's transport surface reads off it must be a metrics handle
    # (atomic) or carry an explicit allow.
    "DiffusionServeEngine": Ownership(
        scheduler_entries=("tick", "serve", "submit", "cancel", "reset",
                           "busy"),
        config=("cfg", "sde", "schedule", "max_group", "steps_per_tick",
                "aging_ticks", "compaction", "join", "seq_len_buckets",
                "mesh", "_mesh_key", "_data_size", "_chunk_cap", "params",
                "enforce_deadlines", "retire", "metrics", "tracer",
                "device", "_rank", "_src", "_ctl"),
        scheduler=("_plans", "_compiled", "_pending", "_active", "_arrivals",
                   "_boundary_results", "_ops", "_failed"),
        atomic=("_m_*", "_g_*", "_h_*"),
    ),
    "ServeDriver": Ownership(
        lock="_lock",
        transport_entries=("submit", "submit_async", "cancel", "stats",
                           "start", "stop", "__enter__", "__exit__"),
        scheduler_entries=("_run",),
        config=("engine", "stream_decode", "idle_wait_s", "max_pending",
                "metrics"),
        locked=("_streams", "_thread", "_failed"),
        atomic=("_inbox", "_stop", "_lock", "_m_*", "_h_*"),
        delegates={"engine": "DiffusionServeEngine"},
    ),
    # Registration is the only locked registry operation; the metric handles
    # themselves are single-writer lock-free by design.
    "MetricsRegistry": Ownership(
        lock="_lock",
        transport_entries=("*",),
        locked=("_metrics",),
        atomic=("_lock",),
    ),
}


# ---------------------------------------------------------- RL004 registries
# The leaf-role registries in core/plan.py that every plan_* coefficient key
# must be classifiable by, and the modifier set allowed to overlap the
# primary roles.
ROLE_REGISTRIES = ("_STEP_LEAVES", "_KNOT_LEAVES", "_STATIC_LEAVES")
MODIFIER_REGISTRIES = ("_TIME_LEAVES",)


# ------------------------------------------------------------ RL005 routing
# Where the kernel wrappers live: an `except` there must not fall back to
# the plain version or swallow the kernel's error.
KERNEL_SCOPE = r"kernels/[^/]+\.py$"
