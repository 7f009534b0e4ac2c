"""Single executor for every :class:`~repro_torch.core.plan.SolverPlan`.

The counterpart of ``repro.core.sampler``. Public API:

  ``sample(plan, eps_fn, x_T, key=None, *, hooks=None, tracer=NULL_TRACER, noise=None)``
      Run the full fixed-step solve; returns ``x_0`` (or ``(x_0,
      trajectory)`` when ``hooks.record_trajectory`` is set).

  ``step(plan, k, state, eps_fn, *, hooks=None, noise=None)``
      One solver step on an explicit ``SamplerState``; ``sample`` is exactly
      ``init_state`` + ``step`` iterated. For a stacked plan ``k`` may be a
      per-row host index vector: row ``i`` advances from its own step
      ``k[i]`` (clamped to the grid), which is what lets serving join a
      fresh request into a group whose rows are mid-solve.

  ``init_state(plan, x_T, key=None)``
      Build the initial ``SamplerState``.

Request-axis sharding (``mesh=``, ``shardings=``). The port is
multi-controller: one process per device, each running the same call on
the same whole inputs. ``sample``/``step`` with ``mesh`` (a 1-axis
``('data',)`` ``DeviceMesh``) cut every request-axis leaf into contiguous
row blocks, solve this rank's block, and all-gather the result over the
mesh's group, so every rank returns the whole answer. Rows never mix, so
the result is the unsharded one bitwise wherever the eps-net is
batch-invariant (the CPU). ``take_state_rows``/``join_state_rows`` with
``shardings`` work on this rank's block and move rows between ranks when
the new layout gives a row another owner: ``x``, ``hist`` and ``err`` in
one ``all_to_all_single`` over the mesh's group (NCCL between cards), each
row's generator state over the mesh's gloo control group.

Random numbers. A stochastic plan draws its per-step noise from
``state.key``: one ``torch.Generator`` for an unstacked solve, a tuple of
per-row generators for a stacked one. Stacked rows draw row by row, each
from its own generator at the row's own shape, so a row of a stacked solve
draws exactly what the same request solved alone draws. The ``noise=``
argument of ``step``/``sample`` is a seam that replaces the draw (tests
inject the JAX reference's own draws through it).

The executor runs eagerly; ``k`` and the plan's static metadata are read on
the host, tensors stay on the plan's device, and nothing here synchronises
with the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.ops import fused_ab_step as _fused_ab_step
from ..obs.trace import NULL_TRACER
from .plan import SolverPlan, _row_index, place_plan

Tensor = torch.Tensor
EpsFn = Callable[[Tensor, Tensor], Tensor]


class SamplerState(NamedTuple):
    """Explicit solver state: everything needed to resume a solve mid-way."""
    x: Tensor     # current iterate
    hist: Tensor  # (H, *x.shape) eps history, newest first (H may be 0)
    key: object   # noise generator(s): None, a torch.Generator (unstacked)
    #               or a tuple of per-row generators (stacked)
    k: int        # step counter (informational; `step` takes k explicitly)
    err: Tensor   # running local-error estimate: max-abs (Linf) of the last
    #               step's embedded lower-order difference; (R,) stacked,
    #               scalar unstacked; +inf until the plan produces a first
    #               estimate. Linf because a max does not depend on the
    #               reduction order, so err is bitwise identical across batch
    #               compositions (the serving early-exit invariant).


@dataclasses.dataclass(frozen=True)
class Hooks:
    """Per-step extension points.

    eps_transform: ``(x, t, eps) -> eps`` applied to every network output.
    record_trajectory: when True, ``sample`` also returns the (n_steps, ...)
        stack of post-step iterates.
    """
    eps_transform: Optional[Callable[[Tensor, Tensor, Tensor], Tensor]] = None
    record_trajectory: bool = False


_DEFAULT_HOOKS = Hooks()


def _clone_generator(g):
    """A generator at ``g``'s state: splices copy key chains by value, as the
    reference copies its PRNG keys, so two states never share one chain."""
    if g is None:
        return None
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


def init_state(plan: SolverPlan, x_T: Tensor, key=None) -> SamplerState:
    """Build the initial :class:`SamplerState` for ``plan`` at ``x_T``.

    Unstacked plans take ``x_T`` of any shape and an optional generator; a
    stacked plan of ``R`` requests takes ``x_T`` of shape ``(R, *inner)``
    and a sequence of ``R`` per-row generators. A stochastic plan needs
    generators unless every step receives ``noise=``. ``hist`` is
    ``(plan.history_len, *x_T.shape)`` zeros."""
    if plan.stacked:
        if x_T.ndim < 1 or x_T.shape[0] != plan.batch:
            raise ValueError(f"stacked plan of {plan.batch} requests needs "
                             f"x_T with leading axis {plan.batch}, got "
                             f"{tuple(x_T.shape)}")
        key = (None,) * plan.batch if key is None else tuple(key)
        if len(key) != plan.batch:
            raise ValueError(f"stacked plan of {plan.batch} requests needs "
                             f"{plan.batch} per-request generators, got "
                             f"{len(key)}")
    hist = x_T.new_zeros((plan.history_len,) + tuple(x_T.shape))
    err = torch.full(tuple(x_T.shape[:1]) if plan.stacked else (),
                     float("inf"), dtype=x_T.dtype, device=x_T.device)
    return SamplerState(x=x_T, hist=hist, key=key, k=0, err=err)


def take_state_rows(state: SamplerState, rows, shardings=None) -> SamplerState:
    """Row-gather a stacked solve's state: keep requests ``rows`` (a host
    index sequence), in order. ``x`` is gathered on axis 0, ``hist`` on
    axis 1 and the per-row generators move with their rows, so a compacted
    solve continues bit-exactly (the state half of mid-flight compaction;
    the plan half is :func:`repro_torch.core.plan.take_rows`).

    ``shardings`` (a ``SamplerState`` of ``NamedSharding``, from
    :func:`_request_shardings`) makes it the sharded half: ``state`` is this
    rank's row block, ``rows`` index the whole row axis (the ranks' blocks
    in rank order), and the result is this rank's block of the ``len(rows)``
    kept rows (collective: every rank of the mesh calls it)."""
    rows = list(rows)
    mesh = _row_mesh(shardings)
    if mesh is not None:
        return _move_rows(state, rows, None, mesh)
    idx = _row_index(rows, state.x.device)
    key = tuple(_clone_generator(state.key[i]) for i in rows)
    return SamplerState(x=state.x[idx], hist=state.hist[:, idx], key=key,
                        k=state.k, err=state.err[idx])


def join_state_rows(state: SamplerState, new: SamplerState,
                    shardings=None, rows=None) -> SamplerState:
    """Splice a fresh stacked state onto an in-flight stacked solve's rows.

    ``x``, ``err`` and the generators concatenate on the row axis, ``hist``
    on axis 1, so the veteran rows keep their slots bit-for-bit and the
    joiners start from zero history and their untouched generators -- what
    a solo solve starts from. ``k`` keeps the veteran counter (the serving
    engine tracks per-row counts on the host). ``rows`` (a host index
    sequence) keeps only those veterans, in order, as
    :func:`take_state_rows` would first.

    ``shardings`` (as for :func:`take_state_rows`): ``state`` is this
    rank's block of the veteran rows, ``new`` the joiners' whole state
    (every rank holds it), and the result this rank's block of the kept
    veterans then the joiners, in one row move (collective)."""
    if not isinstance(state.key, tuple) or not isinstance(new.key, tuple):
        raise ValueError("join_state_rows splices stacked states (per-row "
                         "generator tuples on both sides)")
    if state.hist.shape[0] != new.hist.shape[0]:
        raise ValueError(f"history length mismatch: {state.hist.shape[0]} vs "
                         f"{new.hist.shape[0]} (joiners must share the "
                         "group's plan family)")
    mesh = _row_mesh(shardings)
    if mesh is not None:
        return _move_rows(state, rows, new, mesh)
    if rows is not None:
        state = take_state_rows(state, rows)
    key = tuple(_clone_generator(g) for g in state.key + new.key)
    return SamplerState(x=torch.cat([state.x, new.x], dim=0),
                        hist=torch.cat([state.hist, new.hist], dim=1),
                        key=key, k=state.k,
                        err=torch.cat([state.err, new.err], dim=0))


# ----------------------------------------------------- request-axis sharding
def _request_shardings(plan: SolverPlan, state: SamplerState, mesh):
    """(plan, state) ``NamedSharding`` trees for data-parallel stacked
    execution."""
    from ..sharding.rules import plan_specs, state_specs, to_shardings
    return (to_shardings(plan_specs(plan, mesh), mesh),
            to_shardings(state_specs(state, mesh), mesh))


def _row_mesh(shardings):
    """The mesh that ``shardings`` cuts the row axis over, or None when the
    rows replicate (no shardings, an unstacked state, or a batch the data
    axis does not divide)."""
    if shardings is None or shardings.x.spec[:1] in ((), (None,)):
        return None
    return shardings.x.mesh


def _rank(mesh) -> tuple[int, int]:
    """(this rank's index on the data axis, the axis size)."""
    return mesh.get_local_rank(mesh.mesh_dim_names[0]), mesh.size(0)


def place_state(state: SamplerState, shardings) -> SamplerState:
    """This rank's block of a whole stacked state (no communication)."""
    if _row_mesh(shardings) is None:
        return state
    from ..sharding.rules import block_range
    me, w = _rank(shardings.x.mesh)
    lo, hi = block_range(len(state.key), w, me)
    return SamplerState(x=shardings.x.local(state.x),
                        hist=shardings.hist.local(state.hist),
                        key=state.key[lo:hi], k=state.k,
                        err=shardings.err.local(state.err))


def shard_state(plan: SolverPlan, state: SamplerState, mesh):
    """This rank's blocks of a whole stacked (plan, state) pair: every
    request-axis leaf (coefficients, ``ts``, ``x``, ``hist``, ``err``, the
    generators) cut into contiguous row blocks over ``mesh``'s data axis
    when the batch divides it; otherwise both stay whole (replicated)."""
    plan_sh, state_sh = _request_shardings(plan, state, mesh)
    if _row_mesh(state_sh) is None:
        return plan, state
    return place_plan(plan, plan_sh), place_state(state, state_sh)


def _gen_state(g):
    return None if g is None else g.get_state()


def _gen_from(st, device):
    if st is None:
        return None
    g = torch.Generator(device=device)
    g.set_state(st)
    return g


def _pack_rows(state: SamplerState) -> Tensor:
    """(n, F): each local row's ``x``, ``hist`` and ``err`` in one row."""
    n, m = state.x.shape[0], math.prod(state.x.shape[1:])
    if not (state.x.dtype == state.hist.dtype == state.err.dtype):
        raise ValueError("row moves pack x, hist and err in one dtype")
    return torch.cat([state.x.reshape(n, m),
                      state.hist.transpose(0, 1).reshape(n, state.hist.shape[0] * m),
                      state.err.reshape(n, 1)], dim=1).contiguous()


def _unpack_rows(buf: Tensor, like: SamplerState, key, k) -> SamplerState:
    n, inner, h = buf.shape[0], tuple(like.x.shape[1:]), like.hist.shape[0]
    m = math.prod(inner)
    x = buf[:, :m].reshape((n,) + inner)
    hist = buf[:, m:m + h * m].reshape((n, h) + inner).transpose(0, 1).contiguous()
    return SamplerState(x=x, hist=hist, key=key, k=k, err=buf[:, -1].contiguous())


def _move_rows(state: SamplerState, rows, new, mesh) -> SamplerState:
    """This rank's block of a new row layout, built from the old layout's
    blocks (``state`` is this rank's): new row ``j < len(rows)`` is old
    global row ``rows[j]`` (``rows`` None: every old row in order), the rest
    come from ``new``, a whole state every rank holds. Blocks are
    ``block_range`` of the row counts. One gloo all-gather carries the
    blocks' row counts and generator states, one ``all_to_all_single`` over
    the data group carries the rows whose owner changes (and the rows that
    stay, as a local copy)."""
    from ..launch.mesh import control_group, data_group
    from ..sharding.rules import block_range
    me, w = _rank(mesh)
    info = [None] * w
    dist.all_gather_object(info, (state.x.shape[0], [_gen_state(g) for g in state.key]),
                           group=control_group(mesh))
    starts = np.cumsum([0] + [n for n, _ in info])
    gens = [st for _, sts in info for st in sts]          # whole row axis, in order
    rows = list(range(starts[-1])) if rows is None else list(rows)
    n_old = len(rows)
    n_all = n_old + (0 if new is None else new.x.shape[0])
    owner_old = lambda i: int(np.searchsorted(starts, i, side="right")) - 1
    owner_new = lambda j: next(q for q in range(w) if j < block_range(n_all, w, q)[1])
    lo, hi = block_range(n_all, w, me)
    send = [[] for _ in range(w)]          # local old indices, by new owner
    recv = [[] for _ in range(w)]          # my new rows, by old owner
    for j, i in enumerate(rows):
        if owner_old(i) == me:
            send[owner_new(j)].append(i - int(starts[me]))
        if lo <= j < hi:
            recv[owner_old(i)].append(j)
    packed = _pack_rows(state)
    order = [i for dst in send for i in dst]
    sent = packed[torch.as_tensor(order, dtype=torch.long, device=packed.device)]
    got = packed.new_empty((sum(map(len, recv)), packed.shape[1]))
    dist.all_to_all_single(got, sent, [len(r) for r in recv], [len(s) for s in send],
                           group=data_group(mesh))
    # the buffer is grouped by sender, each sender's rows in new-row order
    arrived = [j for src in recv for j in src]
    got = got[torch.as_tensor(np.argsort(arrived, kind="stable"), dtype=torch.long,
                              device=got.device)]
    dev = state.x.device
    key = [_gen_from(gens[rows[j]], dev) for j in range(lo, min(hi, n_old))]
    moved = _unpack_rows(got, state, None, state.k)
    if new is None or hi <= n_old:
        return moved._replace(key=tuple(key))
    a, b = max(lo, n_old) - n_old, hi - n_old
    key += [_clone_generator(g) for g in new.key[a:b]]
    return SamplerState(x=torch.cat([moved.x, new.x[a:b]], dim=0),
                        hist=torch.cat([moved.hist, new.hist[:, a:b]], dim=1),
                        key=tuple(key), k=state.k,
                        err=torch.cat([moved.err, new.err[a:b]], dim=0))


def _gather_rows(t: Tensor, dim: int, mesh) -> Tensor:
    """The whole row axis of equal row blocks ``t`` (rows on ``dim``)."""
    from ..launch.mesh import data_group
    _, w = _rank(mesh)
    parts = [torch.empty_like(t) for _ in range(w)]
    dist.all_gather(parts, t.contiguous(), group=data_group(mesh))
    return torch.cat(parts, dim=dim)


def _sync_generators(key: tuple, mesh) -> None:
    """After a sharded stochastic step each rank has advanced only its own
    rows' generators: set every other row's generator of the whole
    ``key`` tuple to its owner's state."""
    from ..launch.mesh import control_group
    from ..sharding.rules import block_range
    me, w = _rank(mesh)
    lo, hi = block_range(len(key), w, me)
    info = [None] * w
    dist.all_gather_object(info, [_gen_state(g) for g in key[lo:hi]],
                           group=control_group(mesh))
    for i, st in enumerate(s for part in info for s in part):
        if not lo <= i < hi and st is not None:
            key[i].set_state(st)


def _local_rows(v, mesh, n: int):
    """This rank's block of a per-row host vector or a row-leading tensor."""
    from ..sharding.rules import block_range
    me, w = _rank(mesh)
    lo, hi = block_range(n, w, me)
    return v[lo:hi]


# ------------------------------------------------------------------ steps
def _apply_eps(hooks: Hooks, x, t, eps):
    return eps if hooks.eps_transform is None else hooks.eps_transform(x, t, eps)


def _at_step(v, k, stacked: bool):
    """Per-step (or per-knot) leaf at step index ``k``: ``v[k]`` unstacked,
    ``v[:, k]`` stacked under a scalar ``k``, ``v[arange(R), k]`` stacked
    under a per-row index tensor. The gather picks the same elements as the
    scalar index when all entries agree."""
    if not stacked:
        return v[k]
    if isinstance(k, Tensor):
        return v[torch.arange(v.shape[0], device=v.device), k]
    return v[:, k]


def bcast(v, x):
    """Broadcast a per-request coefficient vector (R,) against x (R, *inner).
    No-op on scalars (unstacked plans)."""
    return v.reshape(tuple(v.shape) + (1,) * (x.ndim - v.ndim)) if v.ndim else v


def _comb(w, hist, stacked: bool):
    """History combination: sum_j w[j] hist[j] (unstacked, w: (H,)) or
    per-request sum_j w[r, j] hist[j, r] (stacked, w: (R, H))."""
    if stacked:
        return torch.einsum("rh,hr...->r...", w, hist)
    return torch.tensordot(w, hist, dims=1)


def _update_err(loc, live, prev, stacked: bool):
    """Fold one step's embedded-pair difference ``loc`` into the running
    per-row estimate: Linf where the companion weights were live, the
    previous value elsewhere (warmup rows, inert/padded steps)."""
    if stacked:
        raw = loc.abs().amax(dim=tuple(range(1, loc.ndim)))
    else:
        raw = loc.abs().max()
    return torch.where(live, raw, prev)


def _draw_noise(key, x, stacked: bool):
    """Standard normal noise like ``x``: row by row from each row's own
    generator when stacked, so a row draws what its solo solve draws."""
    if stacked:
        if any(g is None for g in key):
            raise ValueError("stochastic plan: every row needs a generator "
                             "(or pass noise= to step)")
        return torch.stack([torch.randn(tuple(x.shape[1:]), generator=g,
                                        device=x.device, dtype=x.dtype)
                            for g in key])
    if key is None:
        raise ValueError("stochastic plan requires a generator (or noise=)")
    return torch.randn(tuple(x.shape), generator=key, device=x.device,
                       dtype=x.dtype)


def _step_ab(plan: SolverPlan, k, state: SamplerState, eps_fn: EpsFn,
             hooks: Hooks, noise) -> SamplerState:
    c, stk = plan.coeffs, plan.stacked
    x = state.x
    t_k = _at_step(plan.ts, k, stk)
    psi = _at_step(c["psi"], k, stk)
    Cw = _at_step(c["C"], k, stk)
    if "nu" in c:
        # score-normalized families (sndeis): history entry j is weighted by
        # C[k, j] * nu[k, j], multiplied after the plan's cast to x's dtype
        nu = _at_step(c["nu"], k, stk)
        Cw = Cw * nu
    eps = _apply_eps(hooks, x, t_k, eps_fn(x, t_k))
    hist = torch.cat([eps[None], state.hist[:-1]], dim=0)
    s_coef = None
    if plan.stochastic:
        s_coef = _at_step(c["s"], k, stk)
        if noise is None:
            noise = _draw_noise(state.key, x, stk)
    else:
        noise = None
    Ew = live = None
    if "E" in c:
        Ew = _at_step(c["E"], k, stk)
        live = (Ew != 0).any(dim=-1)
        if "nu" in c:
            Ew = Ew * nu          # the pair difference is normalized too
    if plan.fused:
        # Flatten to the kernel's (R, M, D) layout. Unstacked solves run as
        # a one-row stack, so solo and stacked groups share the kernel's
        # per-element arithmetic (the serving bitwise-vs-solo invariant).
        n_rows = x.shape[0] if stk else 1
        inner = tuple(x.shape[1:]) if stk else tuple(x.shape)
        m = 1
        for dim in inner[:-1]:
            m *= dim
        d = inner[-1] if inner else 1
        xf = x.reshape(n_rows, m, d).contiguous()
        hf = hist.reshape(hist.shape[0], n_rows, m, d)
        if stk:
            psi_r, C_r, s_r, E_r = psi, Cw, s_coef, Ew
        else:
            psi_r, C_r = psi.reshape(1), Cw[None]
            s_r = s_coef.reshape(1) if s_coef is not None else None
            E_r = Ew[None] if Ew is not None else None
        n_r = noise.reshape(xf.shape).contiguous() if noise is not None else None
        out, err_raw = _fused_ab_step(xf, hf, psi_r, C_r, s=s_r, noise=n_r,
                                      err_coeffs=E_r)
        x_new = out.reshape(x.shape)
        if Ew is not None:
            raw = err_raw if stk else err_raw[0]
            err = torch.where(live, raw.to(state.err.dtype), state.err)
        else:
            err = state.err
    else:
        x_new = bcast(psi, x) * x + _comb(Cw, hist, stk)
        if noise is not None:
            x_new = x_new + bcast(s_coef, x) * noise
        if Ew is not None:
            err = _update_err(_comb(Ew, hist, stk), live, state.err, stk)
        else:
            err = state.err
    return SamplerState(x=x_new, hist=hist, key=state.key, k=state.k + 1,
                        err=err)


def _step_rk(plan: SolverPlan, k, state: SamplerState, eps_fn: EpsFn,
             hooks: Hooks) -> SamplerState:
    c, stk = plan.coeffs, plan.stacked
    x = state.x
    n_stages = c["b"].shape[-1]
    h = _at_step(c["h"], k, stk)
    A_k = _at_step(c["A"], k, stk)                   # (R, S, S) / (S, S)
    stage_mu = _at_step(c["stage_mu"], k, stk)       # (R, S) / (S,)
    stage_t = _at_step(c["stage_t"], k, stk)
    y = x / bcast(_at_step(c["mu"], k, stk), x)
    ks = x.new_zeros((n_stages,) + tuple(x.shape))
    for i in range(n_stages):
        y_i = y + bcast(h, x) * _comb(A_k[..., i, :], ks, stk)
        x_i = bcast(stage_mu[..., i], x) * y_i
        st_t = stage_t[..., i]
        ks[i] = _apply_eps(hooks, x_i, st_t, eps_fn(x_i, st_t))
    y = y + bcast(h, x) * _comb(c["b"], ks, stk)
    mu_next = _at_step(c["mu"], k + 1, stk)
    if "b_err" in c:
        # embedded pair difference, mapped to x-space through the same
        # mu-weighting the iterate gets
        loc = bcast(mu_next, x) * (bcast(h, x) * _comb(c["b_err"], ks, stk))
        err = _update_err(loc, h != 0, state.err, stk)
    else:
        err = state.err
    return SamplerState(x=bcast(mu_next, x) * y, hist=state.hist,
                        key=state.key, k=state.k + 1, err=err)


_N_WARMUP = 3  # PNDM pseudo-RK4 warmup steps


def _pndm_warmup(plan: SolverPlan, k, state: SamplerState, eps_fn: EpsFn,
                 hooks: Hooks) -> SamplerState:
    """Pseudo-RK4 warmup step (4 NFE). Warm-coefficient indices are clamped
    so a per-row ``k`` with tail rows stays in range (those rows are masked
    out by the caller)."""
    c, stk = plan.coeffs, plan.stacked
    x = state.x
    kw = k.clamp(max=_N_WARMUP - 1) if isinstance(k, Tensor) else min(k, _N_WARMUP - 1)
    t_c, t_m, t_n = (_at_step(plan.ts, k, stk), _at_step(c["warm_t_mid"], kw, stk),
                     _at_step(plan.ts, k + 1, stk))
    rm, cm = _at_step(c["warm_ratio_m"], kw, stk), _at_step(c["warm_coef_m"], kw, stk)
    rn, cn = _at_step(c["warm_ratio_n"], kw, stk), _at_step(c["warm_coef_n"], kw, stk)
    rm, cm = bcast(rm, x), bcast(cm, x)
    rn, cn = bcast(rn, x), bcast(cn, x)
    e1 = _apply_eps(hooks, x, t_c, eps_fn(x, t_c))
    x1 = rm * x + cm * e1
    e2 = _apply_eps(hooks, x1, t_m, eps_fn(x1, t_m))
    x2 = rm * x + cm * e2
    e3 = _apply_eps(hooks, x2, t_m, eps_fn(x2, t_m))
    x3 = rn * x + cn * e3
    e4 = _apply_eps(hooks, x3, t_n, eps_fn(x3, t_n))
    e_prime = (e1 + 2 * e2 + 2 * e3 + e4) / 6.0
    x_new = rn * x + cn * e_prime
    hist = torch.cat([e1[None], state.hist[:-1]], dim=0)
    # warmup has no embedded pair: err passes through (stays +inf pre-tail)
    return SamplerState(x=x_new, hist=hist, key=state.key, k=state.k + 1,
                        err=state.err)


def _pndm_tail(plan: SolverPlan, k, state: SamplerState, eps_fn: EpsFn,
               hooks: Hooks) -> SamplerState:
    c, stk = plan.coeffs, plan.stacked
    x = state.x
    t_k = _at_step(plan.ts, k, stk)
    psi = _at_step(c["psi"], k, stk)
    Cw = _at_step(c["C"], k, stk)
    e = _apply_eps(hooks, x, t_k, eps_fn(x, t_k))
    hist = torch.cat([e[None], state.hist[:-1]], dim=0)
    x_new = bcast(psi, x) * x + _comb(Cw, hist, stk)
    if "E" in c:
        Ew = _at_step(c["E"], k, stk)
        err = _update_err(_comb(Ew, hist, stk), (Ew != 0).any(dim=-1),
                          state.err, stk)
    else:
        err = state.err
    return SamplerState(x=x_new, hist=hist, key=state.key, k=state.k + 1,
                        err=err)


def _step_pndm(plan: SolverPlan, k, k_host, state: SamplerState,
               eps_fn: EpsFn, hooks: Hooks) -> SamplerState:
    """Warmup and tail differ structurally (4 vs 1 net evals). A per-row
    ``k`` whose rows sit on both sides of the split computes both branches
    and selects rows -- joins across the warmup boundary are correct, just
    not free. ``k_host`` is the host copy of ``k`` that decides this."""
    # repro: allow[RL001] k_host is the host copy of k (step() builds it)
    warm_rows = np.asarray(k_host) < _N_WARMUP
    if np.all(warm_rows):
        return _pndm_warmup(plan, k, state, eps_fn, hooks)
    if not np.any(warm_rows):
        return _pndm_tail(plan, k, state, eps_fn, hooks)
    w = _pndm_warmup(plan, k, state, eps_fn, hooks)
    t = _pndm_tail(plan, k, state, eps_fn, hooks)
    sel = k < _N_WARMUP
    m = bcast(sel, state.x)
    return SamplerState(x=torch.where(m, w.x, t.x),
                        hist=torch.where(m[None], w.hist, t.hist),
                        key=state.key, k=state.k + 1,
                        err=torch.where(sel, w.err, t.err))


def step(plan: SolverPlan, k, state: SamplerState, eps_fn: EpsFn, *,
         hooks: Optional[Hooks] = None, noise: Optional[Tensor] = None,
         mesh=None) -> SamplerState:
    """Advance one solver step: ``state`` at time ``ts[k]`` -> ``ts[k+1]``.

    ``k`` is a host int, or -- for a stacked plan -- a host sequence of
    per-row ints (row ``i`` steps from its own ``k[i]``; entries are clamped
    to the grid, so a row riding past its own horizon indexes only inert
    padded coefficients). ``noise`` (shaped like ``state.x``) replaces the
    stochastic draw of this step.

    ``mesh`` (collective): ``plan`` and ``state`` are whole, every rank
    steps its row block and the new state is all-gathered (``x``, ``hist``,
    ``err``, and the generators' states of a stochastic plan), so every rank
    returns the whole new state. The serving engine's executors instead
    step their own blocks and pass no mesh.
    """
    plan = plan.astype(state.x.dtype)
    if mesh is not None:
        return _step_on_mesh(plan, k, state, eps_fn, hooks, noise, mesh)
    hooks = hooks or _DEFAULT_HOOKS
    if np.ndim(k):
        if not plan.stacked:
            raise ValueError("a per-row k vector requires a stacked plan")
        # repro: allow[RL001] k is a host index vector by contract (serving bookkeeping)
        k_host = np.minimum(np.asarray(k, dtype=np.int64), plan.n_steps - 1)
        k = torch.as_tensor(k_host, device=state.x.device)
    else:
        k_host = k
    if plan.method == "ab":
        return _step_ab(plan, k, state, eps_fn, hooks, noise)
    if plan.method == "rk":
        return _step_rk(plan, k, state, eps_fn, hooks)
    if plan.method == "pndm":
        return _step_pndm(plan, k, k_host, state, eps_fn, hooks)
    raise ValueError(f"unknown step method {plan.method!r}")


def _step_on_mesh(plan, k, state, eps_fn, hooks, noise, mesh) -> SamplerState:
    plan_sh, state_sh = _request_shardings(plan, state, mesh)
    if _row_mesh(state_sh) is None:
        return step(plan, k, state, eps_fn, hooks=hooks, noise=noise)
    n = plan.batch
    local = step(place_plan(plan, plan_sh),
                 _local_rows(list(k), mesh, n) if np.ndim(k) else k,
                 place_state(state, state_sh), eps_fn, hooks=hooks,
                 noise=None if noise is None else _local_rows(noise, mesh, n))
    if plan.stochastic:
        _sync_generators(state.key, mesh)
    return SamplerState(x=_gather_rows(local.x, 0, mesh),
                        hist=_gather_rows(local.hist, 1, mesh), key=state.key,
                        k=local.k, err=_gather_rows(local.err, 0, mesh))


def sample(plan: SolverPlan, eps_fn: EpsFn, x_T: Tensor, key=None, *,
           hooks: Optional[Hooks] = None, tracer=NULL_TRACER, noise=None, mesh=None):
    """Run the full solve from ``x_T`` at ``ts[0]`` down to ``ts[-1]``.

    Returns ``x_0``, or ``(x_0, trajectory)`` if ``hooks.record_trajectory``.
    ``noise`` (indexable by step, each entry shaped like ``x_T``) replaces
    the stochastic draws. ``tracer`` (a :class:`repro_torch.obs.trace.Tracer`)
    wraps each step in a ``sample.step`` span (host-side dispatch time; no
    device sync).

    ``mesh`` (collective) shards a stacked solve's request axis: each rank
    solves its row block and the result (and trajectory) is all-gathered,
    so every rank returns the whole ``x_0``; a stochastic plan's generators
    end where the unsharded solve leaves them.
    """
    hooks = hooks or _DEFAULT_HOOKS
    state = init_state(plan, x_T, key)
    plan = plan.astype(x_T.dtype)
    whole_key, n_rows = state.key, plan.batch
    sharded = None
    if mesh is not None:
        plan_sh, state_sh = _request_shardings(plan, state, mesh)
        sharded = _row_mesh(state_sh)
        if sharded is not None:
            plan, state = place_plan(plan, plan_sh), place_state(state, state_sh)
    traj = []
    for k in range(plan.n_steps):
        nz = None if noise is None else noise[k]
        if nz is not None and sharded is not None:
            nz = _local_rows(nz, sharded, n_rows)
        with tracer.span("sample.step"):
            state = step(plan, k, state, eps_fn, hooks=hooks, noise=nz)
        if hooks.record_trajectory:
            traj.append(state.x)
    x0 = state.x
    if sharded is not None:
        if plan.stochastic:
            _sync_generators(whole_key, sharded)
        x0 = _gather_rows(x0, 0, sharded)
        traj = [_gather_rows(t, 0, sharded) for t in traj]
    return (x0, torch.stack(traj)) if hooks.record_trajectory else x0
