"""Small trained score networks for the faithful-reproduction experiments
(the counterpart of ``repro.diffusion.score_net``).

The paper's checkpoints (CIFAR10 UNets) are unavailable offline; these
stand in as *real trained models with real fitting error*, which is what
the paper's analysis needs (Sec. 3.1: the learned score is inaccurate off
the data manifold). The analytic GMM oracles isolate pure discretization
error; these nets add the fitting-error axis.

Random numbers come from a ``torch.Generator`` (``data_fn(gen, n)``
replaces the reference's ``data_fn(key, n)``), so a run repeats itself but
draws other numbers than the reference's; :func:`make_score_step` takes
``(x0, t, eps)`` from the caller, the seam on which a test holds one step
to the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..core.sde import SDE
from ..device import resolve_device
from ..models.layers import sinusoidal_embedding
from ..training.optimizer import AdamW, cosine_schedule, value_and_grad


def init_mlp_score_net(gen: torch.Generator, data_dim: int, hidden: int = 128,
                       depth: int = 3, t_dim: int = 64, dtype=torch.float32):
    """An MLP eps-net's params on ``gen``'s device, the reference's shapes
    and scales: ``t_proj`` (t_dim, hidden), ``depth`` silu layers over
    ``[x, time features]``, and an ``out`` layer scaled by 1e-3."""
    n = lambda *shape: torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
    zeros = lambda *shape: torch.zeros(shape, device=gen.device, dtype=dtype)
    p = {"t_proj": n(t_dim, hidden) * (1 / math.sqrt(t_dim))}
    dims = [data_dim + hidden] + [hidden] * depth
    p["layers"] = [{"w": n(dims[i], hidden) * (1 / math.sqrt(dims[i])), "b": zeros(hidden)}
                   for i in range(depth)]
    p["out"] = {"w": n(hidden, data_dim) * 1e-3, "b": zeros(data_dim)}
    return p


def mlp_score_apply(params, x, t, t_dim: int = 64):
    """x: (B, D); t scalar or (B,). Returns the eps prediction (B, D), in
    the wider of x's and the params' dtypes (as JAX promotes)."""
    b = x.shape[0]
    t_b = torch.as_tensor(t, device=x.device).to(torch.float32).expand(b)
    w = params["t_proj"]
    dtype = torch.promote_types(x.dtype, w.dtype)
    te = sinusoidal_embedding(t_b, t_dim).to(dtype) @ w.to(dtype)
    h = torch.cat([x.to(dtype), te], dim=-1)
    for layer in params["layers"]:
        h = F.silu(h @ layer["w"].to(dtype) + layer["b"].to(dtype))
    return h @ params["out"]["w"].to(dtype) + params["out"]["b"].to(dtype)


@dataclasses.dataclass
class TrainedScoreModel:
    params: dict
    sde: SDE
    t_dim: int = 64

    def eps_fn(self) -> Callable:
        params, t_dim = self.params, self.t_dim

        def eps(x, t):
            return mlp_score_apply(params, x, t, t_dim).to(x.dtype)

        return eps


def make_score_step(sde: SDE, opt: AdamW):
    """``step(params, opt_state, x0, t, eps) -> (params, opt_state, loss)``:
    one optimizer step of denoising score matching (paper Eq. 9,
    eps-parameterization, uniform weights) on the given draws; params and
    moments are updated in place (``AdamW.update``)."""
    def loss_fn(p, x0, t, eps):
        mu = sde.mu(t)[:, None]
        sig = sde.sigma(t)[:, None]
        xt = mu * x0 + sig * eps
        pred = mlp_score_apply(p, xt, t)
        return torch.mean(torch.square(pred - eps))

    def step(params, opt_state, x0, t, eps):
        loss, grads = value_and_grad(loss_fn, params, x0, t, eps)
        params, opt_state, _ = opt.update(grads, opt_state, params)
        return params, opt_state, loss
    return step


def train_score_net(sde: SDE, data_fn, data_dim: int, *, steps: int = 2000,
                    batch: int = 512, lr: float = 1e-3, hidden: int = 128,
                    depth: int = 3, seed: int = 0, log_every: int = 0,
                    device=None) -> TrainedScoreModel:
    """Denoising score matching on ``device`` (None means CUDA).
    ``data_fn(gen, n)`` -> (n, D) samples; each step draws x0, then ``t`` ~
    U(t0, T), then ``eps``, from one generator seeded ``seed`` (which
    first draws the initial params)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_mlp_score_net(gen, data_dim, hidden, depth)
    opt = AdamW(cosine_schedule(lr, steps // 20, steps), weight_decay=1e-4)
    opt_state = opt.init(params)
    step = make_score_step(sde, opt)
    for i in range(steps):
        x0 = data_fn(gen, batch)
        t = torch.rand((batch,), generator=gen, device=device) * (sde.T - sde.t0) + sde.t0
        eps = torch.randn(x0.shape, generator=gen, device=device, dtype=x0.dtype)
        params, opt_state, loss = step(params, opt_state, x0, t, eps)
        if log_every and i % log_every == 0:
            print(f"  score-net step {i}: loss {float(loss):.4f}")
    return TrainedScoreModel(params, sde)
