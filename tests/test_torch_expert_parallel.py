"""Expert-parallel MoE on torch.distributed (``sharding/expert_parallel``),
4 gloo ranks on the CPU: reduced mixtral with 4 experts, top-2,
``capacity_factor`` 100 (no drops), each rank routing its own row of the
batch and holding one expert. Held to the port's ``layers.moe`` (both
dispatch modes) and to the reference's ``L.moe`` on the reference's
weights and tokens, within the reference's own bounds
(``tests/test_expert_parallel.py``): 2e-4 on the output, 1e-3 on the
load-balance loss (the expert-parallel loss averages the ranks' losses, as
the reference's ``pmean`` does)."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.models import layers as RL
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from test_torch_sharded_serving import spawn

OUT_TOL = 2e-4
LB_TOL = 1e-3
WORLD = 4


def _cfg(get):
    cfg = get("mixtral_8x7b").reduced().with_(objective="ar")
    return cfg.with_(moe=dataclasses.replace(cfg.moe, num_experts=4, top_k=2,
                                            capacity_factor=100.0))


_CHILD = r'''
import json, sys, dataclasses
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, data_path, out_path = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_request_mesh
from repro_torch.sharding.expert_parallel import moe_expert_parallel

cfg = get_config("mixtral_8x7b").reduced().with_(objective="ar")
cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, num_experts=4, top_k=2,
                                        capacity_factor=100.0))
data = torch.load(data_path, weights_only=False)
x, b, got = data["x"], data["x"].shape[0] // world, {}
for whole in ("1", "0"):
    params = data["params"]
    if whole == "0":       # this rank's expert only
        e_loc = cfg.moe.num_experts // world
        params = dict(params, **{k: params[k][rank * e_loc:(rank + 1) * e_loc]
                                 for k in ("w_up", "w_gate", "w_down")})
    out, aux = moe_expert_parallel(params, cfg, x[rank * b:(rank + 1) * b],
                                   make_request_mesh())
    parts = [torch.empty_like(out) for _ in range(world)]
    dist.all_gather(parts, out)
    lbs = [None] * world
    dist.all_gather_object(lbs, float(aux["moe_lb"]))
    got[whole] = (torch.cat(parts), lbs)
if rank == 0:
    torch.save(got, out_path)
dist.barrier()
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's weights and tokens, both parameter layouts through
    the ranks in one spawn; returns (weights, x, {layout: (out, per-rank lb)})."""
    rcfg = _cfg(ref_get_config)
    f32 = jax.numpy.float32
    rp = jax.tree.map(lambda a: a.astype(f32),
                      RL.init_moe(jax.random.PRNGKey(0), rcfg, f32))
    rx = jax.random.normal(jax.random.PRNGKey(1), (WORLD, 32, rcfg.d_model), f32)
    params = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    x = torch.from_numpy(np.array(rx))
    tmp = tmp_path_factory.mktemp("ep")
    torch.save({"params": params, "x": x}, tmp / "data.pt")
    spawn(_CHILD, WORLD, tmp, args=(tmp / "data.pt", tmp / "out.pt"))
    outs = torch.load(tmp / "out.pt", weights_only=False)
    ref_out, ref_aux = RL.moe(rp, rcfg, rx)
    return params, x, outs, (np.asarray(ref_out), float(ref_aux["moe_lb"]))


@pytest.mark.parametrize("whole", ["1", "0"], ids=["all_experts", "own_expert"])
@pytest.mark.parametrize("against", ["port_gather", "port_einsum", "reference"])
def test_expert_parallel_matches_moe(run, whole, against):
    params, x, outs, (ref_out, ref_lb) = run
    out, lbs = outs[whole]
    assert len(set(lbs)) == 1          # the averaged loss is the same on every rank
    if against == "reference":
        want, want_lb = ref_out, ref_lb
    else:
        cfg = _cfg(get_config).with_(moe_dispatch=against.split("_")[1])
        w, aux = L.moe(params, cfg, x)
        want, want_lb = w.numpy(), float(aux["moe_lb"])
    err = float(np.abs(out.numpy() - want).max())
    assert err < OUT_TOL, err
    assert abs(lbs[0] - want_lb) < LB_TOL, (lbs[0], want_lb)


def test_expert_count_must_divide_the_ranks():
    from repro_torch.sharding.expert_parallel import moe_expert_parallel

    class OneAxis:      # a 3-rank axis: 4 experts do not divide
        shape = (3,)
        mesh_dim_names = ("data",)

        def get_local_rank(self, axis):
            return 0

        def get_group(self, axis):
            return None
    with pytest.raises(ValueError, match="do not divide"):
        moe_expert_parallel(L.init_moe(torch.Generator().manual_seed(0), _cfg(get_config),
                                       torch.float32, "cpu"),
                            _cfg(get_config), torch.zeros(1, 4, 8), OneAxis())
