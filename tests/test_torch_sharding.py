"""The port's sharding rules (``sharding/rules.py``) against the reference's
(``repro.sharding.rules``) on the structural meshes of the reference's own
tests (``tests/test_sharding.py``, ``tests/test_sharded_executor.py``), and
the mesh builders' contract, without a process group.

The port's layers are unstacked, so a layer leaf's spec is the reference's
stacked spec without its leading ``n_blocks`` entry; parameter shapes come
from the reference's ``eval_shape`` (no weights are made at full size), cut
to the port's per-layer layout, whose paths and shapes are checked against
the port's own ``init_params`` on the reduced configs."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as ref_get_config
from repro.core import VPSDE as RVPSDE
from repro.core import SOLVER_NAMES
from repro.core import init_state as ref_init_state
from repro.core import make_plan as ref_make_plan
from repro.core import stack_plans as ref_stack_plans
from repro.models import transformer as RT
from repro.sharding import rules as RR
from repro_torch.configs import get_config
from repro_torch.core import VPSDE, get_timesteps, init_state, make_plan, stack_plans
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.sharding import rules as R


class FakeMesh:
    """Structural stand-in with arbitrary axis sizes (no devices needed)."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


MESH = FakeMesh(data=16, model=16)
MESH_POD = FakeMesh(pod=2, data=16, model=16)
LAYER_LISTS = ("blocks", "encoder")


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch, reduced=False):
    cfg = ref_get_config(arch)
    cfg = (cfg.reduced() if reduced else cfg).with_(objective="ar")
    return cfg, jax.eval_shape(lambda k: RT.init_params(cfg, k),
                               jax.ShapeDtypeStruct((2,), jnp.uint32))


def _port_layout(tree, n_layers: dict, block: dict):
    """The reference's stacked shape tree in the port's layout: layer ``i``
    of ``blocks`` / ``encoder`` is ``slot{i % bs}`` without the leading
    axis (meta tensors: shapes only)."""
    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items()}
        return torch.empty(tuple(node.shape[1:]), device="meta")

    out = {}
    for name, sub in tree.items():
        if name in LAYER_LISTS:
            bs = block[name]
            out[name] = [strip(sub[f"slot{i % bs}"]) for i in range(n_layers[name])]
        elif isinstance(sub, dict):
            out[name] = jax.tree.map(lambda s: torch.empty(tuple(s.shape), device="meta"), sub)
        else:
            out[name] = torch.empty(tuple(sub.shape), device="meta")
    return out


def _layout(cfg):
    return ({"blocks": cfg.n_layers, "encoder": cfg.encoder_layers},
            {"blocks": T.block_size(cfg), "encoder": 1})


def _paired(port_specs, ref_specs, block: dict):
    """(path, port spec, reference spec as the port's layout) for every leaf."""
    out = []

    def walk(p, r, path, stacked):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], r[k], path + (k,), stacked)
        elif isinstance(p, list):
            bs = block[path[-1]]
            for i, leaf in enumerate(p):
                walk(leaf, r[f"slot{i % bs}"], path + (i,), True)
        else:
            ref = tuple(r)
            out.append((path, tuple(p), ref[1:] if stacked and ref else ref))
    walk(port_specs, ref_specs, (), False)
    return out


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "cifar10_scorenet"])
def test_port_layout_matches_init_params(arch):
    """The layout the spec tests use is the port's own: same paths and
    shapes as ``init_params`` on the reduced config."""
    rcfg, shapes = _ref_shapes(arch, reduced=True)
    cfg = get_config(arch).reduced().with_(objective="ar")
    port = T.init_params(cfg, 0, "cpu")
    laid = _port_layout(shapes, *_layout(cfg))

    def shape_tree(t):
        if isinstance(t, dict):
            return {k: shape_tree(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shape_tree(v) for v in t]
        return tuple(t.shape)
    assert shape_tree(laid) == shape_tree(port)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "cifar10_scorenet"])
@pytest.mark.parametrize("mesh", [MESH, MESH_POD], ids=["pod1", "pod2"])
@pytest.mark.parametrize("fsdp,ff2d", [(False, False), (True, False), (True, True)],
                         ids=["plain", "fsdp", "fsdp_ff2d"])
def test_param_specs_match_reference(arch, mesh, fsdp, ff2d):
    _, shapes = _ref_shapes(arch)
    cfg = get_config(arch).with_(objective="ar")
    n_layers, block = _layout(cfg)
    port = R.param_specs(_port_layout(shapes, n_layers, block), mesh, fsdp=fsdp, ff2d=ff2d)
    ref = RR.param_specs(shapes, mesh, fsdp=fsdp, ff2d=ff2d)
    pairs = _paired(port, ref, block)
    assert len(pairs) > 4
    for path, p, r in pairs:
        assert p == r, (arch, path, p, r)


def test_rules_cases_of_the_reference():
    """The reference's named cases, on the port's layout."""
    _, shapes = _ref_shapes("whisper_tiny")
    cfg = get_config("whisper_tiny").with_(objective="ar")
    specs = R.param_specs(_port_layout(shapes, *_layout(cfg)), MESH)
    assert specs["blocks"][0]["attn"]["wq"][-1] == "model"
    assert specs["blocks"][0]["mlp"]["w_up"][-1] == "model"
    assert specs["embed"][0] is None                 # vocab 51865 does not divide
    _, shapes = _ref_shapes("grok_1_314b")
    cfg = get_config("grok_1_314b").with_(objective="ar")
    specs = R.param_specs(_port_layout(shapes, *_layout(cfg)), MESH, fsdp=True)
    up = specs["blocks"][0]["moe"]["w_up"]
    assert up[-1] == "model" and up[-2] == "data"


@pytest.mark.parametrize("arch", ["glm4_9b", "mamba2_2p7b", "jamba_1p5_large",
                                  "h2o_danube_3_4b"])
@pytest.mark.parametrize("seq_shard", [True, False])
def test_cache_specs_match_reference(arch, seq_shard):
    rcfg = ref_get_config(arch).with_(objective="ar")
    ref_shape = jax.eval_shape(lambda: RT.init_cache(rcfg, 128, 32768, jnp.bfloat16))
    cfg = get_config(arch).with_(objective="ar")
    port_shape = T.init_cache(cfg, 128, 32768, torch.bfloat16, device="meta")
    port = R.cache_specs(port_shape, MESH, seq_shard=seq_shard)
    ref = RR.cache_specs(ref_shape, MESH, seq_shard=seq_shard)
    bs = T.block_size(cfg)
    for i, layer in enumerate(port["blocks"]):
        for name, spec in layer.items():
            assert tuple(spec) == tuple(ref["blocks"][f"slot{i % bs}"][name])[1:], \
                (arch, i, name, spec)


def test_batch_specs_match_reference():
    for shape in ((256, 4096), (1, 64), (32,)):
        port = R.batch_specs({"tokens": torch.empty(shape, device="meta")}, MESH_POD)
        ref = RR.batch_specs({"tokens": jax.ShapeDtypeStruct(shape, jnp.int32)}, MESH_POD)
        assert tuple(port["tokens"]) == tuple(ref["tokens"])
    assert R.batch_specs({"t": torch.empty((256, 8), device="meta")},
                         MESH_POD)["t"] == R.P(("pod", "data"), None)


def _plans(name, n):
    ts = get_timesteps(VPSDE(), 8 if name == "pndm" else 6, "quadratic")
    kw = {"eta": 1.0} if name == "ddim_eta" else {}
    return (stack_plans([make_plan(name, VPSDE(), ts, **kw)] * n),
            ref_stack_plans([ref_make_plan(name, RVPSDE(), ts, **kw)] * n),
            make_plan(name, VPSDE(), ts, **kw))


@pytest.mark.parametrize("name", SOLVER_NAMES)
def test_plan_specs_match_reference(name):
    mesh = FakeMesh(data=4)
    for n in (4, 3):          # divisible, and the replicated fallback
        port, ref, _ = _plans(name, n)
        ps, rs = R.plan_specs(port, mesh), RR.plan_specs(ref, mesh)
        assert set(ps.coeffs) == set(rs.coeffs) == set(port.coeffs)
        for k in rs.coeffs:
            assert tuple(ps.coeffs[k]) == tuple(rs.coeffs[k]), (name, n, k)
        assert tuple(ps.ts) == tuple(rs.ts)
        if n == 4:
            assert all(s[0] == "data" for s in ps.coeffs.values())
    unstacked = _plans(name, 1)[2]
    assert R.plan_specs(unstacked, mesh).ts == R.P()


@pytest.mark.parametrize("n", [2, 3])
def test_state_specs_match_reference(n):
    """x on axis 0, hist on axis 1, err and the per-row generators on axis
    0 (the port's key is a tuple of generators: one entry where the
    reference's (R, 2) key stack has two), k replicated."""
    mesh = FakeMesh(data=2)
    ts = get_timesteps(VPSDE(), 6, "quadratic")
    xT = np.random.RandomState(0).randn(n, 4).astype(np.float32)
    port = init_state(stack_plans([make_plan("em", VPSDE(), ts)] * n), torch.from_numpy(xT),
                      [torch.Generator().manual_seed(i) for i in range(n)])
    ref = ref_init_state(ref_stack_plans([ref_make_plan("em", RVPSDE(), ts)] * n),
                         jnp.asarray(xT), jnp.stack([jax.random.PRNGKey(i) for i in range(n)]))
    ps, rs = R.state_specs(port, mesh), RR.state_specs(ref, mesh)
    for f in ("x", "hist", "err", "k"):
        assert tuple(getattr(ps, f)) == tuple(getattr(rs, f)), f
    assert tuple(ps.key) == tuple(rs.key)[:1]
    solo = init_state(make_plan("em", VPSDE(), ts), torch.from_numpy(xT[0]),
                      torch.Generator().manual_seed(0))
    s1 = R.state_specs(solo, mesh)
    assert s1.x == R.P() and s1.key == R.P()


def test_step_index_specs_match_reference():
    mesh = FakeMesh(data=4)
    for k_port, k_ref in ((list(range(8)), jnp.arange(8)), (list(range(6)), jnp.arange(6)),
                          (3, jnp.int32(3))):
        assert tuple(R.step_index_specs(k_port, mesh)) == \
            tuple(RR.step_index_specs(k_ref, mesh))
    assert R.step_index_specs(torch.zeros(8, dtype=torch.long), mesh) == R.P("data")


class _Mesh:
    """Duck-typed DeviceMesh: names, sizes, the rank layout, a coordinate."""

    def __init__(self, names, ranks, coords=None):
        self.mesh = torch.as_tensor(ranks)
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(self.mesh.shape)
        self._coords = coords or {n: 0 for n in names}

    def get_local_rank(self, name):
        return self._coords[name]


def test_mesh_fingerprint_distinguishes_layouts():
    a = _Mesh(("data",), [0, 1, 2, 3])
    assert M.mesh_fingerprint(a) == M.mesh_fingerprint(_Mesh(("data",), [0, 1, 2, 3]))
    assert M.mesh_fingerprint(a) == ((("data", 4),), (0, 1, 2, 3))
    others = [_Mesh(("data",), [3, 2, 1, 0]), _Mesh(("data", "model"), [[0, 1], [2, 3]]),
              _Mesh(("data", "model"), [[0], [1], [2], [3]]), _Mesh(("data",), [0, 1])]
    prints = {M.mesh_fingerprint(m) for m in [a] + others}
    assert len(prints) == 5


def test_meshes_need_a_process_group():
    assert not torch.distributed.is_initialized()
    for build in (M.make_request_mesh, M.make_host_mesh, M.make_production_mesh):
        with pytest.raises(RuntimeError, match="init_process_group"):
            build()
    assert not torch.distributed.is_initialized()      # and none was started


def test_named_sharding_local_blocks_and_placements():
    from torch.distributed.tensor import Replicate, Shard
    t = torch.arange(24).reshape(6, 4)
    for c in range(3):
        mesh = _Mesh(("data", "model"), [[0, 1], [2, 3], [4, 5]], {"data": c, "model": 1})
        assert torch.equal(R.NamedSharding(mesh, R.P("data", None)).local(t), t[2 * c:2 * c + 2])
        assert torch.equal(R.NamedSharding(mesh, R.P(None, "model")).local(t), t[:, 2:])
        assert torch.equal(R.NamedSharding(mesh, R.P()).local(t), t)
    assert R.block_range(5, 4, 3) == (3, 5) and R.block_range(8, 4, 1) == (2, 4)
    mesh = _Mesh(("data", "model"), [[0, 1], [2, 3]])
    assert R.to_placements(R.P("data", None), mesh) == [Shard(0), Replicate()]
    assert R.to_placements(R.P(None, ("data", "model")), mesh) == [Shard(1), Shard(1)]
    assert R.to_placements(R.P(), mesh) == [Replicate(), Replicate()]
    sh = R.to_shardings({"a": R.P("data"), "b": [R.P()]}, mesh)
    assert sh["a"] == R.NamedSharding(mesh, R.P("data")) and sh["b"][0].spec == R.P()


def test_opt_state_specs_follow_params():
    from repro_torch.training.optimizer import OptState
    pspec = {"w": R.P(None, "model")}
    out = R.opt_state_specs(None, pspec, MESH)
    assert isinstance(out, OptState)
    assert out.step == R.P() and out.m == pspec and out.v == pspec
    ref = RR.opt_state_specs(None, {"w": RP(None, "model")}, MESH)
    assert tuple(ref.step) == tuple(out.step)
