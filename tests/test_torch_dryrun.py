"""The port's dry runs (``repro_torch.launch.dryrun`` and ``.hillclimb``)
against the reference's ``repro.launch.dryrun``, on the CPU over ``fake``
process groups (no collective moves data; fake tensors hold no storage).

* ``model_flops`` and ``param_count`` equal the reference's for every arch
  and shape, and so does the skip/ok table and a record's keys;
* the collective accounting of real c10d calls on a fake 16-rank group
  gives the reference's parser numbers for the same shapes and dtypes;
* counted FLOPs at one rank equal ``model_flops`` plus the attention's two
  products (less the norms' parameters, which ``model_flops`` counts as
  if they were weights of a product), and on a (2, 2) mesh per-device
  FLOPs x 4 equal the one-rank count, exactly;
* ``make_deis_sample_step`` against the reference's on reduced gemma;
* the CLIs on the 256-rank production mesh (gemma-2b, one DEIS NFE) and
  the multi-pod 512-rank one.

The 4-rank gloo run of ``tests/test_torch_sharded_train.py`` holds fake
counts against a real step's and the two ``deis_shard`` layouts against
each other.
"""
import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

_FLAGS = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as RD   # noqa: E402  (both set XLA_FLAGS for later processes)
import repro.launch.hillclimb as RH  # noqa: E402
if _FLAGS is None:                 # keep this process's environment as it was
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS
from repro.configs.base import INPUT_SHAPES as REF_SHAPES, get_config as ref_get_config  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.training import steps as RS  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, ShapeConfig, get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import hillclimb as H  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training import steps as PS  # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)    # the eps-net's float32 tolerance (test_torch_model.py)


@contextlib.contextmanager
def fake_world(n):
    """This process as rank 0 of a fake ``n``-rank default group."""
    D.init_fake_world(n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _counts(world, model, cfg, shape, **kw):
    with fake_world(world):
        mesh = make_host_mesh(model=model)
        with FakeTensorMode():
            fn, args, _ = D.make_workload(cfg, shape, mesh, device="cpu", **kw)
            return D.count_costs(fn, args, mesh)


def test_input_shapes_are_the_reference_s():
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in INPUT_SHAPES.items()} \
        == {k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in REF_SHAPES.items()}
    assert D.ALL_ARCHS == RD.ALL_ARCHS and D.LONG_OK == RD.LONG_OK
    assert D.FSDP_PARAM_THRESHOLD == RD.FSDP_PARAM_THRESHOLD


@pytest.mark.parametrize("arch", RD.ALL_ARCHS)
def test_model_flops_and_param_count_equal_reference(arch):
    rcfg = ref_get_config(arch)
    shapes = jax.eval_shape(lambda k: RT.init_params(rcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert D.param_count(D.param_shapes(get_config(arch))) == RD.param_count(shapes)
    for shape, spec in REF_SHAPES.items():      # each with its dry run's objective
        objective = "diffusion" if spec.kind in ("train", "deis") else "ar"
        want = RD.model_flops(rcfg.with_(objective=objective), shape)
        got = D.model_flops(get_config(arch).with_(objective=objective), shape)
        assert got == want, (arch, objective, shape, got, want)


class _Reached(Exception):
    """Raised where a dry run would start tracing."""


def _status_table(module, mesh, monkeypatch, **kw):
    def reached(*a, **k):
        raise _Reached
    monkeypatch.setattr(module, "make_workload", reached)
    table = {}
    for arch in module.ALL_ARCHS:
        for shape in REF_SHAPES:
            try:
                r = module.dryrun_one(arch, shape, multi_pod=False, mesh=mesh, fsdp=False,
                                      verbose=False, **kw)
                table[arch, shape] = (r["status"], r["reason"])
            except _Reached:
                table[arch, shape] = ("ok", None)
    return table


def test_status_table_equals_reference(monkeypatch):
    class StandIn:        # the reference reads the mesh's size before tracing
        shape = {"data": 16, "model": 16}
    want = _status_table(RD, StandIn(), monkeypatch)
    got = _status_table(D, StandIn(), monkeypatch, device="cpu")
    assert got == want
    assert sum(s == "skipped" for s, _ in got.values()) == 7


TINY = dict(n_layers=1, d_model=64, d_ff=128, vocab_size=256, n_heads=2, n_kv_heads=1,
            head_dim=32)


def test_record_keys_equal_reference():
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    want = RD.dryrun_one("gemma_2b", "deis_4k", multi_pod=False, mesh=mesh, fsdp=False,
                         unroll=False, overrides=TINY, verbose=False)
    with fake_world(4):
        got = D.dryrun_one("gemma_2b", ShapeConfig("deis_4k", 32, 4, "deis"),
                           mesh=make_host_mesh(model=2), overrides=TINY, verbose=False,
                           device="cpu")
    assert set(got) == set(want)
    for key in ("collectives", "memory", "roofline"):
        assert set(want[key]) <= set(got[key]), key
    assert got["status"] == "ok" and got["mesh"] == "2x2" and got["devices"] == 4
    assert got["cost_extrapolated"] is False and got["flops_per_device"] > 0
    assert set(got["collectives"]["by_axis"]) <= {"data", "model", "data+model"}
    assert got["collectives"]["counts"]["all-gather"] > 0


def test_collective_accounting_matches_the_reference_parser():
    """The reference's ``test_collective_parser_on_synthetic_hlo`` shapes, as
    real c10d calls on a fake 16-rank group; an async op and its wait
    count once."""
    with fake_world(16), FakeTensorMode():
        g2, g4 = dist.new_group([0, 1]), dist.new_group([0, 1, 2, 3])
        counter = D.CostCounter()
        with counter:
            dist.all_reduce(torch.ones(1024, 512))
            parts = [torch.empty(1024, dtype=torch.bfloat16) for _ in range(2)]
            dist.all_gather(parts, torch.ones(1024, dtype=torch.bfloat16), group=g2)
            out = torch.empty(256)
            dist.reduce_scatter_tensor(out, torch.ones(1024), group=g4)
            a2a = torch.empty(64, 64)
            dist.all_to_all_single(a2a, torch.ones(64, 64))
            dist.send(torch.ones(8, dtype=torch.int32), dst=1)
            dist.all_gather(parts, torch.ones(1024, dtype=torch.bfloat16), group=g2,
                            async_op=True).wait()
    assert counter.coll["all-reduce"] == 2 * 1024 * 512 * 4          # 2x ring
    assert counter.coll["all-gather"] == 2 * (2048 * 2)
    assert counter.coll["reduce-scatter"] == 256 * 4
    assert counter.coll["all-to-all"] == 64 * 64 * 4
    assert counter.coll["collective-permute"] == 8 * 4
    assert counter.counts == {"all-reduce": 1, "all-gather": 2, "reduce-scatter": 1,
                              "all-to-all": 1, "collective-permute": 1}


def test_flops_at_one_rank_equal_model_flops_plus_attention():
    """1-layer gemma, ar prefill, B 4, S 16: the counted FLOPs are
    ``model_flops`` (2 N D over every parameter, the tied embedding as the
    LM head), less 2 D for each norm parameter (a scale, no product), plus
    the attention's score and value products (2 B H S^2 hd each)."""
    cfg = get_config("gemma_2b").reduced().with_(objective="ar", n_layers=1)
    shape = ShapeConfig("p", 16, 4, "prefill")
    got = _counts(1, 1, cfg, shape)["flops"]
    tokens = shape.global_batch * shape.seq_len
    norms = 3 * cfg.d_model                     # norm1, norm2, final_norm
    attn = 2 * (2 * 4 * cfg.n_heads * 16 * 16 * cfg.resolved_head_dim)
    assert got == D.model_flops(cfg, shape) - 2 * tokens * norms + attn


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_flops_over_a_2x2_mesh_sum_to_one_rank(kind):
    """Reduced granite (4 heads, 4 kv heads: both divide 'model' 2), ar:
    per-device FLOPs x 4 on a fake (2, 2) mesh equal the one-rank count."""
    cfg = get_config("granite_3_8b").reduced().with_(objective="ar")
    assert cfg.n_heads % 2 == 0 and cfg.n_kv_heads % 2 == 0
    shape = ShapeConfig(kind, 16, 4, kind)
    one = _counts(1, 1, cfg, shape)
    four = _counts(4, 2, cfg, shape)
    assert four["flops"] * 4 == one["flops"] > 0
    assert sum(four["collectives"]["counts"].values()) > 0


def test_deis_sample_step_matches_reference():
    rcfg = ref_get_config("gemma_2b").reduced()
    pcfg = get_config("gemma_2b").reduced()
    rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, rp), pcfg, "cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, pcfg.d_model)).astype(np.float32)
    hist = rng.standard_normal((4, 2, 12, pcfg.d_model)).astype(np.float32)
    scal = [np.float32(0.5), np.float32(0.9), np.array([0.4, 0.3, 0.2, 0.1], np.float32)]
    want_x, want_h = RS.make_deis_sample_step(rcfg)(rp, *map(jnp.asarray, [x, hist] + scal))
    got_x, got_h = PS.make_deis_sample_step(pcfg)(
        params, *(torch.from_numpy(np.asarray(a)) for a in [x, hist] + scal))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **F32)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **F32)
    np.testing.assert_array_equal(got_h[1:].numpy(), hist[:-1])


def test_dryrun_cli_on_the_production_meshes(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    D.main(["--device", "cpu", "--arch", "gemma_2b", "--shape", "deis_4k",
            "--out", str(out)])
    D.main(["--device", "cpu", "--arch", "whisper_tiny", "--shape", "train_4k",
            "--multi-pod", "--out", str(out)])
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["arch"], r["mesh"], r["devices"], r["status"]) for r in recs] == \
        [("gemma_2b", "16x16", 256, "ok"), ("whisper_tiny", "pod2x16x16", 512, "ok")]
    for r in recs:
        assert r["flops_per_device"] > 0 and r["collectives"]["total"] > 0
        assert r["bottleneck"] in r["roofline"]
        # ranks in mesh order: every axis of 16 crosses a node, so the NIC
        assert r["roofline"]["collective_s"] == pytest.approx(
            r["collectives"]["total"] / D.NIC_BW, rel=1e-12)
    assert set(recs[1]["collectives"]["by_axis"]) >= {"model", "data"}
    assert not dist.is_initialized()


def test_link_model():
    assert D.link_bw([[0]]) == float("inf")
    assert D.link_bw([list(range(8))]) == D.NVLINK_BW
    assert D.link_bw([list(range(16))]) == D.NIC_BW
    assert D.link_bw([[0, 16, 32]]) == D.NIC_BW


def test_hillclimb_pairs_keep_the_reference_s_variants_and_levers():
    assert set(H.PAIRS) == set(RH.PAIRS)
    for name, spec in RH.PAIRS.items():
        mine = H.PAIRS[name]
        assert (mine["arch"], mine["shape"]) == (spec["arch"], spec["shape"])
        assert [(v[0], v[2]) for v in mine["variants"]] == \
            [(v[0], v[2]) for v in spec["variants"]]
        assert not any("GSPMD" in v[1] for v in mine["variants"])
