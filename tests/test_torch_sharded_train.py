"""Model-parallel training of the port on the CPU: gloo ranks on
``make_host_mesh`` meshes ((2, 2) on 4 ranks; (1, 2) and (2, 1) on 2),
the counterpart of the reference's ``launch.train --model-parallel``.

Each case trains 2 steps from the reference's weights (``params_from_numpy``)
on the Markov corpus (batch 4, seq 16), the diffusion objective on the
reference's own ``t`` / ``eps`` draws (whole-batch draws; every rank keeps
its rows). The sharded run is held to the port's UNSHARDED step and to the
reference's unsharded step (its sharded path is the one that fails on the
installed jax for serving; its unsharded step is what the sharded one
claims to equal): the losses and grad norms at rtol 1e-5, the params after
2 steps at atol ``PARAM_ATOL`` (the largest difference is reported). An
AdamW step moves a weight by about lr x g / |g| whatever |g|, so where a
grad is small beside the summation noise of another order (another
framework, or the sums over ranks) the two runs move it apart by up to lr
a step: at lr 3e-4 the largest difference is about a third of the bound.

Cases: the six arch types' reduced float32 configs (gemma-2b both
objectives and both ``ce_mode``s), on every mesh; on (2, 2) the levers
``fsdp`` (at every layer's start the weights gathered for earlier layers
are gone: the port's ZeRO-3), ``ff2d``, the reference's ZeRO-3
``block_constraint`` (accepted, and any other refused), ``act_shard_axes``
(and its refusal of a batch it cannot pin) and ``remat="block"``, on
gemma and mixtral. Per rank, every leaf of the params, grads and both
AdamW moments holds its shard only: its local bytes are the whole leaf's
over the size of the mesh axes its spec names. The launcher's init places
each layer as it is made: no rank holds two pieces of the model whole.

Checkpoints cross: a (2, 2) launcher run's checkpoint resumes in the
unsharded port launcher and restores through the reference's
``CKPT.restore``; the unsharded launcher's checkpoint resumes in the
(2, 2) launcher; the reference's own checkpoint restores into the sharded
tree, each shard exactly its block.

The parent process runs the reference and the port's unsharded steps while
the ranks (spawned once per world size, no JAX in them) run theirs; the
ranks write their results, checked here one case each. On (2, 2) the
ranks also run one DEIS NFE with its state split over 'model' on d_model
and on the sequence (the dry runs' ``deis_shard``), and count one reduced
train step through the dry run's workload, held against the same step on
a fake (2, 2) group.
"""
import concurrent.futures as futures
import contextlib
import io
import json
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.core import VPSDE as RVPSDE
from repro.data.pipeline import MarkovTextSource as RefSource, make_batch as ref_make_batch
from repro.models import transformer as RT
from repro.training import checkpoint as RC
from repro.training import optimizer as RO
from repro.training import steps as RS
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun as DRY
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import main as train_main
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.training import optimizer as PO
from repro_torch.training import steps as PS
from repro_torch.training.checkpoint import _flatten
from test_torch_sharded_serving import spawn

LR = 3e-4                            # the launcher's default
B, S, STEPS = 4, 16, 2
STAT = dict(rtol=1e-5, atol=1e-7)   # losses and grad norms
PARAM_ATOL = 1e-4                    # params after 2 AdamW steps (below)
PRINT_TOL = {"loss": 1.5e-4, "gnorm": 1.5e-3}   # one unit of the printed digit
COUNT_SHAPE = ShapeConfig("train", S, B, "train")   # the counted step (dry-run accounting)
SPAWN_TIMEOUT_S = 600   # a hang guard: the ranks take ~40 s alone, 4x that on a busy host
# name -> (arch, objective, config overrides)
CASES = {
    "gemma_diffusion": ("gemma_2b", "diffusion", {}),
    "gemma_ar": ("gemma_2b", "ar", {}),
    "gemma_ar_onehot": ("gemma_2b", "ar", {"ce_mode": "onehot"}),
    "mamba2_diffusion": ("mamba2_2p7b", "diffusion", {}),
    "mixtral_ar": ("mixtral_8x7b", "ar", {}),
    "jamba_diffusion": ("jamba_1p5_large", "diffusion", {}),
    "whisper_ar": ("whisper_tiny", "ar", {}),
    "paligemma_diffusion": ("paligemma_3b", "diffusion", {}),
}
# on (2, 2): name -> (base case, placement and step options)
VARIANTS = {
    f"{base}_{lever}": (base, opts) for base in ("gemma_diffusion", "mixtral_ar")
    for lever, opts in (("fsdp", {"fsdp": True}),
                        ("ff2d", {"fsdp": True, "ff2d": True}),
                        ("zero3", {"fsdp": True, "zero3": True}),
                        ("act_shard", {"act_shard_axes": ("data",)}),
                        ("remat", {"remat": "block", "fsdp": True}))}
MESHES = {4: [(2, 2)], 2: [(1, 2), (2, 1)]}
LAUNCH = ["--arch", "gemma_2b", "--device", "cpu", "--reduced", "--batch", "4",
          "--seq", "16"]

_CHILD = r'''
import contextlib, faulthandler, io, json, os, sys, traceback, weakref
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
inputs, launch = sys.argv[5], sys.argv[6]
torch.set_num_threads(1)
faulthandler.dump_traceback_later(float(sys.argv[7]), exit=True)   # a hang shows where
from repro_torch.configs import get_config
from repro_torch.data.pipeline import device_put_sharded
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import train as TRAIN
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_to_numpy, tree_leaves, tree_map
from repro_torch.sharding import rules as R
from repro_torch.sharding import tensor_parallel as TP
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import optimizer as PO
from repro_torch.training import steps as PS
from repro_torch.training.checkpoint import _flatten

IN = torch.load(inputs, weights_only=False)
results, lines = {}, {}


def check(name, fn):
    try:
        fn()
        results[name] = "ok"
    except Exception:
        results[name] = traceback.format_exc()


def launcher(name, argv, store_name):
    """The train launcher under a launcher's environment (its own group)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            TRAIN.main(argv + ["--dist-init-method", "file://" + os.path.join(out, store_name)])
    finally:
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            os.environ.pop(k)
    lines[name] = buf.getvalue()


if world == 4:
    argv = json.loads(launch)
    check("launch_fresh", lambda: launcher(
        "fresh", argv["common"] + ["--steps", "2", "--model-parallel", "2",
                                   "--ckpt-dir", argv["sharded_dir"]], "st_fresh"))
    check("launch_resume_unsharded", lambda: launcher(
        "resume", argv["common"] + ["--steps", "3", "--model-parallel", "2",
                                    "--ckpt-dir", argv["unsharded_copy"]], "st_resume"))

dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)


def cfg_of(case, extra=None):
    arch, objective, over = IN["cases"][case]["spec"]
    return get_config(arch).reduced().with_(objective=objective, **over, **(extra or {}))


def full_numpy(tree):
    whole = tree_map(lambda t: t.full_tensor() if TP.is_sharded(t) else t, tree)
    return dict(_flatten(params_to_numpy(whole)))


def train(case, mesh, opts, name):
    c = IN["cases"][case]
    cfg = cfg_of(case, {"act_shard_axes": opts["act_shard_axes"]}
                 if "act_shard_axes" in opts else None)
    specs = R.param_specs(c["params"], mesh, fsdp=opts.get("fsdp", False),
                          ff2d=opts.get("ff2d", False))
    params = R.device_put(c["params"], R.to_shardings(specs, mesh))
    opt = PO.AdamW(PO.constant_schedule(IN["lr"]))
    state = opt.init(params)
    # the reference's ZeRO-3 constraint: one layer's model-only specs
    bc = R.param_specs(c["params"]["blocks"][0], mesh, path=("blocks", 0)) \
        if opts.get("zero3") else None
    step = PS.make_train_step(cfg, opt, remat=opts.get("remat", False), block_constraint=bc)
    losses, gnorms = [], []
    for i in range(len(c["batches"])):
        host = c["batches"][i]
        batch = device_put_sharded(host, R.to_shardings(R.batch_specs(host, mesh), mesh), "cpu")
        params, state, m = step(params, state, batch, **c["draws"][i])
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    got = full_numpy(params)
    if rank == 0:
        torch.save({"losses": losses, "gnorms": gnorms, "params": got},
                   os.path.join(out, f"{name}.pt"))
    return params, state, specs


def spec_leaves(tree):
    if isinstance(tree, R.PartitionSpec):
        return [tree]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in spec_leaves(v)]
    return [s for v in tree for s in spec_leaves(v)]


def layer_starts():
    """Record the gathered weights alive at each layer's start."""
    seen, apply = [], T._apply_layer

    def wrapped(*a, **k):
        seen.append(len(TP._GATHERED))
        return apply(*a, **k)
    return seen, wrapped


for shape in IN["meshes"][str(world)]:
    mesh = make_host_mesh(model=shape[1])
    tag = "x".join(map(str, shape))
    for case in IN["cases"]:
        check(f"{tag}/{case}", lambda: train(case, mesh, {}, f"{tag}_{case}"))
    if shape != (2, 2):
        continue
    for name, (base, opts) in IN["variants"].items():
        def run(name=name, base=base, opts=opts):
            seen, wrapped = layer_starts()
            apply, T._apply_layer = T._apply_layer, wrapped
            try:
                train(base, mesh, opts, f"{tag}_{name}")
            finally:
                T._apply_layer = apply
            if opts.get("fsdp") and "remat" not in opts:
                # the weights gathered for a layer are gone by the next one's start
                assert len(set(seen)) == 1 and seen[0] <= 1, seen
        check(f"{tag}/{name}", run)

    def shard_bytes(opts):
        """Every leaf's local bytes: the whole leaf's over its spec's axes."""
        c = IN["cases"]["gemma_diffusion"]
        params, state, specs = train("gemma_diffusion", mesh, opts, "bytes_scratch")
        loss_fn = PS.make_loss_fn(cfg_of("gemma_diffusion"))
        host = c["batches"][0]
        batch = device_put_sharded(host, R.to_shardings(R.batch_specs(host, mesh), mesh), "cpu")
        with TP.regather_saved():
            _, grads = PO.value_and_grad(loss_fn, params, batch, has_aux=True, **c["draws"][0])
        sizes = R.axis_sizes(mesh)
        for tree in (params, grads, state.m, state.v):
            for leaf, spec in zip(tree_leaves(tree), spec_leaves(specs)):
                axes = [a for e in spec if e is not None
                        for a in (e if isinstance(e, tuple) else (e,))]
                n = int(np.prod([sizes[a] for a in axes])) if axes else 1
                local = leaf.to_local()
                assert local.numel() * n == leaf.numel(), (spec, leaf.shape, local.shape)
                assert leaf.placements == tuple(R.to_placements(spec, mesh)), spec
        assert TP.is_sharded(state.step)

    check(f"{tag}/shard_bytes", lambda: shard_bytes({}))
    check(f"{tag}/shard_bytes_fsdp", lambda: shard_bytes({"fsdp": True}))
    check(f"{tag}/shard_bytes_ff2d", lambda: shard_bytes({"fsdp": True, "ff2d": True}))

    def pin_refused():
        c = IN["cases"]["mixtral_ar"]
        params = R.device_put(c["params"], R.to_shardings(R.param_specs(c["params"], mesh), mesh))
        host = {k: v[:3] for k, v in c["batches"][0].items()}     # 3 rows: not split over data
        batch = device_put_sharded(host, R.to_shardings(R.batch_specs(host, mesh), mesh), "cpu")
        for axes in (("data",), ("model",)):
            loss_fn = PS.make_loss_fn(cfg_of("mixtral_ar", {"act_shard_axes": axes}))
            try:
                loss_fn(params, batch)
            except ValueError as e:
                assert "act_shard_axes" in str(e)
            else:
                raise AssertionError(f"act_shard_axes {axes} took a batch it cannot pin")
    check(f"{tag}/pin_refused", pin_refused)

    def constraint_refused():
        """The ZeRO-3 constraint is taken; one naming another layout raises."""
        c = IN["cases"]["gemma_diffusion"]
        specs = R.param_specs(c["params"], mesh, fsdp=True)
        blocks = R.device_put(c["params"], R.to_shardings(specs, mesh))["blocks"]
        layer = c["params"]["blocks"][0]
        TP.check_block_constraint(blocks, R.param_specs(layer, mesh))
        for con in (R.param_specs(layer, mesh, fsdp=True), tree_map(lambda t: R.P(), layer)):
            try:
                TP.check_block_constraint(blocks, con)
            except NotImplementedError as e:
                assert "block_constraint" in str(e)
            else:
                raise AssertionError(f"block_constraint {con} was taken")
    check(f"{tag}/constraint_refused", constraint_refused)

    def init_on_mesh():
        """The launcher's init holds one piece of the model whole at a time
        (a layer or a top-level entry, the largest under half the model)
        and places the same values as init-then-``device_put``."""
        cfg = cfg_of("gemma_diffusion")
        put, alive, pieces = R.device_put, [], []

        def spy(tree, shardings):
            assert all(r() is None for r in alive), "an earlier piece is still whole"
            leaves = tree_leaves(tree)
            alive[:] = [weakref.ref(t) for t in leaves]
            pieces.append(sum(t.numel() * t.element_size() for t in leaves))
            return put(tree, shardings)
        R.device_put = spy
        try:
            got = TRAIN.init_on_mesh(cfg, 0, torch.device("cpu"), mesh)
        finally:
            R.device_put = put
        assert all(r() is None for r in alive)
        whole = T.init_params(cfg, 0, "cpu")
        total = sum(t.numel() * t.element_size() for t in tree_leaves(whole))
        assert sum(pieces) == total and max(pieces) < total / 2, (pieces, total)
        want = R.device_put(whole, R.to_shardings(R.param_specs(whole, mesh), mesh))
        for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
            assert a.placements == b.placements and torch.equal(a.to_local(), b.to_local())
    check(f"{tag}/init_on_mesh", init_on_mesh)

    def restore_reference_checkpoint():
        c = IN["cases"]["gemma_diffusion"]
        params = R.device_put(c["params"], R.to_shardings(R.param_specs(c["params"], mesh), mesh))
        opt = PO.AdamW(PO.constant_schedule(IN["lr"]))
        (got, state), meta = CKPT.restore(IN["ref_ckpt"], (params, opt.init(params)))
        want = IN["ref_ckpt_arrays"]
        restored = full_numpy((got, state))
        assert set(restored) == set(want), set(restored) ^ set(want)
        for path, arr in want.items():
            np.testing.assert_array_equal(restored[path], arr, err_msg=path)
        for leaf in tree_leaves((got, state)):
            assert TP.is_sharded(leaf)
    check(f"{tag}/restore_reference_checkpoint", restore_reference_checkpoint)

    def deis_layouts():
        """One DEIS NFE with x and its history split over 'model' on d_model
        and on the sequence: the same x_next and history, bitwise, within
        the float32 tolerance of the unsharded step."""
        c, d = IN["cases"]["gemma_diffusion"], IN["deis"]
        params = R.device_put(c["params"], R.to_shardings(R.param_specs(c["params"], mesh), mesh))
        step = PS.make_deis_sample_step(cfg_of("gemma_diffusion"))
        ba = R.batch_axes(mesh)
        got = {}
        for name, (xs, hs) in {"dmodel": (R.P(ba, None, "model"), R.P(None, ba, None, "model")),
                               "seq": (R.P(ba, "model", None), R.P(None, ba, "model", None))}.items():
            x = R.device_put(d["x"], R.NamedSharding(mesh, xs))
            hist = R.device_put(d["hist"], R.NamedSharding(mesh, hs))
            xn, hn = step(params, x, hist, *d["scalars"])
            assert xn.placements == x.placements and hn.placements == hist.placements
            got[name] = (xn.full_tensor(), hn.full_tensor())
        for a, b in zip(got["seq"], got["dmodel"]):
            assert torch.equal(a, b)
        for a, b in zip(got["dmodel"], d["want"]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    check(f"{tag}/deis_layouts", deis_layouts)

    def prefill_decode(case):
        """Prefill, then one decode step against the prefill's cache, on the
        mesh (params, batch and cache as DTensors) against the same steps
        unsharded: logits and every cache leaf within float32 tolerance."""
        c = IN["cases"][case]
        cfg = cfg_of(case).with_(objective="ar")
        host = c["batches"][0]
        whole = {k: torch.from_numpy(np.asarray(v)) for k, v in host.items()}
        params = R.device_put(c["params"], R.to_shardings(R.param_specs(c["params"], mesh), mesh))
        batch = device_put_sharded(host, R.to_shardings(R.batch_specs(host, mesh), mesh), "cpu")
        token = whole["tokens"][:, -1:]
        token_dt = R.device_put(token, R.NamedSharding(mesh, R.batch_specs({"t": token}, mesh)["t"]))
        index = whole["tokens"].shape[1] - 1 + (cfg.prefix_tokens if "prefix" in whole else 0)
        prefill, decode = PS.make_prefill_step(cfg), PS.make_decode_step(cfg)
        with torch.no_grad():
            want = [prefill(c["params"], whole)]
            got = [prefill(params, batch)]
            want.append(decode(c["params"], want[0][1], token, index))
            got.append(decode(params, got[0][1], token_dt, index))
        full = lambda tree: tree_map(lambda t: t.full_tensor() if TP.is_sharded(t) else t, tree)
        for (g_lg, g_cache), (w_lg, w_cache) in zip(got, want):
            torch.testing.assert_close(g_lg.full_tensor(), w_lg, rtol=1e-5, atol=1e-5)
            g, w = tree_leaves(full(g_cache)), tree_leaves(w_cache)
            assert len(g) == len(w)
            for a, b in zip(g, w):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for case in IN["cases"]:
        check(f"{tag}/prefill_decode_{case}", lambda case=case: prefill_decode(case))

    def fake_equals_real():
        """Rank 0's counts of one reduced train step through the dry run's
        workload, for the parent to hold against a fake (2, 2) run's."""
        fn, args, _ = DRY.make_workload(cfg_of("gemma_diffusion"), IN["count_shape"], mesh,
                                        device="cpu")
        got = DRY.count_costs(fn, args, mesh)
        if rank == 0:
            torch.save({k: got[k] for k in ("flops", "bytes", "collectives")},
                       os.path.join(out, "counts.pt"))
    check(f"{tag}/fake_equals_real", fake_equals_real)

gathered = [None] * world
dist.all_gather_object(gathered, results)
if rank == 0:
    merged = {k: next((g[k] for g in gathered if g[k] != "ok"), "ok") for k in results}
    torch.save({"results": merged, "lines": lines}, os.path.join(out, "results.pt"))
dist.barrier()
dist.destroy_process_group()
'''


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_draws(rcfg, batch, key):
    """The t and eps the reference's diffusion_loss draws from ``key``."""
    k_t, k_eps = jax.random.split(key)
    sde = RVPSDE()
    t = jax.random.uniform(k_t, (batch["tokens"].shape[0],), jnp.float32, sde.t0, sde.T)
    eps = jax.random.normal(k_eps, batch["tokens"].shape + (rcfg.d_model,), jnp.float32)
    return {"t": torch.from_numpy(np.array(t)), "eps": torch.from_numpy(np.array(eps))}


def _setup(case):
    arch, objective, over = CASES[case]
    rcfg = ref_get_config(arch).reduced().with_(objective=objective, **over)
    pcfg = get_config(arch).reduced().with_(objective=objective, **over)
    rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
    src = RefSource(rcfg.vocab_size, 0)
    batches = [ref_make_batch(rcfg, src, i, B, S) for i in range(STEPS)]
    keys = [jax.random.PRNGKey(100 + i) for i in range(STEPS)]
    draws = [_ref_draws(rcfg, b, k) if objective == "diffusion" else {}
             for b, k in zip(batches, keys)]
    return rcfg, pcfg, rp, batches, keys, draws


def _reference(rcfg, rp, batches, keys):
    opt = RO.AdamW(RO.constant_schedule(LR))
    state = opt.init(rp)
    step = jax.jit(RS.make_train_step(rcfg, opt))
    losses, gnorms = [], []
    for b, k in zip(batches, keys):
        rp, state, m = step(rp, state, jax.tree.map(jnp.asarray, b), k)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return {"losses": losses, "gnorms": gnorms, "params": dict(_flatten(_np(rp)))}, \
        (rp, state)


def _port_unsharded(pcfg, params, batches, draws):
    opt = PO.AdamW(PO.constant_schedule(LR))
    state = opt.init(params)
    step = PS.make_train_step(pcfg, opt)
    losses, gnorms = [], []
    for b, d in zip(batches, draws):
        params, state, m = step(params, state, {k: torch.from_numpy(np.array(v))
                                                for k, v in b.items()}, **d)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return {"losses": losses, "gnorms": gnorms,
            "params": dict(_flatten(params_to_numpy(params)))}


def _launch(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_main(argv)
    return buf.getvalue()


def _step_lines(text: str) -> dict:
    return {int(m[1]): {"loss": float(m[2]), "gnorm": float(m[3])}
            for m in re.finditer(r"^step +(\d+) loss=(\S+) gnorm=(\S+)", text, re.M)}


def _deis_inputs(params, pcfg):
    """x, history and scalars of one DEIS NFE (seeded numpy), and the port's
    unsharded step's x_next and history on them."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((B, S, pcfg.d_model)).astype(np.float32))
    hist = torch.from_numpy(rng.standard_normal((4, B, S, pcfg.d_model)).astype(np.float32))
    scalars = (torch.tensor(0.5), torch.tensor(0.9), torch.tensor([0.4, 0.3, 0.2, 0.1]))
    want = PS.make_deis_sample_step(pcfg)(params, x, hist, *scalars)
    return {"x": x, "hist": hist, "scalars": scalars, "want": want}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn both worlds, compute the unsharded expectations meanwhile, and
    return them with the ranks' results."""
    tmp = tmp_path_factory.mktemp("sharded_train")
    setups = {case: _setup(case) for case in CASES}
    inputs = {"lr": LR, "meshes": {str(w): m for w, m in MESHES.items()},
              "variants": VARIANTS, "cases": {}}
    for case, (rcfg, pcfg, rp, batches, keys, draws) in setups.items():
        inputs["cases"][case] = {"spec": CASES[case],
                                 "params": params_from_numpy(_np(rp), pcfg, "cpu"),
                                 "batches": batches, "draws": draws}
    inputs["deis"] = _deis_inputs(inputs["cases"]["gemma_diffusion"]["params"],
                                  setups["gemma_diffusion"][1])
    inputs["count_shape"] = COUNT_SHAPE
    # the unsharded launcher's run (resumed by the (2, 2) launcher) and the
    # reference's checkpoint of the reference's 2 steps (restored by the ranks)
    unsharded = tmp / "unsharded"
    lines = {"fresh": _launch(LAUNCH + ["--steps", "2", "--ckpt-dir", str(unsharded)])}
    shutil.copytree(unsharded, tmp / "unsharded_copy")
    rcfg, _, rp, batches, keys, _ = setups["gemma_diffusion"]
    expect = {"gemma_diffusion": _reference(rcfg, rp, batches, keys)}
    RC.save(str(tmp / "ref_ckpt"), STEPS, expect["gemma_diffusion"][1], {"arch": "gemma-2b"})
    inputs["ref_ckpt"] = str(tmp / "ref_ckpt")
    inputs["ref_ckpt_arrays"] = dict(_flatten(_np(expect["gemma_diffusion"][1])))
    torch.save(inputs, tmp / "inputs.pt")
    launch = {"common": LAUNCH, "sharded_dir": str(tmp / "sharded"),
              "unsharded_copy": str(tmp / "unsharded_copy")}
    for w in MESHES:
        (tmp / f"w{w}").mkdir()
    with futures.ThreadPoolExecutor(2) as pool:
        worlds = {w: pool.submit(spawn, _CHILD, w, tmp / f"w{w}", SPAWN_TIMEOUT_S,
                                 (tmp / f"w{w}", tmp / "inputs.pt", json.dumps(launch),
                                  SPAWN_TIMEOUT_S - 30))
                  for w in MESHES}
        for case, (rcfg, pcfg, rp, batches, keys, draws) in setups.items():
            if case not in expect:
                expect[case] = _reference(rcfg, rp, batches, keys)
            expect[case] = (expect[case][0], _port_unsharded(
                pcfg, params_from_numpy(_np(rp), pcfg, "cpu"), batches, draws))
        for fut in worlds.values():
            fut.result()
    # the unsharded launcher resumes the sharded run's checkpoint, and its own
    lines["resume_sharded"] = _launch(LAUNCH + ["--steps", "3", "--ckpt-dir",
                                                str(tmp / "sharded")])
    lines["resume_unsharded"] = _launch(LAUNCH + ["--steps", "3", "--ckpt-dir",
                                                  str(unsharded)])
    ranks = {w: torch.load(tmp / f"w{w}" / "results.pt", weights_only=False)
             for w in MESHES}
    return {"tmp": tmp, "expect": expect, "lines": lines, "ranks": ranks}


def _result(run, world, name):
    got = run["ranks"][world]["results"][name]
    assert got == "ok", got


def _hold(got, ref, port, what):
    np.testing.assert_allclose(got["losses"], port["losses"], **STAT, err_msg=what)
    np.testing.assert_allclose(got["gnorms"], port["gnorms"], **STAT, err_msg=what)
    np.testing.assert_allclose(got["losses"], ref["losses"], **STAT, err_msg=what)
    np.testing.assert_allclose(got["gnorms"], ref["gnorms"], **STAT, err_msg=what)
    assert set(got["params"]) == set(port["params"]) == set(ref["params"])
    worst = {}
    for name, want in (("port", port), ("reference", ref)):
        worst[name] = max(float(np.abs(got["params"][p] - want["params"][p]).max())
                          for p in got["params"])
    print(f"{what}: largest param difference after {STEPS} steps: {worst}")
    assert max(worst.values()) <= PARAM_ATOL, (what, worst)


_MESH_CASES = [(w, shape, case) for w, shapes in MESHES.items() for shape in shapes
               for case in CASES]


@pytest.mark.parametrize("world,shape,case", _MESH_CASES,
                         ids=[f"{'x'.join(map(str, s))}-{c}" for _, s, c in _MESH_CASES])
def test_sharded_step_equals_unsharded(run, world, shape, case):
    tag = "x".join(map(str, shape))
    _result(run, world, f"{tag}/{case}")
    got = torch.load(run["tmp"] / f"w{world}" / f"{tag}_{case}.pt", weights_only=False)
    ref, port = run["expect"][case]
    _hold(got, ref, port, f"{tag} {case}")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_levers_equal_unsharded(run, name):
    _result(run, 4, f"2x2/{name}")
    base = VARIANTS[name][0]
    got = torch.load(run["tmp"] / "w4" / f"2x2_{name}.pt", weights_only=False)
    ref, port = run["expect"][base]
    _hold(got, ref, port, f"2x2 {name}")


@pytest.mark.parametrize("name", ["shard_bytes", "shard_bytes_fsdp", "shard_bytes_ff2d",
                                  "pin_refused", "constraint_refused", "init_on_mesh",
                                  "restore_reference_checkpoint", "deis_layouts"])
def test_rank_checks(run, name):
    _result(run, 4, f"2x2/{name}")


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_prefill_and_decode_equal_unsharded(run, case):
    """The prefill and decode steps on the (2, 2) mesh (the dry runs' paths;
    caches laid out by ``cache_specs``) give the unsharded steps' logits and
    caches: kv heads split (whisper's cross cache, its ``k0``) or gathered
    (gemma's one kv head), the SSM conv split and its state gathered."""
    _result(run, 4, f"2x2/prefill_decode_{case}")


def test_fake_counts_equal_a_real_step(run):
    """The dry run's counts of one reduced train step on a fake (2, 2) group
    equal rank 0's of the same step on the gloo (2, 2) mesh: FLOPs, bytes,
    and the collectives' counts and bytes per kind and per axis."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _result(run, 4, "2x2/fake_equals_real")
    real = torch.load(run["tmp"] / "w4" / "counts.pt", weights_only=False)
    cfg = get_config("gemma_2b").reduced().with_(objective="diffusion")
    DRY.init_fake_world(4)
    try:
        mesh = make_host_mesh(model=2)
        with FakeTensorMode():
            fn, args, _ = DRY.make_workload(cfg, COUNT_SHAPE, mesh, device="cpu")
            fake = DRY.count_costs(fn, args, mesh)
    finally:
        torch.distributed.destroy_process_group()
    assert real["flops"] > 0 and real["collectives"]["total"] > 0
    assert {k: fake[k] for k in ("flops", "bytes", "collectives")} == real


def test_sharded_launcher_prints_the_unsharded_lines(run):
    _result(run, 4, "launch_fresh")
    text = run["ranks"][4]["lines"]["fresh"]
    assert "mesh={'data': 2, 'model': 2}" in text
    got, want = _step_lines(text), _step_lines(run["lines"]["fresh"])
    assert sorted(got) == sorted(want) == [0, 1]
    for i in want:
        for k, tol in PRINT_TOL.items():
            assert abs(got[i][k] - want[i][k]) <= tol, (i, k, got[i], want[i])
    assert f"final checkpoint -> {run['tmp'] / 'sharded'}" in text


def test_checkpoints_cross_between_sharded_and_unsharded(run):
    _result(run, 4, "launch_resume_unsharded")
    resumed = {"sharded resumes unsharded": run["ranks"][4]["lines"]["resume"],
               "unsharded resumes sharded": run["lines"]["resume_sharded"],
               "unsharded resumes unsharded": run["lines"]["resume_unsharded"]}
    want = _step_lines(resumed["unsharded resumes unsharded"])
    assert sorted(want) == [2]
    for what, text in resumed.items():
        assert "restored checkpoint at step 2" in text, what
        got = _step_lines(text)
        assert sorted(got) == [2], what
        for k, tol in PRINT_TOL.items():
            assert abs(got[2][k] - want[2][k]) <= tol, (what, k, got, want)


def test_sharded_checkpoint_restores_in_the_reference(run):
    _result(run, 4, "launch_fresh")
    rcfg = ref_get_config("gemma_2b").reduced()
    rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
    like = (rp, RO.AdamW(RO.cosine_schedule(3e-4, 1, 2)).init(rp))
    got, meta = RC.restore(str(run["tmp"] / "sharded"), like, step=2)
    want, _ = RC.restore(str(run["tmp"] / "unsharded"), like, step=2)
    assert meta == {"next_step": 2, "arch": "gemma-2b"} and int(got[1].step) == 2
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=5e-6)
