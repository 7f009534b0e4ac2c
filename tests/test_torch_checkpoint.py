"""Checkpoints cross between the packages: a checkpoint the JAX package
writes (``repro.training.checkpoint.save``) restores in the port bitwise,
bfloat16 included, and one the port writes restores in the reference
bitwise (float32: the reference's own ``restore`` cannot cast a bfloat16
leaf back, whichever package wrote it). Same on-disk layout: ``arrays.npz``
plus ``manifest.json`` with the reference's path strings and stacked
blocks."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.models import transformer as RT
from repro.training import checkpoint as RC
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.transformer import init_params
from repro_torch.training import checkpoint as PC


def _models(arch, dtype):
    rcfg = ref_get_config(arch).reduced().with_(objective="diffusion", dtype=dtype)
    pcfg = get_config(arch).reduced().with_(objective="diffusion", dtype=dtype)
    return rcfg, pcfg, RT.init_params(rcfg, jax.random.PRNGKey(0))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _assert_bitwise(got, want):
    g, w = list(_leaves(got)), list(_leaves(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def _manifest(step_dir):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ["gemma_2b", "mamba2_2p7b", "mixtral_8x7b", "jamba_1p5_large"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_port(tmp_path, arch, dtype):
    rcfg, pcfg, rp = _models(arch, dtype)
    RC.save(str(tmp_path), 3, rp, metadata={"arch": arch})
    like = init_params(pcfg, 1, "cpu")
    got, meta = PC.restore(str(tmp_path), like)
    assert meta == {"arch": arch}
    _assert_bitwise(got, params_from_numpy(jax.tree.map(np.asarray, rp), pcfg, "cpu"))


@pytest.mark.parametrize("arch", ["gemma_2b", "mamba2_2p7b", "mixtral_8x7b", "jamba_1p5_large"])
def test_port_checkpoint_restores_in_reference(tmp_path, arch):
    rcfg, pcfg, rp = _models(arch, "float32")
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), pcfg, "cpu")
    step_dir = PC.save(str(tmp_path / "port"), 9, pp, metadata={"k": 1})
    back, meta = RC.restore(str(tmp_path / "port"), rp)
    assert meta == {"k": 1}
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ref_dir = RC.save(str(tmp_path / "ref"), 9, rp, metadata={"k": 1})
    assert _manifest(step_dir) == _manifest(ref_dir)


def test_port_bf16_checkpoint_matches_reference_layout(tmp_path):
    """bfloat16: the same manifest and the same raw bytes as the
    reference's file; the port reads either back bitwise, and the
    reference's restore raises on both alike."""
    rcfg, pcfg, rp = _models("gemma_2b", "bfloat16")
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), pcfg, "cpu")
    port_dir = PC.save(str(tmp_path / "port"), 2, pp)
    ref_dir = RC.save(str(tmp_path / "ref"), 2, rp)
    assert _manifest(port_dir) == _manifest(ref_dir)
    a, b = np.load(os.path.join(port_dir, "arrays.npz")), np.load(os.path.join(ref_dir, "arrays.npz"))
    for name in b.files:
        assert a[name].dtype == b[name].dtype and a[name].tobytes() == b[name].tobytes()
    got, _ = PC.restore(str(tmp_path / "port"), init_params(pcfg, 1, "cpu"))
    _assert_bitwise(got, pp)
    for d in ("port", "ref"):
        with pytest.raises(ValueError):
            RC.restore(str(tmp_path / d), rp)


def test_params_to_numpy_inverts_params_from_numpy():
    for dtype in ("float32", "bfloat16"):
        rcfg, pcfg, rp = _models("mamba2_2p7b", dtype)
        pp = init_params(pcfg, 2, "cpu")
        back = params_from_numpy(params_to_numpy(pp), pcfg, "cpu")
        _assert_bitwise(back, pp)
        ref_shapes = jax.tree.map(lambda a: a.shape, rp)
        assert jax.tree.map(lambda a: a.shape, params_to_numpy(pp)) == ref_shapes


def test_latest_step(tmp_path):
    _, pcfg, _ = _models("gemma_2b", "float32")
    pp = init_params(pcfg, 0, "cpu")
    assert PC.latest_step(str(tmp_path / "none")) is None
    assert PC.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        PC.restore(str(tmp_path), pp)
    for step in (3, 12, 7):
        PC.save(str(tmp_path), step, pp)
    assert PC.latest_step(str(tmp_path)) == RC.latest_step(str(tmp_path)) == 12
    pp2 = init_params(pcfg, 5, "cpu")
    PC.save(str(tmp_path), 7, pp2)             # overwrites step 7 atomically
    got, _ = PC.restore(str(tmp_path), pp, step=7)
    _assert_bitwise(got, pp2)
    got, _ = PC.restore(str(tmp_path), pp2)    # latest: step 12
    _assert_bitwise(got, pp)


def test_missing_key_raises(tmp_path):
    _, pcfg, _ = _models("gemma_2b", "float32")
    pp = init_params(pcfg, 0, "cpu")
    PC.save(str(tmp_path), 1, {k: v for k, v in pp.items() if k != "final_norm"})
    with pytest.raises(KeyError, match=r"\['final_norm'\]"):
        PC.restore(str(tmp_path), pp)


def test_tuple_checkpoint_raises_in_both_packages(tmp_path):
    """The reference's train launcher saves ``(params, opt_state)`` (paths
    ``[0]/...``); restoring with the params as template raises KeyError in
    the reference's serve launcher, and the port mirrors it."""
    rcfg, pcfg, rp = _models("gemma_2b", "float32")
    RC.save(str(tmp_path), 4, (rp, {"mu": jax.tree.map(np.zeros_like, rp)}))
    with pytest.raises(KeyError, match="checkpoint missing"):
        RC.restore(str(tmp_path), rp)
    with pytest.raises(KeyError, match="checkpoint missing"):
        PC.restore(str(tmp_path), init_params(pcfg, 0, "cpu"))
    # the tuple itself restores in the port with a tuple template
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), pcfg, "cpu")
    got, _ = PC.restore(str(tmp_path), (pp, {"mu": init_params(pcfg, 1, "cpu")}))
    _assert_bitwise(got[0], pp)
    assert all(not t.any() for t in _leaves(got[1]))


@pytest.mark.parametrize("arch", ["gemma_2b", "jamba_1p5_large", "whisper_tiny"])
def test_train_state_checkpoints_cross_both_ways(tmp_path, arch):
    """``(params, opt_state)``, as the train launchers save it: the port reads
    the reference's (paths ``[1]/.step``, ``[1]/.m/['blocks']/['slot0']/...``),
    and the reference's ``restore`` reads the port's, bitwise at float32,
    with the same manifest."""
    from repro.training.optimizer import AdamW as RAdamW, constant_schedule
    from repro_torch.models.convert import opt_state_from_numpy, opt_state_to_numpy
    from repro_torch.training.optimizer import AdamW as PAdamW
    rcfg, pcfg, rp = _models(arch, "float32")
    rng = np.random.RandomState(0)
    noisy = lambda tree: jax.tree.map(
        lambda a: rng.randn(*np.shape(a)).astype(np.float32), _np_tree(tree))
    ropt = RAdamW(constant_schedule(1e-3)).init(rp)
    ropt = ropt._replace(step=jax.numpy.int32(7), m=noisy(ropt.m), v=noisy(ropt.v))
    ref_dir = RC.save(str(tmp_path / "ref"), 7, (rp, ropt), {"next_step": 7})
    paths = _manifest(ref_dir)["paths"]
    assert "[1]/.step" in paths and any(p.startswith("[1]/.m/['blocks']/['slot0']/")
                                        for p in paths)

    pp = params_from_numpy(_np_tree(rp), pcfg, "cpu")
    popt = opt_state_from_numpy(_np_tree(ropt), pcfg, "cpu")
    like = (init_params(pcfg, 1, "cpu"), PAdamW(lambda s: 0.0).init(init_params(pcfg, 1, "cpu")))
    (got_p, got_o), meta = PC.restore(str(tmp_path / "ref"), like)
    assert meta == {"next_step": 7}
    _assert_bitwise(got_p, pp)
    assert got_o.step.dtype == torch.int32 and int(got_o.step) == 7
    _assert_bitwise(got_o.m, popt.m)
    _assert_bitwise(got_o.v, popt.v)

    port_dir = PC.save(str(tmp_path / "port"), 7, (pp, popt), {"next_step": 7})
    assert _manifest(port_dir) == _manifest(ref_dir)
    (back_p, back_o), _ = RC.restore(str(tmp_path / "port"), (rp, ropt))
    for a, b in zip(jax.tree.leaves((back_p, back_o)), jax.tree.leaves((rp, ropt))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    step, m, v = opt_state_to_numpy(popt)
    assert step == 7 and jax.tree.structure(m) == jax.tree.structure(_np_tree(ropt.m))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)
