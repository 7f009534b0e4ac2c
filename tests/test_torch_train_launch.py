"""The training launcher and its data, against the JAX package's
(``repro.launch.train``, ``repro.data.pipeline``), on the CPU
(``--device cpu --reduced``).

* ``MarkovTextSource`` / ``make_batch`` / ``host_iterator``: bitwise the
  reference's batches (pure numpy in both).
* ``python -m repro_torch.launch.train``: the reference's log lines; a run
  resumed from a checkpoint the *reference's* launcher wrote (the ar
  objective draws nothing, so both launchers take the same steps): the
  printed losses and grad norms equal to the reference's resumed run, and
  the final ``(params, opt_state)`` within rtol 1e-4, atol 5e-6 (three
  AdamW steps of lr <= 3e-4: an entry whose grad is small beside the two
  frameworks' summation noise moves by another fraction of lr); its
  checkpoint restores in the reference.
* The resume behaviour of the reference: the generator is re-seeded
  (``seed + 1``) before the loop, so a resumed diffusion run re-uses the
  first steps' draws: bitwise equal to restore + a fresh generator, and
  not the uninterrupted run.
* ``--model-parallel 2`` without a launcher raises (it names torchrun);
  under a launcher's environment at one rank the sharded launcher prints
  the unsharded lines; without ``--device cpu`` it asks for the card."""
import re
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.data import pipeline as RD
from repro.launch import train as RTRAIN
from repro.training import checkpoint as RC
from repro.training import optimizer as RO
from repro_torch.configs import get_config
from repro_torch.data import pipeline as PD
from repro_torch.launch.train import main
from repro_torch.models.transformer import init_params
from repro_torch.training import checkpoint as PC
from repro_torch.training import optimizer as PO
from repro_torch.training.steps import make_train_step

CPU = ["--device", "cpu", "--reduced"]


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7), (11, 123456)])
def test_markov_source_bitwise(seed, step):
    a = PD.MarkovTextSource(1024, seed=seed).batch(step, 4, 33)
    b = RD.MarkovTextSource(1024, seed=seed).batch(step, 4, 33)
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["gemma_2b", "whisper_tiny", "paligemma_3b"])
def test_make_batch_and_iterator_bitwise(arch):
    pcfg, rcfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    got = PD.make_batch(pcfg, PD.MarkovTextSource(pcfg.vocab_size, 2), 5, 3, 16)
    want = RD.make_batch(rcfg, RD.MarkovTextSource(rcfg.vocab_size, 2), 5, 3, 16)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    for g, w, _ in zip(PD.host_iterator(pcfg, 2, 8, seed=1, start_step=4),
                       RD.host_iterator(rcfg, 2, 8, seed=1, start_step=4), range(3)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def _ref_main(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    RTRAIN.main()
    return capsys.readouterr().out


def _shape(out):
    """The log lines with their numbers blanked."""
    return [re.sub(r"-?\d+(\.\d+)?", "#", ln) for ln in out.splitlines()]


def test_logs_and_resume_from_reference_checkpoint(tmp_path, monkeypatch, capsys):
    common = ["--arch", "gemma_2b", "--reduced", "--objective", "ar", "--batch", "2",
              "--seq", "8"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    _ref_main(common + ["--steps", "2", "--ckpt-dir", str(ref_dir)], monkeypatch, capsys)
    shutil.copytree(ref_dir, port_dir)
    ref_out = _ref_main(common + ["--steps", "5", "--ckpt-dir", str(ref_dir)],
                        monkeypatch, capsys)
    main(common + ["--steps", "5", "--ckpt-dir", str(port_dir), "--device", "cpu"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[-1].startswith("trained 3 steps on cpu: median step")
    assert _shape("\n".join(lines[:-1]).replace(str(port_dir), str(ref_dir))) == \
        _shape(ref_out)
    assert "restored checkpoint at step 2" in out and f"final checkpoint -> {port_dir}" in out
    losses = lambda s: re.findall(r"loss=(\S+) gnorm=(\S+)", s)
    assert losses("\n".join(lines[:-1])) == losses(ref_out) and len(losses(out)) == 3

    rcfg = ref_get_config("gemma_2b").reduced().with_(objective="ar")
    from repro.models import transformer as RT
    rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
    like = (rp, RO.AdamW(RO.cosine_schedule(3e-4, 1, 5)).init(rp))
    want, meta_r = RC.restore(str(ref_dir), like)
    got, meta_p = RC.restore(str(port_dir), like)      # the port's checkpoint
    assert meta_p == meta_r == {"next_step": 5, "arch": "gemma-2b"}
    assert int(got[1].step) == int(want[1].step) == 5
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=5e-6)


def test_resumed_run_reuses_the_first_draws(tmp_path, capsys):
    common = ["--arch", "gemma_2b", *CPU, "--batch", "2", "--seq", "8", "--steps", "4"]
    main(common + ["--ckpt-dir", str(tmp_path / "full"), "--ckpt-every", "2"])
    shutil.copytree(tmp_path / "full" / "step_00000002", tmp_path / "half" / "step_00000002")
    main(common + ["--ckpt-dir", str(tmp_path / "half")])
    assert "restored checkpoint at step 2" in capsys.readouterr().out

    cfg = get_config("gemma_2b").reduced().with_(objective="diffusion")
    opt = PO.AdamW(PO.cosine_schedule(3e-4, 1, 4))
    like = (init_params(cfg, 0, "cpu"), opt.init(init_params(cfg, 0, "cpu")))
    (params, state), _ = PC.restore(str(tmp_path / "full"), like, step=2)
    step = make_train_step(cfg, opt)
    gen = torch.Generator().manual_seed(1)          # seed + 1, re-made before the loop
    src = PD.MarkovTextSource(cfg.vocab_size, 0)
    for i in (2, 3):
        batch = {k: torch.from_numpy(v) for k, v in PD.make_batch(cfg, src, i, 2, 8).items()}
        params, state, _ = step(params, state, batch, gen)
    resumed, _ = PC.restore(str(tmp_path / "half"), like)
    full, _ = PC.restore(str(tmp_path / "full"), like, step=4)
    mine = PO.tree_leaves((params, state))
    assert all(torch.equal(a, b) for a, b in zip(PO.tree_leaves(resumed), mine))
    assert not all(torch.equal(a, b) for a, b in zip(PO.tree_leaves(full[0]),
                                                     PO.tree_leaves(resumed[0])))


def test_model_parallel_raises():
    """Without a launcher's environment a sharded mesh has no ranks."""
    with pytest.raises(ValueError, match="torchrun"):
        main(["--arch", "gemma_2b", *CPU, "--model-parallel", "2"])


def test_one_rank_sharded_launcher_prints_the_unsharded_lines(tmp_path, capsys,
                                                              monkeypatch):
    """Under a launcher's environment at one rank the launcher trains on the
    (1, 1) mesh (DTensor params and batches, gloo): the unsharded run's
    loss and grad-norm lines."""
    common = ["--arch", "gemma_2b", *CPU, "--batch", "2", "--seq", "8", "--steps", "3"]
    main(common)
    want = capsys.readouterr().out
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    main(common + ["--dist-init-method", f"file://{tmp_path / 'store'}"])
    got = capsys.readouterr().out
    lines = lambda text: [re.sub(r" \(\S+s\)$", "", ln) for ln in text.splitlines()
                          if ln.startswith(("arch=", "step "))]
    assert lines(got) == lines(want) and len(lines(want)) == 4
    assert not torch.distributed.is_initialized()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_without_device_cpu_it_asks_for_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "gemma_2b", "--reduced", "--steps", "1"])
