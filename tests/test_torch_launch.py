"""The port's serving launcher, ``python -m repro_torch.launch.serve``, on the
CPU (``--device cpu --reduced``): the sync and driver transports, the AR
mode on every ported arch, ``--ckpt-dir`` (a checkpoint the JAX package
wrote), ``--metrics-ndjson`` and the scheduler flags; ``--data-parallel``
over 2 gloo ranks (a launcher's ``RANK`` / ``WORLD_SIZE`` environment) and
as a one-rank group without that environment, each giving the tokens of a
run without the flag; and without ``--device cpu`` the launcher asks for
the card (no CPU fallback). The HTTP transport's routes are held in
``tests/test_torch_driver.py``."""
import json
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.models import transformer as RT
from repro.training import checkpoint as RC
from repro_torch.configs import get_config
from repro_torch.launch.serve import main
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import ARServeEngine, DiffusionServeEngine, Request

CPU = ["--device", "cpu", "--reduced"]


def test_sync_transport(capsys):
    main(["--arch", "gemma_2b", *CPU, "--requests", "3", "--nfe", "4",
          "--seq-len", "8", "--solver", "tab2"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out
    assert len(re.findall(r"step \d+/\d+ for uids", out)) == 4   # one group, 4 steps
    # the printed tokens are what the engine gives for the same requests
    cfg = get_config("gemma_2b").reduced().with_(objective="diffusion")
    res = DiffusionServeEngine(init_params(cfg, 0, "cpu"), cfg, device="cpu").serve(
        [Request(uid=i, seq_len=8, nfe=4, solver="tab2", seed=i) for i in range(3)])
    for r in res:
        assert f"tokens[:10]={r.tokens[:10]}" in out


def test_driver_transport(capsys):
    main(["--arch", "gemma_2b", *CPU, "--transport", "driver", "--requests", "4",
          "--seq-len", "8", "--max-pending", "8"])
    out = capsys.readouterr().out
    assert "served 4 requests" in out
    stats = out.split("stats=")[1]
    assert "'completed': 4" in stats and "'shed': 0" in stats
    for uid, nfe in enumerate([4, 8, 12, 4]):
        assert f"req {uid}: step {nfe}/{nfe}" in out and f"req {uid}: nfe={nfe}" in out


def test_scheduler_flags(capsys, tmp_path):
    path = tmp_path / "m.ndjson"
    main(["--arch", "gemma_2b", *CPU, "--requests", "4", "--nfe", "6", "--seq-len", "12",
          "--solver", "tab3", "--steps-per-tick", "1", "--no-compaction", "--no-join",
          "--seq-len-buckets", "8,16", "--early-exit-tol", "1e9", "--early-exit-min-k",
          "2", "--early-exit-norm", "rel", "--enforce-deadlines", "--trace-annotate",
          "--metrics-ndjson", str(path)])
    out = capsys.readouterr().out
    assert "early exit on:" in out and "served 4 requests" in out
    assert "early exits: 4/4" in out             # tol 1e9: every row retires at min_k
    doc = json.loads(path.read_text().splitlines()[-1])
    assert doc["arch"] == "gemma_2b"
    m = doc["metrics"]
    assert m["serve_early_exit_total"] == 4 and m["serve_completed_total"] == 4
    assert m["serve_saved_nfe_total"] > 0
    assert "trace_admit_seconds" in m            # spans recorded with annotate on


def test_metrics_ndjson_driver(capsys, tmp_path):
    path = tmp_path / "d.ndjson"
    main(["--arch", "gemma_2b", *CPU, "--transport", "driver", "--requests", "2",
          "--seq-len", "8", "--metrics-ndjson", str(path)])
    lines = path.read_text().splitlines()
    assert len(lines) == 1
    m = json.loads(lines[0])["metrics"]
    assert m["driver_submitted_total"] == 2 and m["serve_completed_total"] == 2
    assert m["driver_loop_seconds"]["count"] > 0 and m["driver_crash_total"] == 0


@pytest.mark.parametrize("arch", ["gemma_2b", "mamba2_2p7b", "h2o_danube_3_4b",
                                  "mixtral_8x7b", "grok_1_314b", "jamba_1p5_large"])
def test_ar_mode(capsys, arch):
    main(["--arch", arch, *CPU, "--mode", "ar", "--requests", "2", "--max-new", "5",
          "--seq-len", "8"])
    out = capsys.readouterr().out
    assert "served 2 requests" in out
    cfg = get_config(arch).reduced().with_(objective="ar")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, 8) for _ in range(2)]
    res = ARServeEngine(init_params(cfg, 0, "cpu"), cfg, max_len=13, device="cpu").serve(
        [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)])
    for r in res:
        assert f"req {r.uid}: latency=" in out and f"tokens={r.tokens[:10]}" in out


def test_ckpt_dir_restores_reference_checkpoint(capsys, tmp_path):
    """--ckpt-dir reads a checkpoint the JAX package wrote: the served AR
    tokens are those of the reference's weights."""
    rcfg = ref_get_config("gemma_2b").reduced().with_(objective="ar")
    rp = RT.init_params(rcfg, jax.random.PRNGKey(7))
    RC.save(str(tmp_path), 11, rp)
    main(["--arch", "gemma_2b", *CPU, "--mode", "ar", "--requests", "1", "--max-new", "4",
          "--seq-len", "8", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"restored params from {tmp_path}" in out
    cfg = get_config("gemma_2b").reduced().with_(objective="ar")
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), cfg, "cpu")
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, 8)
    res = ARServeEngine(pp, cfg, max_len=12, device="cpu").serve(
        [Request(uid=0, prompt=prompt, max_new_tokens=4)])
    assert f"tokens={res[0].tokens[:10]}" in out


def test_ckpt_dir_tuple_checkpoint_raises(tmp_path):
    """A (params, opt_state) checkpoint, as the reference's train launcher
    writes, raises KeyError here as in the reference's serve launcher."""
    rcfg = ref_get_config("gemma_2b").reduced().with_(objective="diffusion")
    rp = RT.init_params(rcfg, jax.random.PRNGKey(0))
    RC.save(str(tmp_path), 1, (rp, {}))
    with pytest.raises(KeyError, match="checkpoint missing"):
        main(["--arch", "gemma_2b", *CPU, "--requests", "1", "--ckpt-dir", str(tmp_path)])


SYNC = ["--arch", "gemma_2b", *CPU, "--requests", "3", "--nfe", "4", "--seq-len", "8",
        "--solver", "tab2"]
MESH_LINE = "request-parallel mesh: {} devices on axis 'data'"


def _token_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("req ") and "tokens" in ln]


def test_data_parallel_without_launcher_env_is_one_rank(capsys, monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    main(SYNC)
    plain = capsys.readouterr().out
    main(SYNC + ["--data-parallel"])
    out = capsys.readouterr().out
    assert MESH_LINE.format(1) in out and "served 3 requests" in out
    assert not torch.distributed.is_initialized()      # the launcher tore its group down
    strip = lambda lines: [re.sub(r"(solve|compile)=\S+ ", "", ln) for ln in lines]  # wall clocks
    assert strip(_token_lines(out)) == strip(_token_lines(plain)) and len(_token_lines(out)) == 3


DRIVER = ["--arch", "gemma_2b", *CPU, "--transport", "driver", "--requests", "4",
          "--seq-len", "8"]

# both transports in one pair of processes, one process group after the
# other (each run of the launcher makes and destroys its own)
_RANK_CHILD = r'''
import json, os, sys
rank, world, store = sys.argv[1:4]
os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank)
import torch
torch.set_num_threads(1)
from repro_torch.launch.serve import main
for name, args in json.loads(sys.argv[4]).items():
    print(f"=== {name}", flush=True)
    main(args + ["--data-parallel", "--dist-init-method", f"file://{store}_{name}"])
    sys.stdout.flush()
'''
_RANK_LOGS: dict = {}


@pytest.mark.parametrize("transport", ["sync", "driver"])
def test_data_parallel_two_gloo_ranks(tmp_path_factory, capsys, transport):
    """``--device cpu --reduced --data-parallel`` as ranks 0 and 1 of a gloo
    group: rank 0 prints the mesh line and the results (the sync run's
    tokens are a run's without the flag), rank 1 prints nothing."""
    from test_torch_sharded_serving import spawn
    if not _RANK_LOGS:
        logs = spawn(_RANK_CHILD, 2, tmp_path_factory.mktemp("dp"), timeout=180,
                     args=(json.dumps({"sync": SYNC, "driver": DRIVER}),))
        for r, log in enumerate(logs):
            _, sync, driver = log.split("=== ")
            _RANK_LOGS[r] = {"sync": sync, "driver": driver}
    logs = [_RANK_LOGS[r][transport] for r in (0, 1)]
    assert MESH_LINE.format(2) in logs[0] and "request-parallel" not in logs[1]
    assert "served" not in logs[1]
    if transport == "driver":
        assert "served 4 requests" in logs[0] and "'completed': 4" in logs[0]
        return
    main(SYNC)
    plain = capsys.readouterr().out
    strip = lambda lines: [re.sub(r"(solve|compile)=\S+ ", "", ln) for ln in lines]  # wall clocks
    assert strip(_token_lines(logs[0])) == strip(_token_lines(plain))
    assert len(_token_lines(plain)) == 3


def test_without_a_card_cuda_is_refused():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "gemma_2b", "--reduced", "--requests", "1"])
