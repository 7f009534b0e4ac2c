"""Models laid out layer by layer by kind: the harness's frozen rule against
the port's, the harness's weights against the port's parameter tree, the
bytes of the existing configurations' weights pinned, and an architecture
added by files alone (a configuration's ``"arch"`` naming a reference
module)."""
import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chipbench import check, flops, spec  # noqa: E402
from chipbench import weights as W  # noqa: E402
from chipbench.layers import layer_kinds  # noqa: E402
from chipbench.tests import _tiny  # noqa: E402

HARNESS_CONFIGS = sorted((ROOT / "chipbench" / "configs").glob("*.json"))


def _models():
    out = {p.stem: json.loads(p.read_text())["model"] for p in HARNESS_CONFIGS}
    out.update({k: v["model"] for k, v in _tiny.CONFIGS.items()})
    return out


def _port_kinds(m: dict) -> list:
    from repro_torch.configs.base import config_from_dict
    from repro_torch.models import transformer as T
    cfg = config_from_dict(m)
    return [T._layer_kind(cfg, i) for i in range(cfg.n_layers)]


@pytest.mark.parametrize("name", sorted(_models()))
def test_layer_kinds_follow_the_ports_rule(name):
    m = _models()[name]
    assert layer_kinds(m) == _port_kinds(m)


@pytest.mark.parametrize("arch_id", ["jamba_1p5_large", "mixtral_8x7b", "mamba2_2p7b",
                                     "gemma_2b", "grok_1_314b"])
def test_layer_kinds_of_the_ports_own_configs(arch_id):
    """The port's registered configs, with their blocks and MoE slots."""
    import dataclasses

    from repro_torch.configs import get_config
    m = json.loads(json.dumps(dataclasses.asdict(get_config(arch_id))))
    assert layer_kinds(m) == _port_kinds(m)


@pytest.mark.parametrize("arch", ["encdec", "vlm"])
def test_layer_kinds_refuse_what_the_harness_does_not_lay_out(arch):
    m = dict(_tiny.CONFIGS["tiny-dense"]["model"], arch_type=arch)
    with pytest.raises(ValueError, match=arch):
        layer_kinds(m)


def test_tiny_hybrid_mixes_its_kinds():
    assert layer_kinds(_tiny.CONFIGS["tiny-hybrid"]["model"]) == [
        ("ssm", "dense"), ("ssm", "moe"), ("attn", "dense"), ("ssm", "moe")]


def _tree(node):
    if isinstance(node, dict):
        return {k: _tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree(v) for v in node]
    return (tuple(node.shape), node.dtype)


@pytest.mark.parametrize("name", sorted(_tiny.CONFIGS))
def test_weights_tree_is_the_ports(name):
    """Keys, shapes and dtypes of ``W.make`` equal the port's ``init_params``."""
    from repro_torch.configs.base import config_from_dict
    from repro_torch.models import transformer as T
    m = _tiny.CONFIGS[name]["model"]
    mine = W.make(m, 3, torch.device("cpu"))
    port = T.init_params(config_from_dict(m), generator=0, device=torch.device("cpu"))
    assert _tree(mine) == _tree(port)
    assert W.n_params(m) == sum(t.numel() for t in _leaves(port))


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def _digest(w) -> str:
    h = hashlib.sha256()
    for t in _leaves(w):
        h.update(str((tuple(t.shape), str(t.dtype))).encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


# sha256 over each leaf's (shape, dtype) and bytes in the tree's order, of
# W.make(model, 3, cpu) as chipbench/weights.py made them at commit 82ed6f2
# (before the layers were laid out by kind), on torch's CPU generator
PINNED = {
    "tiny-ssm": "318ef36de3fbb77182c07252e8263977b8c9c8bd174abdfd12786d4d8f0e2457",
    "tiny-moe": "3901cccc3bbdb1900ed459b4b70c52962389fb6b84abffcb870ce2c945f8d42d",
    "tiny-dense": "caa1d7d8596cb34cd8adc77231d01e7dd5c4248039827d70ad1f2531430d0539",
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_weights_bytes_are_pinned(name):
    m = _tiny.CONFIGS[name]["model"]
    assert _digest(W.make(m, 3, torch.device("cpu"))) == PINNED[name]


# a reference module added by files alone: a Net subclass that counts its
# forwards, and one extra leaf per layer, counted in the FLOPs
ARCH_MODULE = '''
from chipbench import weights
from chipbench.reference import model

EXTRA_FLOPS = 1000.0


class Net(model.Net):
    forwards = 0

    def __call__(self, x, t, valid_len):
        Net.forwards += 1
        assert all("extra" in layer for layer in self.w["blocks"])
        return super().__call__(x, t, valid_len)


def layer_leaves(m, i, kinds, rnd, const):
    layer = weights.layer_leaves(m, i, kinds, rnd, const)
    layer["extra"] = rnd((m["d_model"],), 0.5)
    return layer


def layer_flops(m, i, seq_len):
    from chipbench import flops
    from chipbench.layers import layer_kinds
    return flops.kind_flops(m, layer_kinds(m)[i], seq_len) + EXTRA_FLOPS
'''


@pytest.fixture(scope="module")
def arch_base(tmp_path_factory):
    base = _tiny.write(tmp_path_factory.mktemp("arch"))
    (base / "reference").mkdir()
    (base / "reference" / "tiny_arch.py").write_text(ARCH_MODULE)
    for name, arch in (("tiny-hybrid-x", "tiny_arch"), ("tiny-hybrid-none", "no_such_arch")):
        cfg = dict(_tiny.CONFIGS["tiny-hybrid"], name=name, arch=arch)
        (base / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        cell = dict(_tiny.CELLS["tiny-hybrid.oneshot"], config=name)
        (base / "cells" / f"{name}.oneshot.json").write_text(json.dumps(cell))
    return base


def test_a_config_without_arch_takes_the_model_module(arch_base):
    from chipbench.reference import model
    assert spec.load_cell("tiny-hybrid.oneshot", arch_base)["arch_module"] is model
    assert spec.arch_module() is model


def test_arch_module_lays_out_counts_and_checks(arch_base):
    cell = spec.load_cell("tiny-hybrid-x.oneshot", arch_base)
    mod = cell["arch_module"]
    assert mod.__name__ != "chipbench.reference.model" and issubclass(mod.Net, check.R.Net)
    m = cell["config_data"]["model"]
    d, n = m["d_model"], m["n_layers"]
    w = W.make(m, 3, torch.device("cpu"), mod)
    assert all(layer["extra"].shape == (d,) for layer in w["blocks"])
    assert W.n_params(m, mod) == W.n_params(m) + n * d
    assert flops.per_token_forward(m, 32, mod) == flops.per_token_forward(m, 32) + n * 1000.0
    assert flops.sample_flops(m, 32, 4, mod) == flops.sample_flops(m, 32, 4) + 4 * 32 * n * 1000.0
    mix = cell["mix_data"]
    net, _ = check.reference_oneshot(w, m, mix, (1, 2), arch=mod)
    assert type(net) is mod.Net


def test_arch_module_runs_a_cell_end_to_end(arch_base):
    mod = spec.load_cell("tiny-hybrid-x.oneshot", arch_base)["arch_module"]
    before, threads = mod.Net.forwards, torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = _tiny.run("tiny-hybrid-x.oneshot", arch_base)
    finally:
        torch.set_num_threads(threads)
    assert res["correct"], res["check"]
    assert mod.Net.forwards > before


def test_missing_arch_module_names_those_there(arch_base):
    with pytest.raises(FileNotFoundError, match=r"no_such_arch.*'model'.*'tiny_arch'"):
        spec.load_cell("tiny-hybrid-none.oneshot", arch_base)
