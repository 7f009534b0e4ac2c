"""Tiny float32 configurations, mixes and cells written into a directory, so
the harness runs end to end on the CPU in seconds (the plain versions of
the kernels; no card)."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CONFIGS = {
    "tiny-moe": {"name": "tiny-moe", "source": "test", "reduced": [], "model": {
        "name": "tiny-moe", "arch_type": "moe", "n_layers": 2, "d_model": 64, "n_heads": 4,
        "n_kv_heads": 2, "head_dim": 16, "d_ff": 96, "vocab_size": 128, "rope_theta": 1e6,
        "norm_eps": 1e-5, "moe": {"num_experts": 4, "top_k": 2, "capacity_factor": 1.25},
        "moe_dispatch": "einsum", "dtype": "float32", "objective": "diffusion",
        "time_emb_dim": 32}},
    "tiny-dense": {"name": "tiny-dense", "source": "test", "reduced": [], "model": {
        "name": "tiny-dense", "arch_type": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
        "n_kv_heads": 1, "head_dim": 16, "d_ff": 96, "vocab_size": 128, "act": "gelu",
        "sliding_window": 8, "dtype": "float32", "objective": "diffusion", "time_emb_dim": 32}},
    "tiny-ssm": {"name": "tiny-ssm", "source": "test", "reduced": [], "model": {
        "name": "tiny-ssm", "arch_type": "ssm", "n_layers": 2, "d_model": 64, "n_heads": 1,
        "n_kv_heads": 1, "d_ff": 0, "vocab_size": 128, "norm_eps": 1e-5, "tie_embeddings": True,
        "ssm": {"state_dim": 16, "head_dim": 16, "expand": 2, "conv_width": 4, "chunk_size": 16},
        "dtype": "float32", "objective": "diffusion", "time_emb_dim": 32}},
    # layers ssm+mlp, ssm+moe, attn+mlp, ssm+moe; head_dim 32 is one that K2 takes
    "tiny-hybrid": {"name": "tiny-hybrid", "source": "test", "reduced": [], "model": {
        "name": "tiny-hybrid", "arch_type": "hybrid", "n_layers": 4, "d_model": 64,
        "n_heads": 4, "n_kv_heads": 2, "head_dim": 32, "d_ff": 96, "vocab_size": 128,
        "norm_eps": 1e-5, "moe": {"num_experts": 4, "top_k": 2, "capacity_factor": 1.25},
        "ssm": {"state_dim": 16, "head_dim": 16, "expand": 2, "conv_width": 4, "chunk_size": 16},
        "attn_every": 4, "moe_every": 2, "dtype": "float32", "objective": "diffusion",
        "time_emb_dim": 32}},
}
MIXES = {
    "tiny_mix": {"kind": "served", "solvers": {"ddim": 0.25, "tab3": 0.25, "dpm2m": 0.15,
                                               "sndeis2": 0.15, "seeds2": 0.10, "rho_heun": 0.10},
                 "nfe": [2, 4], "seq_len": [4, 16], "buckets": [8, 16], "max_group": 4,
                 "deck_seed": 7, "block": 20},
    "tiny_oneshot": {"kind": "oneshot", "solver": "tab3", "nfe": 4, "batch": 2, "seq_len": 32,
                     "use_kernels": True},
}
CELLS = {
    "tiny-moe.closed": {"config": "tiny-moe", "mix": "tiny_mix",
                        "arrival": {"kind": "closed", "clients": 4}, "warm_s": 0.5,
                        "check": {"sample_tokens": 40, "limits": {"gap_sd": 0.01}}},
    "tiny-ssm.closed": {"config": "tiny-ssm", "mix": "tiny_mix",
                        "arrival": {"kind": "closed", "clients": 4}, "warm_s": 0.5,
                        "check": {"sample_tokens": 40, "limits": {"gap_sd": 0.01}}},
    "tiny-ssm.oneshot": {"config": "tiny-ssm", "mix": "tiny_oneshot",
                         "check": {"limits": {"gap_sd": 0.01, "x0_rel": 1e-3}}},
    "tiny-hybrid.oneshot": {"config": "tiny-hybrid", "mix": "tiny_oneshot",
                            "check": {"limits": {"gap_sd": 0.01, "x0_rel": 1e-3}}},
}


def write(base: Path) -> Path:
    for kind, items in (("configs", CONFIGS), ("mixes", MIXES), ("cells", CELLS)):
        (base / kind).mkdir(parents=True, exist_ok=True)
        for name, data in items.items():
            (base / kind / f"{name}.json").write_text(json.dumps(data))
    (base / "metrics").mkdir(exist_ok=True)
    return base


def run(name: str, base: Path, seconds: float = 1.5, trace: bool = False, seed: int = 2 ** 31 + 5,
        device: str = "cpu"):
    """``chipbench.run.run_cell`` of a tiny cell, on the CPU unless ``device``
    says otherwise."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from chipbench import run as R
    R.setup_env()
    return R.run_cell(name, seed, seconds, trace, device=device, base=base, root=base)
