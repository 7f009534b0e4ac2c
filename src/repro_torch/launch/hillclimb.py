"""Perf hillclimb driver on the dry runs: run an (arch x shape) pair's
baseline and a series of named variants through ``launch.dryrun`` and print
each variant's roofline terms over the baseline's (the counterpart of
``repro.launch.hillclimb``: the same pairs, variants and levers).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --pair grok_train
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --pair gemma_deis --device cpu
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --pair jamba_train --out hc_jamba.json

Each variant records: hypothesis -> change -> before/after terms -> ratio.
The hypotheses are the port's: its collectives are explicit
(``sharding.tensor_parallel``), so where the reference's name what GSPMD
chose, these name what the port's code does. Every term is modelled from
counts with H100 SXM spec constants, none is measured.
"""
import argparse
import json

import torch.distributed as dist

from .dryrun import dryrun_one, init_fake_world

# variant = (name, hypothesis, overrides/kwargs)
PAIRS = {
    # the most memory-bound pair: the plain SSD materializes the
    # (B, n_chunks, L, L, H) within-chunk decay tensor; bytes scale ~ S*L*H
    "jamba_train": {
        "arch": "jamba_1p5_large", "shape": "train_4k",
        "variants": [
            ("ssd_chunk_128",
             "decay tensor bytes scale linearly with chunk L (S*L*H f32 words); "
             "halving L=256->128 should cut SSD intermediate bytes ~2x with "
             "negligible extra cross-chunk state traffic (S/L states of P*N)",
             {"overrides": {"ssm_chunk_size": 128}}),
            ("ssd_chunk_64",
             "same scaling law, L=64: ~4x fewer decay bytes vs baseline; "
             "state-passing overhead (S/L * P * N) still << decay savings",
             {"overrides": {"ssm_chunk_size": 64}}),
            ("moe_gather",
             "jamba is also MoE (16e top-2): replacing the one-hot dispatch and "
             "combine products by the slot table's gathers removes the "
             "O(S*E*C*D) dispatch matmuls and the (B,S,E,C) one-hot bytes",
             {"overrides": {"moe_dispatch": "gather"}}),
            ("combined",
             "chunk=64 + gather dispatch compose (memory and FLOPs both drop); "
             "the reference's ZeRO-3 constraint and batch pin ride along as "
             "checks: the port's fsdp already gathers per layer and its MoE "
             "already runs on the rows split over 'data'",
             {"overrides": {"ssm_chunk_size": 64, "moe_dispatch": "gather",
                            "act_shard_axes": ("data",)}, "zero3": True}),
        ],
    },
    # the most collective-bound pair
    "grok_train": {
        "arch": "grok_1_314b", "shape": "train_4k",
        "variants": [
            ("moe_gather",
             "the one-hot dispatch and combine products (S*E*C*D per layer per "
             "direction) dominate the FLOPs and their (B,S,E,C) tensors the "
             "bytes; the slot table's gathers remove both (the port's MoE "
             "collectives are the experts' 'model' all-reduces either way)",
             {"overrides": {"moe_dispatch": "gather"}}),
            ("ce_onehot",
             "vocab=131072 logits are split over 'model'; ce_mode 'gather' "
             "all-gathers the (B,S,V) f32 logits over 'model' (cross_entropy's "
             "gather_model); 'onehot' keeps them split and all-reduces (B,S) "
             "scalars: the all-gather bytes and the logits' memory both drop",
             {"overrides": {"ce_mode": "onehot"}}),
            ("ff2d_sharding",
             "2D-shard d_ff over (data, model) instead of FSDP on the "
             "contraction dim: the port computes each layer in its storage "
             "layout without 'data', and its relayout gathers a dim split over "
             "(data, model) whole over both axes before it cuts the 'model' "
             "block, so the experts' weights all-gather ~16x the bytes of the "
             "baseline's 'data'-only gather (and reduce-scatter as much back): "
             "expect collective_s to rise, compute unchanged",
             {"ff2d": True}),
            ("zero3_block_gather",
             "the reference's per-layer ZeRO-3 block_constraint: the port's "
             "fsdp is already per-layer ZeRO-3 (make_train_step checks the "
             "constraint and takes it), so expect exactly no change",
             {"zero3": True}),
            ("pin_batch",
             "act_shard_axes=('data',): the port's MoE already runs on this "
             "rank's rows of the batch split over 'data' (explicit, no "
             "propagation to override); the pin only checks that: expect "
             "exactly no change",
             {"overrides": {"act_shard_axes": ("data",)}}),
            ("gather_zero3_pin",
             "compose: gather dispatch + the two levers that are checks in the "
             "port: expect moe_gather's ratios",
             {"overrides": {"moe_dispatch": "gather",
                            "act_shard_axes": ("data",)}, "zero3": True}),
        ],
    },
    # paper-representative pair: one DEIS NFE in embedding space
    "gemma_deis": {
        "arch": "gemma_2b", "shape": "deis_4k",
        "variants": [
            ("control_ce_onehot",
             "no CE in this workload -- control variant, expect EXACTLY no change",
             {"overrides": {"ce_mode": "onehot"}}),
            ("seq_shard_state",
             "x and the history split over 'model' on the sequence instead of "
             "d_model: the port gathers x whole over 'model' for the eps-net "
             "and keeps its block of eps in either layout (it has no "
             "sequence-parallel attention), so the update and history stay "
             "local both ways: expect the same bytes moved in another dim, "
             "ratios ~1",
             {"deis_shard": "seq"}),
            ("pin_na_control",
             "MoE pin lever is dense-model no-op here -- control",
             {"overrides": {"act_shard_axes": ("data",)}}),
        ],
    },
}


def run_pair(pair_name: str, multi_pod: bool = False, device=None):
    """The pair's baseline and variants (``dryrun_one`` on the production
    mesh of the default process group)."""
    spec = PAIRS[pair_name]
    out = {"pair": pair_name, "arch": spec["arch"], "shape": spec["shape"],
           "iterations": []}
    print(f"=== {pair_name}: BASELINE ===")
    base = dryrun_one(spec["arch"], spec["shape"], multi_pod=multi_pod,
                      verbose=False, device=device)
    print(json.dumps(base["roofline"]))
    out["baseline"] = base
    for name, hypothesis, kw in spec["variants"]:
        print(f"=== {pair_name}: {name} ===")
        print(f"hypothesis: {hypothesis}")
        res = dryrun_one(spec["arch"], spec["shape"], multi_pod=multi_pod,
                         verbose=False, device=device, **kw)
        rb, rv = base["roofline"], res["roofline"]
        deltas = {k: (None if (rb[k] in (None, 0) or rv[k] is None)
                      else round(rv[k] / rb[k], 4)) for k in rb}
        print(f"terms: {json.dumps(rv)}")
        print(f"vs baseline (ratio): {json.dumps(deltas)}")
        out["iterations"].append({
            "name": name, "hypothesis": hypothesis, "result": res,
            "ratio_vs_baseline": deltas,
        })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", required=True, choices=sorted(PAIRS))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device the fake tensors claim (default cuda; cpu runs "
                         "without a card)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    init_fake_world(512 if args.multi_pod else 256)
    try:
        res = run_pair(args.pair, args.multi_pod, args.device)
    finally:
        dist.destroy_process_group()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
