"""Readings that a cell's correctness limits are set from (run on the chip).

    python -m chipbench.control --workload CELL --seeds S1,S2,... \\
        --control-seeds S1,S2,S3 [--seconds 8] [--warm-s 3]

In one process, for each seed: a run of the cell as ``chipbench.run`` makes
it (weights from the seed, the cell's own traffic and load, a short window,
the same sample held against the reference), printing the program's check
numbers; for each control seed also the control's: the reference computed
with every weight product in float8 e4m3 (the precision below the
configuration's bf16), on the same sampled requests or call, its tokens
(and x0) judged against the float32 reference as the program's are. The
control must fail a limit that every sound run passes. Prints one JSON line
per seed and a summary line last: each side's range of every number, and
whether each run's numbers pass the cell's limits (``check.verdict``, the
comparison a run makes); the control has to come out as not correct.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys


def control_numbers(weights, model, mix, picked, arch) -> dict:
    """The control's numbers (float8) and a witness's (the reference in bf16,
    the program's own precision) on what the check compared."""
    from . import check
    out = {}
    for prec, key in (("fp8", "control"), ("bf16", "witness_bf16")):
        if isinstance(picked, dict):              # a one-shot call
            nums = check.control_oneshot(weights, model, mix, picked["seeds"], prec, arch)
        else:
            nums = check.control_served(weights, model, [r.spec for r in picked], prec, arch)
        out[key] = nums
    return out


def measure(cell: str, seeds, control_seeds, seconds: float, warm_s: float, **run_kw) -> dict:
    """{"program": {seed: numbers}, "control": {seed: numbers},
    "correct": {"program": {seed: bool}, "control": {seed: bool}}}, each
    side's numbers judged by the cell's limits as a run judges them.
    ``run_kw``: passed on to :func:`chipbench.run.run_cell` (``base``,
    ``device``, ...)."""
    import torch

    from . import check, run, spec
    limits = spec.load_cell(cell, run_kw.get("base", spec.HERE)).get("check", {}).get("limits", {})
    out = {"program": {}, "control": {}, "correct": {"program": {}, "control": {}}}
    for seed in seeds:
        hook = control_numbers if seed in control_seeds else None
        res = run.run_cell(cell, seed, seconds, False, overrides={"warm_s": warm_s},
                           after_check=hook, **run_kw)
        nums = res["notes"]["all_check_numbers"]
        out["program"][seed] = nums
        out["correct"]["program"][seed] = res["correct"]
        line = {"seed": seed, "program": nums, "program_correct": res["correct"],
                "attempted": res["attempted"], "failed": res["failed"]}
        if "control" in res:
            ctrl = res["control"]["control"]
            out["control"][seed] = ctrl
            out["correct"]["control"][seed] = check.verdict(ctrl, limits)[0]
            line.update(res["control"], control_correct=out["correct"]["control"][seed])
        print(json.dumps(line), flush=True)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--warm-s", type=float, default=3.0)
    args = ap.parse_args(argv)
    from . import run
    run.setup_env()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    got = measure(args.workload, seeds + sorted(ctrl - set(seeds)), ctrl, args.seconds,
                  args.warm_s)
    summary = {}
    for side in ("program", "control"):
        for nums in got[side].values():
            for k, v in nums.items():
                if isinstance(v, float):
                    lo, hi = summary.get((side, k), (v, v))
                    summary[side, k] = (min(lo, v), max(hi, v))
    verdicts = {side: sorted(set(v.values())) for side, v in got["correct"].items()}
    print(json.dumps({"summary": {f"{s}.{k}": v for (s, k), v in summary.items()},
                      "correct": verdicts}), flush=True)
    ok = verdicts["program"] == [True] and verdicts["control"] in ([], [False])
    if not ok:
        print(f"chipbench.control: program correct {verdicts['program']}, control correct "
              f"{verdicts['control']}: the limits do not part them", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
