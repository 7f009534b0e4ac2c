"""``BENCH_*.json`` perf-trajectory records and the regression ratchet (a
copy of ``repro.obs.bench``: the same bench.v1 records, which either
package loads and compares).

A bench record is one JSON document per benchmark run::

    {
      "schema": "bench.v1",
      "name": "serving",
      "created": 1754560000.0,          # unix seconds (wall-clock label)
      "meta": {"quick": true, "torch": "2.11.0", "device": "cpu", ...},
      "metrics": {
        "continuous_admission.joins_on.wasted_row_steps": {
            "value": 0.0, "unit": "steps", "direction": "lower",
            "ratchet": true, "tol": 0.0},
        "throughput.tab3_nfe10.us_per_request": {
            "value": 51234.2, "unit": "us", "direction": "lower",
            "ratchet": false}
      }
    }

Ratchet semantics (:func:`compare`): for every metric present in BOTH
records with ``ratchet: true``, the current value may not regress past the
baseline by more than the metric's tolerance (``tol``, a relative fraction;
the CLI ``--tol`` is the default for metrics that carry none):

* ``direction: "lower"``  -- regression when ``cur > base * (1 + tol)``
  (plus an absolute epsilon so a 0.0 baseline tolerates float noise);
* ``direction: "higher"`` -- regression when ``cur < base * (1 - tol)``.

Deterministic scheduler metrics (wasted steps, warm recompiles, tick-counted
queue waits) ratchet at ``tol: 0`` -- any drift fails. Wall-clock timings
are recorded with ``ratchet: false`` by default: they accumulate the
trajectory without making CI flaky across machines; flip them on (with a
generous tol) on a pinned benchmark host. A record always compares clean
against itself, which is what a perf-smoke check asserts before ratcheting
against the committed baseline.

CLI::

    python -m repro_torch.obs.bench show BENCH_serving.json
    python -m repro_torch.obs.bench compare BASELINE.json CURRENT.json [--tol 0.1]

``compare`` exits non-zero on any regression (the CI failure signal) and
prints one line per compared metric.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

SCHEMA = "bench.v1"
# absolute slack added on top of the relative tolerance so integer-zero
# baselines (wasted_row_steps == 0) do not demand bit-equality of floats
_ABS_EPS = 1e-9


def metric(value: float, *, unit: str = "", direction: str = "lower",
           ratchet: bool = False, tol: Optional[float] = None) -> dict:
    """One metric entry. ``direction`` is which way is BETTER."""
    if direction not in ("lower", "higher"):
        raise ValueError(f"direction must be 'lower' or 'higher', "
                         f"got {direction!r}")
    out = {"value": float(value), "unit": unit, "direction": direction,
           "ratchet": bool(ratchet)}
    if tol is not None:
        out["tol"] = float(tol)
    return out


def device_meta(device=None) -> dict:
    """``{"torch": version, "device": name}``: the framework and the device
    a record was taken on (``device`` a torch device or its name, default
    the CPU; a CUDA device is named by ``torch.cuda.get_device_name``)."""
    import torch
    dev = torch.device("cpu" if device is None else device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return {"torch": torch.__version__, "device": name}


def record(name: str, metrics: dict, meta: Optional[dict] = None,
           device=None) -> dict:
    """Assemble a bench record (adds schema/name/created/meta envelope).
    ``meta`` names torch and the device (:func:`device_meta`) unless it
    names them itself."""
    return {"schema": SCHEMA, "name": name, "created": time.time(),
            "meta": {**device_meta(device), **(meta or {})}, "metrics": dict(metrics)}


def write(path: str, rec: dict) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, sort_keys=True)
        f.write("\n")


def load(path: str) -> dict:
    with open(path) as f:
        rec = json.load(f)
    if rec.get("schema") != SCHEMA:
        raise ValueError(f"{path}: unsupported bench schema "
                         f"{rec.get('schema')!r} (want {SCHEMA!r})")
    return rec


@dataclasses.dataclass
class Comparison:
    """One metric's baseline-vs-current verdict."""
    name: str
    base: float
    cur: float
    direction: str
    tol: float
    ratcheted: bool
    regressed: bool

    def line(self) -> str:
        tag = ("REGRESSED" if self.regressed else
               "ok" if self.ratcheted else "info")
        return (f"  [{tag:>9}] {self.name}: {self.base:g} -> {self.cur:g} "
                f"({self.direction} is better, tol={self.tol:g})")


def compare(baseline: dict, current: dict,
            default_tol: float = 0.0) -> list[Comparison]:
    """Compare two bench records; see the module docstring for semantics.

    Only metrics present in BOTH records are compared (a new metric starts
    its trajectory without failing the ratchet; a dropped one should be
    caught in review of the baseline file). Returns one
    :class:`Comparison` per shared metric; ``regressed`` is only ever True
    for ratcheted metrics."""
    out = []
    for name in sorted(set(baseline["metrics"]) & set(current["metrics"])):
        b, c = baseline["metrics"][name], current["metrics"][name]
        direction = b.get("direction", "lower")
        tol = float(b.get("tol", default_tol))
        ratcheted = bool(b.get("ratchet", False))
        bv, cv = float(b["value"]), float(c["value"])
        if direction == "lower":
            bad = cv > bv * (1.0 + tol) + _ABS_EPS
        else:
            bad = cv < bv * (1.0 - tol) - _ABS_EPS
        out.append(Comparison(name=name, base=bv, cur=cv,
                              direction=direction, tol=tol,
                              ratcheted=ratcheted,
                              regressed=ratcheted and bad))
    return out


def regressions(comps: list[Comparison]) -> list[Comparison]:
    return [c for c in comps if c.regressed]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.obs.bench")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("show", help="pretty-print a bench record")
    ps.add_argument("path")
    pc = sub.add_parser("compare",
                        help="ratchet CURRENT against BASELINE; exit 1 on "
                             "regression beyond tolerance")
    pc.add_argument("baseline")
    pc.add_argument("current")
    pc.add_argument("--tol", type=float, default=0.0,
                    help="default relative tolerance for ratcheted metrics "
                         "that carry none (default 0)")
    args = ap.parse_args(argv)

    if args.cmd == "show":
        rec = load(args.path)
        print(f"{rec['name']} (created {rec['created']}) meta={rec['meta']}")
        for name in sorted(rec["metrics"]):
            m = rec["metrics"][name]
            flag = "ratchet" if m.get("ratchet") else "info"
            print(f"  [{flag:>7}] {name} = {m['value']:g} {m.get('unit', '')}")
        return 0

    base, cur = load(args.baseline), load(args.current)
    if base.get("meta", {}).get("quick") != cur.get("meta", {}).get("quick"):
        print("warning: comparing records from different quick/full modes; "
              "metric values are not commensurate", file=sys.stderr)
    comps = compare(base, cur, default_tol=args.tol)
    print(f"compared {len(comps)} shared metrics "
          f"({sum(c.ratcheted for c in comps)} ratcheted):")
    for c in comps:
        print(c.line())
    bad = regressions(comps)
    if bad:
        print(f"\n{len(bad)} metric(s) regressed beyond tolerance",
              file=sys.stderr)
        return 1
    print("ratchet clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
