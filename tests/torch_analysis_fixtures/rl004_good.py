"""Known-good RL004 fixture: disjoint registries, a modifier that is a
subset of a primary, a builder using only registered keys, and a complete
state_specs."""
from typing import NamedTuple

import numpy as np

_STEP_LEAVES = frozenset({"psi", "C", "stage_t"})
_KNOT_LEAVES = frozenset({"mu"})
_STATIC_LEAVES = frozenset({"b"})
_TIME_LEAVES = frozenset({"stage_t"})


def _mk(method, coeffs, ts):
    return method, coeffs, ts


def plan_demo(ts):
    n = len(ts) - 1
    coeffs = {"psi": np.ones(n), "C": np.zeros((n, 1))}
    coeffs["b"] = np.eye(3)
    coeffs.update(mu=np.ones(n + 1))
    return _mk("ab", coeffs, ts)


class SamplerState(NamedTuple):
    x: object
    hist: object
    key: object
    k: int
    err: object


def state_specs(state, mesh):
    return SamplerState(x="data", hist="data", key="data", k=None, err="data")
