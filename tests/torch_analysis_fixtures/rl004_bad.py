"""Known-bad RL004 fixture: overlapping registries, a stray modifier key,
a builder inventing unregistered coefficient keys, and a state_specs call
missing a SamplerState field."""
from typing import NamedTuple

import numpy as np

_STEP_LEAVES = frozenset({"psi", "C", "mu"})
_KNOT_LEAVES = frozenset({"mu"})
_STATIC_LEAVES = frozenset({"b"})
_TIME_LEAVES = frozenset({"stage_t", "sigma_grid"})


def _mk(method, coeffs, ts):
    return method, coeffs, ts


def plan_demo(ts):
    n = len(ts) - 1
    coeffs = {"psi": np.ones(n), "mystery": np.ones(n)}
    coeffs["b"] = np.eye(3)
    coeffs.update(extra_gain=np.ones(n))
    return _mk("ab", coeffs, ts)


class SamplerState(NamedTuple):
    x: object
    hist: object
    key: object
    k: int
    err: object


def state_specs(state, mesh):
    return SamplerState(x="data", hist="data", key="data", k=None)
