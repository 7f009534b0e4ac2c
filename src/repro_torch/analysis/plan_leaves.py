"""RL004 -- plan-leaf guard: every coefficient key a ``plan_*`` builder
constructs must be classifiable by the port's leaf-role registries (the
static twin of ``core/plan._leaf_role``'s registered-name rule; a copy of
``repro.analysis.plan_leaves`` over the port's registry names).

``pad_plan``/``stack_plans``/``inert_row``/``take_rows`` and the sharding
specs all decide per-leaf behavior from ``_leaf_role(name, shape,
n_steps)``; a novel key that is not in ``_STEP_LEAVES`` / ``_KNOT_LEAVES``
/ ``_STATIC_LEAVES`` falls back to a shape heuristic that can misclassify
it (a static tableau whose length happens to equal ``n_steps`` becomes
"per-step" and gets padded/gathered). So:

* every key in a dict built inside a ``plan_*`` function (literal dicts
  handed to ``_mk``, ``coeffs[...] = ...`` stores, ``coeffs.update(...)``)
  must appear in one of the role registries;
* the primary registries must stay pairwise disjoint (a key in two roles
  is unclassifiable); modifier registries (``_TIME_LEAVES``) must be
  subsets of a primary one;
* the ``SamplerState(...)`` constructed by ``sharding/rules.state_specs``
  must name every field of ``core/sampler.SamplerState`` -- a new state
  field without a sharding spec would silently replicate (and a typo'd
  field would crash at serve time, not at review time).

The checker is project-level: registries may live in one file (core/plan)
and builders/specs in others; a self-contained fixture file works too.
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional, Sequence

from .base import Checker, FileContext, Violation
from .config import MODIFIER_REGISTRIES, ROLE_REGISTRIES


def _frozenset_literal(node: ast.AST) -> Optional[set]:
    """The string set of ``frozenset({...})`` / ``frozenset((...))``."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and \
            node.func.id == "frozenset" and node.args:
        elts = getattr(node.args[0], "elts", None)
        if elts is not None and all(isinstance(e, ast.Constant) and
                                    isinstance(e.value, str) for e in elts):
            return {e.value for e in elts}
    return None


class PlanLeafChecker(Checker):
    rule = "RL004"
    title = "plan-leaf guard (coefficient keys vs role registries and sharding specs)"

    def check(self, ctxs: Sequence[FileContext]) -> Iterable[Violation]:
        registries: dict[str, tuple[FileContext, ast.AST, set]] = {}
        builders: list[tuple[FileContext, ast.FunctionDef]] = []
        state_fields: Optional[tuple[FileContext, ast.ClassDef, list]] = None
        spec_calls: list[tuple[FileContext, ast.Call]] = []

        for ctx in ctxs:
            if ctx.tree is None:
                continue
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    name = node.targets[0].id
                    if name in ROLE_REGISTRIES + MODIFIER_REGISTRIES:
                        keys = _frozenset_literal(node.value)
                        if keys is not None:
                            registries[name] = (ctx, node, keys)
                elif isinstance(node, ast.FunctionDef):
                    if node.name.startswith("plan_"):
                        builders.append((ctx, node))
                    elif node.name == "state_specs":
                        for sub in ast.walk(node):
                            if isinstance(sub, ast.Call) and \
                                    isinstance(sub.func, ast.Name) and \
                                    sub.func.id == "SamplerState":
                                spec_calls.append((ctx, sub))
                elif isinstance(node, ast.ClassDef) and \
                        node.name == "SamplerState":
                    fields = [st.target.id for st in node.body
                              if isinstance(st, ast.AnnAssign) and
                              isinstance(st.target, ast.Name)]
                    if fields:
                        state_fields = (ctx, node, fields)

        if registries:
            yield from self._check_registry_shape(registries)
            known = set().union(*(r[2] for r in registries.values()))
            for ctx, fn in builders:
                yield from self._check_builder(ctx, fn, known)
        if state_fields and spec_calls:
            yield from self._check_state_specs(state_fields, spec_calls)

    # ---------------------------------------------------------- registries
    def _check_registry_shape(self, registries) -> Iterable[Violation]:
        primaries = [(n, *registries[n]) for n in ROLE_REGISTRIES
                     if n in registries]
        for i, (na, ctxa, nodea, a) in enumerate(primaries):
            for nb, ctxb, nodeb, b in primaries[i + 1:]:
                overlap = a & b
                if overlap:
                    yield self.violation(
                        ctxb, nodeb, f"key(s) {sorted(overlap)} appear in "
                        f"both {na} and {nb}: the leaf role is ambiguous")
        primary_union = set().union(*(p[3] for p in primaries)) \
            if primaries else set()
        for name in MODIFIER_REGISTRIES:
            if name in registries:
                ctx, node, keys = registries[name]
                stray = keys - primary_union
                if stray:
                    yield self.violation(
                        ctx, node, f"modifier registry {name} names key(s) "
                        f"{sorted(stray)} that no primary registry "
                        "classifies -- they would never match")

    # ------------------------------------------------------------ builders
    def _check_builder(self, ctx, fn: ast.FunctionDef,
                       known: set) -> Iterable[Violation]:
        coeff_names = {"coeffs"}
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and \
                    node.func.id == "_mk" and len(node.args) >= 2 and \
                    isinstance(node.args[1], ast.Name):
                coeff_names.add(node.args[1].id)

        def keys_of(d: ast.Dict):
            for k in d.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    yield k.value, k

        found: list[tuple[str, ast.AST]] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Dict) and any(
                        isinstance(t, ast.Name) and t.id in coeff_names
                        for t in node.targets):
                found.extend(keys_of(node.value))
            elif isinstance(node, ast.Call):
                func = node.func
                if isinstance(func, ast.Name) and func.id == "_mk" and \
                        len(node.args) >= 2 and \
                        isinstance(node.args[1], ast.Dict):
                    found.extend(keys_of(node.args[1]))
                elif isinstance(func, ast.Attribute) and \
                        func.attr == "update" and \
                        isinstance(func.value, ast.Name) and \
                        func.value.id in coeff_names:
                    for kw in node.keywords:
                        if kw.arg:
                            found.append((kw.arg, node))
                    for arg in node.args:
                        if isinstance(arg, ast.Dict):
                            found.extend(keys_of(arg))
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id in coeff_names and \
                            isinstance(t.slice, ast.Constant) and \
                            isinstance(t.slice.value, str):
                        found.append((t.slice.value, t))
        for key, node in found:
            if key not in known:
                yield self.violation(
                    ctx, node, f"coefficient key '{key}' built by "
                    f"`{fn.name}` is in no role registry -- register it in "
                    f"{' / '.join(ROLE_REGISTRIES)} "
                    "so _leaf_role and the sharding specs classify it")

    # --------------------------------------------------------- state specs
    def _check_state_specs(self, state_fields, spec_calls
                           ) -> Iterable[Violation]:
        _, _, fields = state_fields
        for ctx, call in spec_calls:
            covered = set(f for f, _ in zip(fields, call.args))
            covered |= {kw.arg for kw in call.keywords if kw.arg}
            missing = [f for f in fields if f not in covered]
            unknown = sorted(covered - set(fields))
            if missing:
                yield self.violation(
                    ctx, call, "state_specs' SamplerState(...) misses "
                    f"field(s) {missing}: a new SamplerState field needs a "
                    "sharding spec or it silently replicates")
            if unknown:
                yield self.violation(
                    ctx, call, f"state_specs names unknown SamplerState "
                    f"field(s) {unknown}")
