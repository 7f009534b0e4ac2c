"""RL002 -- rebuild-hazard lint for the port's executors and kernels.

The counterpart of ``repro.analysis.recompile``, which guards every
``jax.jit`` call site. The port compiles nothing per call: the serving
engine caches one plain callable per ``(signature, batch, seq_len, mesh)``
(``DiffusionServeEngine._executor``) and the Triton kernel is built once,
at its first launch (``kernels/deis_step._build``). Warm serving traffic
must converge to that fixed set (a warm replay adds no executor); these
are the static hazards that silently break it:

* f-strings or unsorted ``.items()`` iteration in a key of a
  ``*cache*``/``*compiled*``/``*executor*`` mapping -- stored, looked up
  (``[]``, ``in``, ``.get``/``.setdefault``/``.pop``), or built into a
  local name first (``key_ = (...)``; ``cache[key_]``) -- formatting
  collapses distinct dtypes/values into one key, and dict order makes
  equal plans miss;
* a build inside a ``for``/``while`` loop or a comprehension: ``triton.jit`` (decorator or
  call), ``torch.compile``, ``torch.jit.script``/``trace`` or
  ``torch.cuda.make_graphed_callables`` -- a fresh kernel (and compile)
  per iteration -- or a lambda / local def stored into an executor cache
  -- a fresh executor per iteration, so the cache never hits;
* a function so built or cached whose free variables include an enclosing
  loop's target -- the value is captured when the function is made and
  goes stale on later iterations (pass it as an argument instead).

The lazy ``@triton.jit`` inside a function that runs once, its result kept
in a module global, is the good pattern: no loop encloses it.
"""
from __future__ import annotations

import ast
import re
from typing import Iterable, Optional, Sequence

from .base import (Checker, FileContext, Violation, dotted, free_names,
                   import_aliases, resolve)

_CACHE_NAME = re.compile(r"cache|compiled|executor", re.IGNORECASE)
_BUILDERS = ("triton.jit", "torch.compile", "torch.jit.script",
             "torch.jit.trace", "torch.cuda.make_graphed_callables")
_KEY_METHODS = ("get", "setdefault", "pop")


class RecompileChecker(Checker):
    rule = "RL002"
    title = "rebuild-hazard lint (kernel and executor builds, executor-cache keys)"

    def check(self, ctxs: Sequence[FileContext]) -> Iterable[Violation]:
        for ctx in ctxs:
            if ctx.tree is not None:
                yield from _BuildScan(self, ctx).run()


def _local_values(scope) -> dict:
    """Name -> the expressions assigned to it in ``scope`` (a def or the
    module), nested defs and classes excluded."""
    out: dict[str, list] = {}
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, []).append(node.value)
        stack.extend(ast.iter_child_nodes(node))
    return out


class _BuildScan(ast.NodeVisitor):
    def __init__(self, checker: RecompileChecker, ctx: FileContext):
        self.checker = checker
        self.ctx = ctx
        self.aliases = import_aliases(ctx.tree)
        self.loops: list[ast.AST] = []          # enclosing loop stack
        self.loop_targets: list[set] = []       # their target names
        self.scopes: list[dict] = [{}]          # name -> FunctionDef
        self.values: list[dict] = [_local_values(ctx.tree)]
        self.out: list[Violation] = []
        self._seen: set = set()
        self._decorators: set = set()           # ids: checked with their def

    def run(self) -> list[Violation]:
        self.visit(self.ctx.tree)
        return self.out

    def _flag(self, node, msg: str) -> None:
        v = self.checker.violation(self.ctx, node, msg)
        if (v.line, v.col, msg) not in self._seen:   # a key used many times
            self._seen.add((v.line, v.col, msg))
            self.out.append(v)

    # ---------------------------------------------------------- structure
    def visit_FunctionDef(self, node) -> None:
        self.scopes[-1][node.name] = node
        if any(self._is_builder(d) for d in node.decorator_list):
            self._check_build(node, node, "a decorated def")
        self._decorators |= {id(d) for d in node.decorator_list}
        self.scopes.append({})
        self.values.append(_local_values(node))
        loops, targets = self.loops, self.loop_targets
        self.loops, self.loop_targets = [], []   # loops don't cross scopes
        self.generic_visit(node)
        self.loops, self.loop_targets = loops, targets
        self.values.pop()
        self.scopes.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _visit_loop(self, node, targets: set) -> None:
        self.loops.append(node)
        self.loop_targets.append(targets)
        self.generic_visit(node)
        self.loops.pop()
        self.loop_targets.pop()

    def visit_For(self, node: ast.For) -> None:
        names = {n.id for n in ast.walk(node.target)
                 if isinstance(n, ast.Name)}
        self._visit_loop(node, names)

    visit_AsyncFor = visit_For

    def visit_While(self, node: ast.While) -> None:
        self._visit_loop(node, set())

    def visit_ListComp(self, node) -> None:
        self._visit_loop(node, {n.id for g in node.generators
                                for n in ast.walk(g.target)
                                if isinstance(n, ast.Name)})

    visit_SetComp = visit_DictComp = visit_GeneratorExp = visit_ListComp

    # ------------------------------------------------------------- builds
    def _builder_name(self, node) -> Optional[str]:
        name = resolve(dotted(node), self.aliases)
        return name if name in _BUILDERS else None

    def _is_builder(self, dec) -> bool:
        """``@triton.jit``, ``@triton.jit(...)``, ``@torch.compile(...)``,
        ``@functools.partial(torch.compile, ...)``."""
        if self._builder_name(dec):
            return True
        if isinstance(dec, ast.Call):
            if self._builder_name(dec.func):
                return True
            return resolve(dotted(dec.func), self.aliases) == \
                "functools.partial" and bool(dec.args) and \
                bool(self._builder_name(dec.args[0]))
        return False

    def _resolve_def(self, target: Optional[ast.AST]):
        if isinstance(target, ast.Name):
            for scope in reversed(self.scopes):
                if target.id in scope:
                    return scope[target.id]
        return None

    def _check_build(self, node, fn, what: str) -> None:
        """A kernel or executor made at ``node`` from ``fn`` (a def, a
        lambda, or None when it cannot be resolved)."""
        if self.loops:
            self._flag(node, f"{what} built inside a loop: a fresh kernel or "
                             "executor (and its compile) per iteration -- "
                             "hoist the build or key an executor cache")
        if fn is not None and self.loop_targets:
            leaked = free_names(fn) & set().union(*self.loop_targets)
            if leaked:
                self._flag(node, "built function closes over loop "
                                 f"variable(s) {sorted(leaked)}: the value "
                                 "is captured when it is made and goes stale "
                                 "(pass it as an argument instead)")

    def visit_Call(self, node: ast.Call) -> None:
        name = self._builder_name(node.func)
        if name is None and resolve(dotted(node.func), self.aliases) == \
                "functools.partial" and node.args:
            name = self._builder_name(node.args[0])
            target = node.args[1] if len(node.args) > 1 else None
        else:
            target = node.args[0] if node.args else None
        if name is not None and id(node) not in self._decorators:
            fn = target if isinstance(target, ast.Lambda) else \
                self._resolve_def(target)
            self._check_build(node, fn, f"`{name}`")
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _KEY_METHODS and node.args:
            self._key_hazards(node.func.value, node.args[0])
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if isinstance(t, ast.Subscript) and \
                    _CACHE_NAME.search(dotted(t.value) or ""):
                value = node.value
                fn = value if isinstance(value, ast.Lambda) else \
                    self._resolve_def(value)
                if fn is not None:
                    self._check_build(node, fn, "a cached executor")
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        self._key_hazards(node.value, node.slice)
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        left = node.left
        for op, right in zip(node.ops, node.comparators):
            if isinstance(op, (ast.In, ast.NotIn)):
                self._key_hazards(right, left)
            left = right
        self.generic_visit(node)

    # --------------------------------------------------------- cache keys
    def _key_exprs(self, key: ast.AST) -> list:
        """The key expression, or what was assigned to a local key name."""
        if isinstance(key, ast.Name):
            for scope in reversed(self.values):
                if key.id in scope:
                    return scope[key.id]
        return [key]

    def _key_hazards(self, container: ast.AST, key: ast.AST) -> None:
        cname = dotted(container) or ""
        if not _CACHE_NAME.search(cname):
            return
        for expr in self._key_exprs(key):
            for sub in ast.walk(expr):
                if isinstance(sub, ast.JoinedStr):
                    self._flag(sub, f"f-string in executor-cache key of "
                                    f"`{cname}`: formatting collapses distinct "
                                    "dtypes/shapes into one key -- use a tuple")
                    break
            has_items = any(isinstance(s, ast.Call) and
                            isinstance(s.func, ast.Attribute) and
                            s.func.attr == "items" for s in ast.walk(expr))
            has_sorted = any(isinstance(s, ast.Call) and
                             dotted(s.func) == "sorted" for s in ast.walk(expr))
            if has_items and not has_sorted:
                self._flag(expr, f"dict-order hazard in executor-cache key of "
                                 f"`{cname}`: `.items()` iteration order is "
                                 "insertion order -- wrap in sorted()")
