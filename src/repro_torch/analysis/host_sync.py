"""RL001 -- host-sync lint for the solver hot path, in torch idioms.

DEIS's value proposition is that a 10-NFE solve is ~10 cheap device steps;
one stray host sync per step drains the CUDA stream, idles the card while
the host catches up, and erases the win. Inside the configured hot scopes
(``config.HOT_SCOPES``, or any file carrying a ``# repro: hot-path``
directive) this checker flags:

* ``.item()``, ``.cpu()``, ``.numpy()``, ``.tolist()`` and ``.to("cpu")`` /
  ``.to(torch.device("cpu"))`` / ``.to(device="cpu")`` of a value that is
  not provably host-side -- explicit device->host copies ("sync" group);
* ``torch.cuda.synchronize()`` and ``<stream or event>.synchronize()`` --
  the host waits for the device queue to drain ("sync");
* ``np.asarray`` / ``np.array`` of a value that is not provably host-side
  already -- an implicit copy ("sync");
* ``print(...)`` -- host I/O in the step loop ("sync");
* ``float()`` / ``int()`` / ``bool()`` of a possibly-device value -- each
  is an implicit blocking copy ("coerce");
* ``if``/``while``/``assert``/ternary tests built from ``torch.*`` calls
  or tensor reductions and comparisons (``.any()``, ``.all()``,
  ``.amax()``, ``.eq()``, ...) -- an implicit ``bool()`` of a device value
  ("branch").

A lightweight per-function taint pass tracks names assigned from numpy /
math / time results, from tensor metadata (``.shape``, ``.dtype``,
``.numel()``, ...) and from the boundary reads themselves (``.tolist()``,
``.cpu()``, ``.numpy()``, ``.item()``, ``.to("cpu")``: the read is flagged
once, at its own site, and what it returned is host-side afterwards, as
``jax.device_get``'s result is in ``repro.analysis.host_sync``), so
host-side bookkeeping (the engine coercing an already-fetched error
vector, say) does not get flagged. Deliberate boundary syncs carry
``# repro: allow[RL001]`` with a one-line justification.
"""
from __future__ import annotations

import ast
import re
from typing import Iterable, Sequence

from . import config
from .base import Checker, FileContext, Violation, dotted, import_aliases, resolve

_FETCH_ATTRS = {"item": "device->host scalar copy",
                "cpu": "device->host copy",
                "numpy": "device->host copy (of a CPU tensor: none)",
                "tolist": "device->host copy into Python scalars"}
_COERCIONS = {"float", "int", "bool"}
# call roots whose results are host-side values, for the taint pass
_HOST_ROOTS = ("numpy.", "math.", "time.")
_HOST_BUILTINS = ("len", "sorted", "min", "max", "abs", "range", "enumerate",
                  "sum", "isinstance")
# tensor methods whose result is a device value: in a branch test each is
# an implicit bool() of it
_TENSOR_TESTS = frozenset({
    "any", "all", "sum", "amax", "amin", "max", "min", "mean", "prod",
    "norm", "abs", "count_nonzero", "nonzero", "equal", "allclose",
    "isnan", "isinf", "isfinite", "eq", "ne", "gt", "ge", "lt", "le"})


def _is_cpu(node: ast.AST, aliases: dict) -> bool:
    """``"cpu"`` or ``torch.device("cpu")`` (any ``"cpu..."`` string)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cpu")
    return isinstance(node, ast.Call) and \
        resolve(dotted(node.func), aliases) == "torch.device" and \
        bool(node.args) and _is_cpu(node.args[0], aliases)


def _to_cpu(node: ast.Call, aliases: dict) -> bool:
    """``x.to("cpu", ...)``, ``x.to(torch.device("cpu"))``,
    ``x.to(device="cpu")``."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    args = node.args[:1] + [kw.value for kw in node.keywords
                            if kw.arg == "device"]
    return any(_is_cpu(a, aliases) for a in args)


class HostSyncChecker(Checker):
    rule = "RL001"
    title = "host-sync lint (hot-path modules must not sync or branch on device values)"

    def check(self, ctxs: Sequence[FileContext]) -> Iterable[Violation]:
        for ctx in ctxs:
            if ctx.tree is None:
                continue
            for region, checks in self._regions(ctx):
                yield from _Scan(self, ctx, checks).run(region)

    # ------------------------------------------------------------- scoping
    def _regions(self, ctx: FileContext):
        """Yield (ast node, enabled checks) pairs for the hot regions of
        this file; empty when the file is not hot path."""
        if "hot-path" in ctx.directives:
            yield ctx.tree, config.ALL_CHECKS
            return
        for scope in config.HOT_SCOPES:
            if not re.search(scope.pattern, ctx.posix):
                continue
            if scope.functions is not None:
                wanted = set(scope.functions)
                for node in ast.walk(ctx.tree):
                    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and node.name in wanted:
                        yield node, scope.checks
            elif scope.entry is not None:
                cls_name, entry = scope.entry
                for node in ctx.tree.body:
                    if isinstance(node, ast.ClassDef) and node.name == cls_name:
                        for fn in _reachable(ctx.tree, node, entry):
                            yield fn, scope.checks
            else:
                yield ctx.tree, scope.checks
            return  # first matching scope wins


def _reachable(module: ast.Module, cls: ast.ClassDef, entry: str) -> list:
    """Methods of ``cls`` reachable from ``entry`` via self-references, and
    the module-level functions they (or those functions) call by name."""
    methods = {n.name: n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    funcs = {n.name: n for n in module.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    seen, stack = {("m", entry)}, [("m", entry)]
    while stack:
        kind, name = stack.pop()
        fn = (methods if kind == "m" else funcs).get(name)
        if fn is None:
            continue
        for node in ast.walk(fn):
            ref = None
            if kind == "m" and isinstance(node, ast.Attribute) and \
                    isinstance(node.value, ast.Name) and \
                    node.value.id == "self" and node.attr in methods:
                ref = ("m", node.attr)
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Name) and node.func.id in funcs:
                ref = ("f", node.func.id)
            if ref is not None and ref not in seen:
                seen.add(ref)
                stack.append(ref)
    return [(methods if k == "m" else funcs)[n] for k, n in sorted(seen)
            if n in (methods if k == "m" else funcs)]


class _Scan(ast.NodeVisitor):
    """Walk one hot region, tracking per-function host-taint."""

    def __init__(self, checker: HostSyncChecker, ctx: FileContext,
                 checks: frozenset):
        self.checker = checker
        self.ctx = ctx
        self.checks = checks
        self.aliases = import_aliases(ctx.tree)
        self.taint: list[set] = []   # stack of per-function host-name sets
        self.out: list[Violation] = []

    def run(self, region: ast.AST) -> list[Violation]:
        if isinstance(region, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._visit_function(region)
        else:
            self.visit(region)
        return self.out

    # --------------------------------------------------------------- taint
    def _is_module(self, node: ast.AST) -> bool:
        """A name bound by an import (``np``, ``torch``, ``F``, ...)."""
        return isinstance(node, ast.Name) and node.id in self.aliases

    def _is_fetch(self, node: ast.Call) -> bool:
        """A boundary read: its result is a host value."""
        return (isinstance(node.func, ast.Attribute) and
                node.func.attr in _FETCH_ATTRS) or _to_cpu(node, self.aliases)

    def _is_host(self, node: ast.AST) -> bool:
        """Conservatively true when ``node`` is a host-side value."""
        if isinstance(node, ast.Constant):
            return True
        if isinstance(node, ast.Name):
            return any(node.id in t for t in self.taint)
        if isinstance(node, ast.Attribute):
            return node.attr in config.HOST_SAFE_TENSOR_ATTRS or \
                self._is_host(node.value)
        if isinstance(node, ast.Subscript):
            return self._is_host(node.value)
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and \
                    func.attr in config.HOST_SAFE_TENSOR_METHODS:
                return True
            if self._is_fetch(node):
                return True
            name = resolve(dotted(func), self.aliases)
            if name and (name.startswith(_HOST_ROOTS) or
                         name in _HOST_BUILTINS or
                         self._host_safe_torch(name)):
                return True
            if name in _COERCIONS:
                # float(x) is host-valued only if x already was -- otherwise
                # the coercion is itself the sync and must stay flaggable
                # (e.g. ``k = int(k)`` must not self-taint k).
                return bool(node.args) and self._is_host(node.args[0])
            return False
        if isinstance(node, ast.BinOp):
            return self._is_host(node.left) and self._is_host(node.right)
        if isinstance(node, (ast.Tuple, ast.List)):
            return all(self._is_host(e) for e in node.elts)
        if isinstance(node, ast.Compare):
            return self._is_host(node.left) and \
                all(self._is_host(c) for c in node.comparators)
        if isinstance(node, ast.IfExp):
            return self._is_host(node.body) and self._is_host(node.orelse)
        return False

    @staticmethod
    def _host_safe_torch(name: str) -> bool:
        head, _, rest = name.partition(".")
        return head == "torch" and rest in config.HOST_SAFE_TORCH

    def _taint_function(self, fn) -> set:
        """Forward pass over ``fn``'s own statements (not nested defs)
        collecting names bound to host-side values."""
        host: set[str] = set()
        self.taint.append(host)

        def walk(stmts):
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                    continue
                if isinstance(st, ast.Assign) and self._is_host(st.value):
                    for t in st.targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                host.add(n.id)
                for field in ("body", "orelse", "finalbody"):
                    walk(getattr(st, field, []) or [])
                for h in getattr(st, "handlers", []) or []:
                    walk(h.body)
        walk(fn.body)
        self.taint.pop()
        return host

    # -------------------------------------------------------------- visits
    def _visit_function(self, fn) -> None:
        self.taint.append(self._taint_function(fn))
        for st in fn.body:
            self.visit(st)
        self.taint.pop()

    def visit_FunctionDef(self, node) -> None:
        self._visit_function(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def _flag(self, node, msg: str) -> None:
        self.out.append(self.checker.violation(self.ctx, node, msg))

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if config.SYNC in self.checks:
            self._check_sync(node)
        if config.COERCE in self.checks and isinstance(func, ast.Name) and \
                func.id in _COERCIONS and len(node.args) == 1 and \
                not isinstance(node.args[0], ast.Constant) and \
                not self._is_host(node.args[0]):
            self._flag(node, f"implicit sync: `{func.id}()` of a (possibly) "
                             "device value blocks on the copy")
        self.generic_visit(node)

    def _check_sync(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            recv = func.value
            if func.attr in _FETCH_ATTRS and not self._is_module(recv) and \
                    not self._is_host(recv):
                self._flag(node, f"host sync: `.{func.attr}()` "
                                 f"({_FETCH_ATTRS[func.attr]}) in the hot path")
                return
            if _to_cpu(node, self.aliases) and not self._is_host(recv):
                self._flag(node, "host sync: `.to(cpu)` copies the tensor to "
                                 "the host and waits for it in the hot path")
                return
            if func.attr == "synchronize":
                self._flag(node, f"host sync: `{dotted(func) or '.synchronize'}"
                                 "()` blocks until the device queue drains")
                return
        name = resolve(dotted(func), self.aliases)
        if name in ("numpy.asarray", "numpy.array") and node.args and \
                not self._is_host(node.args[0]) and \
                not _contains_explicit_fetch(node.args[0], self.aliases):
            self._flag(node, "host sync: np.asarray of a (possibly) "
                             "device value copies it to the host")
        if name == "print":
            self._flag(node, "host I/O: print() in the hot path "
                             "(route through obs.Tracer/metrics instead)")

    def _check_test(self, node, test: ast.AST, kind: str) -> None:
        if config.BRANCH not in self.checks:
            return
        for sub in ast.walk(test):
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            name = resolve(dotted(func), self.aliases)
            if name and name.startswith("torch.") and \
                    not self._host_safe_torch(name):
                self._flag(node, f"branch on device value: `{kind}` test "
                                 f"calls `{dotted(func)}` (an implicit "
                                 "bool() waits for the device)")
                return
            if isinstance(func, ast.Attribute) and \
                    func.attr in _TENSOR_TESTS and \
                    not self._is_module(func.value) and \
                    not self._is_host(func.value):
                self._flag(node, f"branch on device value: `{kind}` over "
                                 f"`.{func.attr}()` forces a host bool() "
                                 "(use torch.where or keep the test on "
                                 "host values)")
                return

    def visit_If(self, node: ast.If) -> None:
        self._check_test(node, node.test, "if")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_test(node, node.test, "while")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._check_test(node, node.test, "assert")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._check_test(node, node.test, "ternary")
        self.generic_visit(node)


def _contains_explicit_fetch(node: ast.AST, aliases: dict) -> bool:
    """True when the expression already routes through a boundary read
    (``.cpu()``, ``.numpy()``, ``.tolist()``, ``.item()``, ``.to("cpu")``)
    -- the asarray around it is then host-side bookkeeping, and the read
    itself is the (separately flagged) sync."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and (
                (isinstance(sub.func, ast.Attribute) and
                 sub.func.attr in _FETCH_ATTRS) or _to_cpu(sub, aliases)):
            return True
    return False
