"""RL003 -- serving lock-discipline checker (a lightweight race detector;
the reference's ``repro.analysis.locks`` over the port's ownership table).

The serving stack has exactly one threading contract (driver module
docstring): ONE scheduler thread owns the engine and the card (it sets the
device, runs every tick and, under a mesh, makes every collective);
transport threads only enqueue and wait on futures. ``config.OWNERSHIP`` turns that prose
into a table -- every attribute of ``DiffusionServeEngine`` /
``ServeDriver`` / ``MetricsRegistry`` is declared config (immutable),
scheduler-thread-only, lock-protected, or atomic -- and this checker
enforces it structurally:

* every method is classified *transport* (reachable from the public
  thread-safe entry points, through self-calls and the driver->engine
  delegate edge) and/or *scheduler* (reachable from the tick loop);
* an access to a ``scheduler`` attribute from a transport-reachable method
  is a data race with the tick loop -> violation;
* any access to a ``locked`` attribute outside a ``with self.<lock>:``
  block (anywhere but ``__init__``) -> violation;
* a ``config`` attribute reassigned outside ``__init__`` -> violation;
* an attribute assigned anywhere in the class but missing from the table
  -> violation, so the table can never silently rot.

``__init__`` is exempt from context rules: construction happens-before the
scheduler thread exists. A store is a direct ``self.<attr> = ...``: the
``self.engine`` in ``self.engine._x = ...`` is a read of the delegate.
"""
from __future__ import annotations

import ast
import fnmatch
from typing import Iterable, Optional, Sequence

from .base import Checker, FileContext, Violation
from .config import OWNERSHIP, Ownership

_METHOD_TYPES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _classify(spec: Ownership, attr: str) -> Optional[str]:
    for bucket in ("config", "scheduler", "locked", "atomic"):
        if any(fnmatch.fnmatch(attr, pat) for pat in getattr(spec, bucket)):
            return bucket
    return None


class _Class:
    """One ownership-tabled class found in the target set."""

    def __init__(self, ctx: FileContext, node: ast.ClassDef, spec: Ownership):
        self.ctx = ctx
        self.node = node
        self.spec = spec
        self.methods = {n.name: n for n in node.body
                        if isinstance(n, _METHOD_TYPES)}
        self.contexts: dict[str, set] = {m: set() for m in self.methods}

    def entry_methods(self, names: tuple) -> list:
        if "*" in names:
            return list(self.methods)
        return [n for n in names if n in self.methods]


class LockDisciplineChecker(Checker):
    rule = "RL003"
    title = "serving lock discipline (ownership table vs method call graphs)"

    def check(self, ctxs: Sequence[FileContext]) -> Iterable[Violation]:
        classes: dict[str, _Class] = {}
        for ctx in ctxs:
            if ctx.tree is None:
                continue
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.ClassDef) and node.name in OWNERSHIP:
                    classes[node.name] = _Class(ctx, node, OWNERSHIP[node.name])
        if not classes:
            return
        self._propagate_contexts(classes)
        for cls in classes.values():
            yield from self._check_class(cls, classes)

    # -------------------------------------------------- context propagation
    def _propagate_contexts(self, classes: dict) -> None:
        work: list[tuple[str, str, str]] = []
        for name, cls in classes.items():
            for m in cls.entry_methods(cls.spec.transport_entries):
                work.append((name, m, "transport"))
            for m in cls.entry_methods(cls.spec.scheduler_entries):
                work.append((name, m, "scheduler"))
        while work:
            cname, meth, tag = work.pop()
            cls = classes[cname]
            if meth not in cls.methods or tag in cls.contexts[meth]:
                continue
            # Declared entry points PIN their context: a reference like
            # ``threading.Thread(target=self._run)`` inside a transport
            # method is the thread boundary itself, not a transport call
            # into the scheduler loop.
            if (meth in cls.spec.scheduler_entries and tag != "scheduler") \
                    or (meth in cls.spec.transport_entries and
                        tag != "transport"):
                continue
            cls.contexts[meth].add(tag)
            for tgt_cls, tgt_meth in self._edges(cls, cls.methods[meth],
                                                 classes):
                work.append((tgt_cls, tgt_meth, tag))

    def _edges(self, cls: _Class, fn, classes: dict):
        """(class, method) references made by ``fn``: self-calls, property
        reads, and delegate-object member references."""
        delegate_aliases = self._delegate_aliases(cls, fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Attribute):
                continue
            base = node.value
            if isinstance(base, ast.Name) and base.id == "self":
                if node.attr in cls.methods:
                    yield cls.node.name, node.attr
                elif node.attr in cls.spec.delegates:
                    pass  # handled via the chained-attribute case below
            # self.<delegate>.member  or  alias.member
            target_cls = None
            if isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "self" and \
                    base.attr in cls.spec.delegates:
                target_cls = cls.spec.delegates[base.attr]
            elif isinstance(base, ast.Name) and base.id in delegate_aliases:
                target_cls = delegate_aliases[base.id]
            if target_cls and target_cls in classes and \
                    node.attr in classes[target_cls].methods:
                yield target_cls, node.attr

    def _delegate_aliases(self, cls: _Class, fn) -> dict:
        """Local names bound to a delegate object (``eng = self.engine``)."""
        out: dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Attribute) and \
                    isinstance(node.value.value, ast.Name) and \
                    node.value.value.id == "self" and \
                    node.value.attr in cls.spec.delegates:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = cls.spec.delegates[node.value.attr]
        return out

    # ------------------------------------------------------------ checking
    def _check_class(self, cls: _Class, classes: dict) -> Iterable[Violation]:
        seen_unclassified: set = set()
        for name, fn in cls.methods.items():
            yield from self._check_method(cls, name, fn, classes,
                                          seen_unclassified)

    def _check_method(self, cls: _Class, name: str, fn, classes: dict,
                      seen_unclassified: set) -> Iterable[Violation]:
        spec = cls.spec
        ctx = cls.ctx
        in_init = name == "__init__"
        transport = "transport" in cls.contexts[name]
        delegate_aliases = self._delegate_aliases(cls, fn)

        def walk(node, locked: bool, stored: set):
            if isinstance(node, ast.With):
                holds = locked or any(
                    isinstance(it.context_expr, ast.Attribute) and
                    isinstance(it.context_expr.value, ast.Name) and
                    it.context_expr.value.id == "self" and
                    it.context_expr.attr == spec.lock
                    for it in node.items)
                for it in node.items:
                    yield from walk(it.context_expr, locked, stored)
                for st in node.body:
                    yield from walk(st, holds, stored)
                return
            if isinstance(node, ast.Attribute):
                yield from check_attr(node, cls, spec, locked, stored)
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Attribute) and \
                                isinstance(sub.ctx, ast.Store) and \
                                isinstance(sub.value, ast.Name) and \
                                sub.value.id == "self":
                            stored.add(sub.attr)
                            yield from check_store(sub)
            for child in ast.iter_child_nodes(node):
                yield from walk(child, locked, stored)

        def check_store(node: ast.Attribute):
            attr = node.attr
            bucket = _classify(cls.spec, attr)
            if bucket is None and attr not in cls.methods and \
                    attr not in seen_unclassified:
                seen_unclassified.add(attr)
                yield self.violation(
                    ctx, node, f"`{cls.node.name}.{attr}` is not in the "
                    "ownership table: declare it config / scheduler / "
                    "locked / atomic in repro_torch.analysis.config.OWNERSHIP")
            if bucket == "config" and not in_init:
                yield self.violation(
                    ctx, node, f"config attribute `{attr}` reassigned in "
                    f"`{name}` -- config is immutable after __init__")

        def check_attr(node: ast.Attribute, owner: _Class, owner_spec,
                       locked: bool, stored: set):
            base = node.value
            target_cls = None
            if isinstance(base, ast.Name) and base.id == "self" and \
                    owner is cls:
                target_cls, target_spec = owner, owner_spec
            elif isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "self" and \
                    base.attr in spec.delegates and \
                    spec.delegates[base.attr] in classes:
                target_cls = classes[spec.delegates[base.attr]]
                target_spec = target_cls.spec
            elif isinstance(base, ast.Name) and base.id in delegate_aliases \
                    and delegate_aliases[base.id] in classes:
                target_cls = classes[delegate_aliases[base.id]]
                target_spec = target_cls.spec
            if target_cls is None:
                return
            attr = node.attr
            if attr in target_cls.methods:
                return
            bucket = _classify(target_spec, attr)
            if bucket == "locked" and not (locked and target_cls is cls) \
                    and not in_init:
                lock = target_spec.lock or "<lock>"
                where = f"`{target_cls.node.name}.{attr}`"
                yield self.violation(
                    ctx, node, f"lock-protected {where} accessed outside "
                    f"`with self.{lock}:` in `{cls.node.name}.{name}` -- "
                    "racy against the other side of the lock")
            elif bucket == "scheduler" and transport and not in_init:
                yield self.violation(
                    ctx, node, f"scheduler-thread-only "
                    f"`{target_cls.node.name}.{attr}` accessed from "
                    f"transport-reachable `{cls.node.name}.{name}` -- "
                    "races the tick loop")

        yield from walk(fn, False, set())
