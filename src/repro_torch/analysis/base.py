"""Shared machinery for :mod:`repro_torch.analysis` -- violations,
suppression comments, file contexts, and the checker plugin protocol (a
copy of ``repro.analysis.base``: the port imports nothing of the JAX
package).

Everything is stdlib-``ast`` based: checkers receive parsed
:class:`FileContext` objects (one per target file) and yield
:class:`Violation` records. Suppression is per-rule and per-line::

    v = t.cpu()  # repro: allow[RL001] boundary read, the step is already done

A matching ``# repro: allow[RULE]`` on the violation's line (or in the
contiguous comment block directly above it) marks it ``allowed``: it is
reported (and counted in the JSON/bench output) but does not fail the run.
The comment forms are the reference analyzer's letter for letter, so one
``allow`` comment serves both analyzers. File-level directives use the same
namespace -- ``# repro: hot-path`` opts a whole file into the RL001 hot-path
scope (used by the test fixtures).
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Iterable, Optional, Sequence

_ALLOW = re.compile(r"#\s*repro:\s*allow\[([A-Za-z0-9_,\s]+)\]")
_DIRECTIVE = re.compile(r"#\s*repro:\s*(hot-path)\b")


def _comments(src: str) -> list[tuple[int, str]]:
    """(line, text) of every real comment token -- so a docstring that merely
    *mentions* ``# repro: hot-path`` cannot trigger the directive."""
    out: list[tuple[int, str]] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                out.append((tok.start[0], tok.string))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return out


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: where, which rule, what went wrong."""
    rule: str
    path: str
    line: int
    col: int
    message: str
    allowed: bool = False

    def format(self) -> str:
        mark = "  [allowed]" if self.allowed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"{self.message}{mark}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class FileContext:
    """A parsed target file plus its suppression/directive comments."""

    def __init__(self, path: str, src: str, tree: Optional[ast.Module],
                 error: Optional[SyntaxError] = None):
        self.path = path
        self.src = src
        self.tree = tree
        self.error = error
        self.lines = src.splitlines()
        self.allows: dict[int, set[str]] = {}
        self.directives: set[str] = set()
        for lineno, text in _comments(src):
            m = _ALLOW.search(text)
            if m:
                self.allows[lineno] = {r.strip() for r in
                                       m.group(1).split(",") if r.strip()}
            d = _DIRECTIVE.search(text)
            if d:
                self.directives.add(d.group(1))

    @classmethod
    def from_path(cls, path: Path) -> "FileContext":
        src = path.read_text()
        label = str(path)
        try:
            tree = ast.parse(src, filename=label)
        except SyntaxError as e:
            return cls(label, src, None, error=e)
        return cls(label, src, tree)

    @property
    def posix(self) -> str:
        return self.path.replace("\\", "/")

    def allowed(self, rule: str, line: int) -> bool:
        """True when ``line`` carries a matching ``# repro: allow[rule]``
        comment, or one appears in the contiguous comment block directly
        above it (multi-line justifications are encouraged)."""
        if rule in self.allows.get(line, ()):
            return True
        ln = line - 1
        while 1 <= ln <= len(self.lines):
            if not self.lines[ln - 1].lstrip().startswith("#"):
                return False
            if rule in self.allows.get(ln, ()):
                return True
            ln -= 1
        return False


class Checker:
    """Plugin protocol: subclass, set ``rule``/``title``, implement
    :meth:`check` over the whole target set (cross-file rules like RL003/
    RL004 need every file at once; per-file rules just iterate)."""

    rule: str = "RL000"
    title: str = ""

    def check(self, ctxs: Sequence[FileContext]) -> Iterable[Violation]:
        raise NotImplementedError

    def violation(self, ctx: FileContext, node, message: str) -> Violation:
        line = node if isinstance(node, int) else node.lineno
        col = 0 if isinstance(node, int) else node.col_offset
        return Violation(self.rule, ctx.path, line, col, message,
                         allowed=ctx.allowed(self.rule, line))


# --------------------------------------------------------------- AST helpers
def dotted(node: ast.AST) -> Optional[str]:
    """``'torch.cuda.synchronize'`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def import_aliases(tree: ast.Module) -> dict[str, str]:
    """Local name -> dotted module it binds (``F`` -> ``torch.nn.functional``)."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    out[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def resolve(name: Optional[str], aliases: dict[str, str]) -> Optional[str]:
    """Rewrite the first segment of a dotted name through the import map."""
    if name is None:
        return None
    head, _, rest = name.partition(".")
    head = aliases.get(head, head)
    return f"{head}.{rest}" if rest else head


def default_args(fn) -> dict:
    """Parameter name -> default expression of a def (or lambda)."""
    args = fn.args
    out = dict(zip([a.arg for a in args.args[-len(args.defaults):]],
                   args.defaults)) if args.defaults else {}
    out.update({a.arg: d for a, d in zip(args.kwonlyargs, args.kw_defaults) if d})
    return out


def free_names(fn) -> set:
    """Names a def or lambda reads but does not bind (approximate closure
    capture)."""
    bound = {a.arg for a in (fn.args.args + fn.args.kwonlyargs +
                             fn.args.posonlyargs)}
    if fn.args.vararg:
        bound.add(fn.args.vararg.arg)
    if fn.args.kwarg:
        bound.add(fn.args.kwarg.arg)
    loads, stores = set(), set(bound)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load):
                loads.add(node.id)
            else:
                stores.add(node.id)
    return loads - stores
