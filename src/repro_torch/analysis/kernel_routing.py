"""RL005 -- kernel-routing guard: nothing falls back silently to the plain
version or to the CPU.

The port's counterpart of ``repro.analysis.interpret_default``. There the
bug class was a Pallas wrapper defaulting ``interpret=True``: it shipped,
and silently ran the interpreter on hardware that could compile the
kernel. The port has no interpreter; its routing rule is
``kernels/runtime.py``'s: a CUDA tensor launches the hand-written kernel
(it launches, or the call raises), a CPU tensor takes the plain version,
and an entry point runs on the card unless the caller asks for the CPU
(``device=None`` resolves through ``device.resolve_device``, which raises
without a card). The same bug class there is a quiet fallback, so:

* (a) no parameter named ``device`` defaults to a literal ``"cpu"`` or
  ``torch.device("cpu")``: the caller who forgets the argument would run
  on the CPU without a word (default ``None``);
* (b) in ``kernels/*.py``, no ``except`` handler calls a plain version
  (``*_ref(...)``, ``ref.*(...)``) or ends without raising: a kernel that
  fails to build or launch must fail the call, not hand back the plain
  version's answer in its place.
"""
from __future__ import annotations

import ast
import re
from typing import Iterable, Sequence

from . import config
from .base import (Checker, FileContext, Violation, default_args, dotted,
                   import_aliases, resolve)


def _is_cpu_literal(node, aliases: dict) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cpu")
    return isinstance(node, ast.Call) and \
        resolve(dotted(node.func), aliases) == "torch.device" and \
        bool(node.args) and _is_cpu_literal(node.args[0], aliases)


def _plain_call(handler: ast.ExceptHandler):
    """The first call of a plain version inside ``handler``, or None."""
    for sub in ast.walk(handler):
        if isinstance(sub, ast.Call):
            name = dotted(sub.func) or ""
            if name.endswith("_ref") or name.startswith("ref."):
                return sub
    return None


class KernelRoutingChecker(Checker):
    rule = "RL005"
    title = "kernel routing (no CPU device default, no silent plain-version fallback)"

    def check(self, ctxs: Sequence[FileContext]) -> Iterable[Violation]:
        for ctx in ctxs:
            if ctx.tree is None:
                continue
            aliases = import_aliases(ctx.tree)
            for node in ast.walk(ctx.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    dflt = default_args(node).get("device")
                    if dflt is not None and _is_cpu_literal(dflt, aliases):
                        what = getattr(node, "name", "lambda")
                        yield self.violation(
                            ctx, dflt, f"`{what}` defaults `device` to the "
                            "CPU: a caller who omits it runs on the CPU "
                            "without a word -- default None and resolve "
                            "through device.resolve_device")
            if re.search(config.KERNEL_SCOPE, ctx.posix):
                yield from self._check_handlers(ctx)

    def _check_handlers(self, ctx: FileContext) -> Iterable[Violation]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            plain = _plain_call(node)
            if plain is not None:
                yield self.violation(
                    ctx, node, f"`except` falls back to the plain version "
                    f"(`{dotted(plain.func)}`): a kernel that fails must "
                    "fail the call, not answer with the plain version")
            elif not any(isinstance(s, ast.Raise) for s in ast.walk(node)):
                yield self.violation(
                    ctx, node, "`except` in a kernel wrapper ends without "
                    "raising: the kernel's failure is swallowed -- re-raise "
                    "(or raise a clearer error from it)")
