"""repro_torch.analysis -- the PyTorch port's own static analyzer.

The counterpart of ``repro.analysis``: the same five AST-based checkers
(stdlib ``ast``, no third-party deps; it parses the port's source and
imports none of it, so it needs neither torch nor JAX), the same rule ids,
``allow`` syntax and CLI, each rule restated for the port's idioms:

* **RL001** host-sync lint: no ``.item()`` / ``.cpu()`` / ``.to("cpu")`` /
  ``.numpy()`` / ``.tolist()`` / ``synchronize()`` / ``np.asarray`` /
  scalar coercions / tensor-valued branches / ``print`` inside the solver
  hot path (sampler, plan splice primitives, kernels, the engine tick
  path, the obs fast path).
* **RL002** rebuild-hazard lint: ``triton.jit`` / ``torch.compile`` or a
  cached executor built inside a loop, loop-variable closure capture,
  f-string / dict-order executor-cache keys.
* **RL003** serving lock discipline: the driver/engine/registry threading
  contract as an ownership table, enforced over method call graphs.
* **RL004** plan-leaf guard: coefficient keys built by ``plan_*`` builders
  must be classifiable by ``core/plan``'s leaf-role registries and the
  sharding specs must cover every ``SamplerState`` field.
* **RL005** kernel-routing guard: no ``device`` parameter defaults to the
  CPU, and no kernel wrapper's ``except`` falls back to the plain version
  or swallows the kernel's error.

Run ``python -m repro_torch.analysis`` (default target: this package's own
directory). Suppress an intentional site with ``# repro: allow[RULE]
<one-line justification>``; one comment serves both analyzers.
"""
from .base import Checker, FileContext, Violation
from .cli import CHECKERS, RULES, Report, analyze, main, write_bench

__all__ = ["Checker", "FileContext", "Violation", "CHECKERS", "RULES",
           "Report", "analyze", "main", "write_bench"]
