"""Known-good RL002 fixture: the kernel built once at first launch and kept,
tuple executor-cache keys, sorted dict iteration, a cached executor made
outside any loop."""
_kernel = None


def _build():
    global _kernel
    if _kernel is None:
        import triton

        @triton.jit
        def kernel(x_ptr, n, BLK: "tl.constexpr"):
            for j in range(BLK):
                x_ptr += j

        _kernel = kernel
    return _kernel


def executor(compiled, sig, batch, seq_len, step):
    key_ = (sig, batch, seq_len)
    if key_ not in compiled:
        def run(params, plan, k, state):
            return step(params, plan, k, state)
        compiled[key_] = run
    return compiled[key_]


def lookup(compiled, spec):
    return compiled.get(tuple(sorted(spec.items())))
