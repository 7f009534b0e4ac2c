"""Known-bad RL002 fixture: every rebuild hazard the checker knows."""
import torch
import triton


def make_kernels(fns, spec):
    executors = {}
    for i, fn in enumerate(fns):
        @triton.jit
        def kernel(x_ptr):
            fn(x_ptr)

        executors[f"fn{i}"] = lambda x: fn(x) * i
    return executors, torch.compile(kernel)


def compile_each(fns):
    return [torch.compile(fn) for fn in fns] + [triton.jit(f) for f in fns]


def lookup(compiled, spec):
    key_ = tuple(spec.items())
    return compiled[key_] if key_ in compiled else None
