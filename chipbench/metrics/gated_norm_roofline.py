"""The SSM mixer's ``post`` pass (``ssm_gated_norm_kernel``, either order of
gate and norm) against its bound: the least time of each of the window's
launches, summed, over the launches' device time summed. A launch's bound
is its bytes at 3.35 TB/s: y, xh and z read once and the output written
once, four planes of B S d_inner in the model's dtype (D and the norm's
scale, a few KB, left out)."""
LAYER = "SSM mixer"
UNIT = "%"
MOVES = {"batch": "tokens_per_s"}   # by variant
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or ctx.kind != "oneshot" or "ssm" not in ctx.model:
        return None
    t, n = ctx.trace.time_of(r"ssm_gated_norm_kernel")
    if not n or t <= 0:
        return None
    m = ctx.model
    elem = 2 if m.get("dtype", "bfloat16") == "bfloat16" else 4
    d_inner = m["ssm"]["expand"] * m["d_model"]
    nbytes = 4 * elem * int(ctx.mix["batch"]) * int(ctx.mix["seq_len"]) * d_inner
    return ctx.bounds.bound_s(nbytes, 0.0) * n / t * 100.0
