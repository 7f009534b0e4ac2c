"""K1 (``fused_ab_kernel``) against its bound: the least time of each of the
window's launches (bytes of the one-shot call's shape, chipbench.bounds.
k1_bytes, at 3.35 TB/s) summed, over the launches' device time summed."""
LAYER = "K1 deis_step"
UNIT = "%"
MOVES = {"batch": "tokens_per_s"}   # by variant
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or ctx.kind != "oneshot":
        return None
    t, n = ctx.trace.time_of(r"fused_ab_kernel")
    if not n or t <= 0:
        return None
    plan = ctx.quadrature.make_plan(ctx.mix["solver"], int(ctx.mix["nfe"]))
    rows = int(ctx.mix["batch"]) * int(ctx.mix["seq_len"])
    per = ctx.bounds.bound_s(ctx.bounds.k1_bytes(1, rows, ctx.model["d_model"],
                                                 ctx.quadrature.history_len(plan)), 0.0)
    return per * n / t * 100.0
