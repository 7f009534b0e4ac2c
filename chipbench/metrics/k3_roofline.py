"""K3 (``ssd_scan`` kernels) against its bound: the least time of each of the
window's launches (bytes and operations of the one-shot call's shape,
chipbench.bounds.k3_work, at 3.35 TB/s and 989 TFLOP/s) summed, over the
launches' device time summed."""
LAYER = "K3 ssd_scan"
UNIT = "%"
MOVES = {"batch": "tokens_per_s"}   # by variant
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or ctx.kind != "oneshot" or "ssm" not in ctx.model:
        return None
    t, n = ctx.trace.time_of(r"ssd_scan")
    if not n or t <= 0:
        return None
    s = ctx.model["ssm"]
    d_in = s["expand"] * ctx.model["d_model"]
    nbytes, flops = ctx.bounds.k3_work(int(ctx.mix["batch"]), int(ctx.mix["seq_len"]),
                                       d_in // s["head_dim"], s["head_dim"], s["state_dim"],
                                       s["chunk_size"])
    return ctx.bounds.bound_s(nbytes, flops) * n / t * 100.0
