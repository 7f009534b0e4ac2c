"""Device busy time of the traced window less K1's, per 1000 real
(unpadded) token-NFEs finished in it: what the eps-network (and the
sampler's own small operations) cost the device per unit of useful work."""
LAYER = "eps-net"
UNIT = "ms"
MOVES = {"batch": "tokens_per_s", "served": "served_tokens_per_s"}   # by variant
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None:
        return None
    tok_nfe, _ = ctx.work(traced=True)
    if not tok_nfe:
        return None
    k1, _ = ctx.trace.time_of(r"fused_ab_kernel")
    return (ctx.trace.busy_s - k1) * 1e3 / (tok_nfe / 1000.0)
