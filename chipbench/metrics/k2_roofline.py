"""K2 (``flash_fwd`` kernels) against its bound: the least time of each of
the window's launches, summed, over the launches' device time summed. A
launch's bound is the one-shot call's attention at the model's head counts:
q, k and v read once and the output written once (bytes), 4 B H S^2 D
operations (bidirectional, S capped by a sliding window), at 3.35 TB/s or
989 TFLOP/s (float32: 165, three TF32 products), whichever is longer."""
LAYER = "K2 flash_attention"
UNIT = "%"
MOVES = {"batch": "tokens_per_s"}   # by variant
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or ctx.kind != "oneshot":
        return None
    t, n = ctx.trace.time_of(r"flash_fwd")
    if not n or t <= 0:
        return None
    m = ctx.model
    b, s = int(ctx.mix["batch"]), int(ctx.mix["seq_len"])
    h, kv = m["n_heads"], m["n_kv_heads"]
    d = m.get("head_dim") or m["d_model"] // h
    bf16 = m.get("dtype", "bfloat16") == "bfloat16"
    elem = 2 if bf16 else 4
    keys = min(s, m["sliding_window"]) if m.get("sliding_window") else s
    nbytes = elem * b * s * d * (2 * h + 2 * kv)
    flops = 4 * b * h * s * keys * d
    rate = ctx.bounds.BF16_FLOPS if bf16 else ctx.bounds.TF32X3_FLOPS
    return ctx.bounds.bound_s(nbytes, flops, rate) * n / t * 100.0
