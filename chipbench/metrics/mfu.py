"""The whole step's share of the chip's bf16 peak: the useful operations of
the work finished in the window (chipbench.flops: real tokens only) over
the window's length times 989 TFLOP/s."""
LAYER = "whole step"
UNIT = "%"
MOVES = {"batch": "tokens_per_s", "served": "served_tokens_per_s"}   # by variant
SOURCE = "host_clock"


def read(ctx):
    _, flops = ctx.work()
    if not flops:
        return None
    return flops / (ctx.window.window_s * ctx.bounds.BF16_FLOPS) * 100.0
