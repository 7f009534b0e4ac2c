"""Share of the traced window in which no kernel, copy or memset ran."""
LAYER = "device"
UNIT = "%"
MOVES = {"batch": "tokens_per_s", "served": "served_tokens_per_s"}   # by variant
SOURCE = "device_trace"


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return (1.0 - ctx.trace.busy_s / ctx.trace.window_s) * 100.0
