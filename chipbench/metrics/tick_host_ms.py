"""Host time per engine tick: the tick (``serve_tick_seconds``) less its
waits on the device (the ``step_wait`` span), summed over the window's
ticks and divided by their count."""
LAYER = "engine tick"
UNIT = "ms"
MOVES = {"served": "served_tokens_per_s"}   # by variant
SOURCE = "program_span"


def read(ctx):
    tick = ctx.counter_delta("serve_tick_seconds")
    wait = ctx.counter_delta("trace_step_wait_seconds")
    if not tick or not tick["count"] or wait is None:
        return None
    return (tick["sum"] - wait["sum"]) / tick["count"] * 1e3
