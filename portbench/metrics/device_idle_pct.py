"""device_idle_pct (device layer): the share of the traced window in which
no kernel, copy or set ran on the card (the union of the profiler's device
intervals), in %."""


def read(ctx):
    if ctx.trace.window_s <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
