"""Device: the share of the traced window (the traced blocks' first
device activity to their last) with no kernel, copy or memset running on
the card."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.window_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
