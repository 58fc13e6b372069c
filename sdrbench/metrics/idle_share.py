"""idle_share (%, device trace): the share of the traced window in which no
device op ran; ``idle_share.dev`` reads the same for the cells that report
``msps.dev``."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
