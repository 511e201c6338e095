"""Share of the traced window in which the device ran no kernel and no
copy, %."""


def read(ctx):
    if not ctx.trace.window_s > 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
