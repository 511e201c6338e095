"""Host time of a render, ms: the request's wall time less the time in
which the device ran a kernel or a copy inside its span, averaged over
the traced window's requests."""


def read(ctx):
    wall, busy = ctx.trace.mean(0), ctx.trace.mean(1)
    if wall is None:
        return None
    return 1e3 * (wall - busy)
