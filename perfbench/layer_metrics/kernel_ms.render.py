"""Device kernel time of a render, ms: the union of the kernels the
device ran inside the request's span, whatever their names, averaged
over the traced window's requests."""


def read(ctx):
    kern = ctx.trace.mean(2)
    if kern is None or not kern > 0.0:
        return None
    return 1e3 * kern
