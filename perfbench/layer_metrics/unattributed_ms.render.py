"""Host time of a render that no span of the program explains, ms:
`host_ms.render` (the request's wall time less the device's busy time in
it, from the trace) less the self time of the program's render spans but
the readback (whose time is mostly the device's), over the traced
window's renders."""

from perfbench import program

SPANS = ("tinyrt.renderer.init", "tinyrt.render", "tinyrt.render.build",
         "tinyrt.render.lower", "tinyrt.render.launch",
         "tinyrt.render.gamma")


def read(ctx):
    wall, busy = ctx.trace.mean(0), ctx.trace.mean(1)
    spans = program.self_ms(ctx, SPANS)
    if wall is None or spans is None:
        return None
    return 1e3 * (wall - busy) - spans
