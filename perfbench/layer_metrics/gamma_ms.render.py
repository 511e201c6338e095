"""Host time of a render's gamma, ms: the self time of the program's span
`tinyrt.render.gamma` (the numpy power of the image), over the traced
window's renders."""

from perfbench import program


def read(ctx):
    return program.self_ms(ctx, ("tinyrt.render.gamma",))
