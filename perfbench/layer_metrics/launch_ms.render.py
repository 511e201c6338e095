"""Host time of a render's kernel launch, ms: the self time of the
program's span `tinyrt.render.launch` (the K1/K2 wrapper: checks,
allocations, the sample split's occupancy query, the launch call), over
the traced window's renders."""

from perfbench import program


def read(ctx):
    return program.self_ms(ctx, ("tinyrt.render.launch",))
