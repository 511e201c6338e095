"""Host time of a train step's scene table, ms: the self time of the
program's span `tinyrt.train.table` (the scene from the live parameters,
the flat table, camera and target on the device), over the traced
window's steps."""

from perfbench import program


def read(ctx):
    return program.self_ms(ctx, ("tinyrt.train.table",))
