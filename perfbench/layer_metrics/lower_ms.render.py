"""Host time of a render's scene build and lowering, ms: the self time of
the program's spans `tinyrt.render.build` (world.build) and
`tinyrt.render.lower` (MegakernelRenderer's set-up, the lowering, the
copy of the table and camera to the device), over the traced window's
renders."""

from perfbench import program


def read(ctx):
    return program.self_ms(ctx, ("tinyrt.render.build",
                                 "tinyrt.render.lower"))
