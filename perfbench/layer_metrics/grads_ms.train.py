"""Host time of a train step's gradients and update, ms: the self time of
the program's spans `tinyrt.train.grads` (the gradient tables, their
scatter to the scene's fields, sanitising and masks) and
`tinyrt.train.adam` (the optimizer), over the traced window's steps."""

from perfbench import program


def read(ctx):
    return program.self_ms(ctx, ("tinyrt.train.grads", "tinyrt.train.adam"))
