"""Device time of a train step's image stage, ms: the program's CUDA
events around the fused launcher's image kernel and its fold (K5's or
K4's, stage `image`), over the traced window's steps."""

from perfbench import program


def read(ctx):
    return program.stage_ms(ctx, "image")
