"""Device time of a train step's replay-and-adjoint stage, ms: the
program's CUDA events around the fused launcher's main kernel (K5's
replay and adjoint, K4's walk; stage `adjoint`), over the traced window's
steps."""

from perfbench import program


def read(ctx):
    return program.stage_ms(ctx, "adjoint")
