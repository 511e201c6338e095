"""Share of the forward kernels' issued lanes that ran a bounce segment,
%: the program's device counters over the traced window, the segments
every in-image thread of K1 or K2 ran over 32 x the passes of every
warp's bounce loop (csrc/common.cuh, count_lanes). A warp pays its
busiest lane's bounces; the rest is idle lanes."""

from perfbench import program


def read(ctx):
    snap = program.snapshot()
    dev = {} if snap is None else snap["device"]
    if not dev.get("warp_passes"):
        return None
    return 100.0 * dev["lane_segments"] / (32.0 * dev["warp_passes"])
