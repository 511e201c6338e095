"""Share of the forward kernels' bounce segments that ended in a
participating medium, %: the program's device counters over the traced
window, the segments of K2's HAS_MED instantiation whose closest hit was
a medium's (`medium_scatters`) over every in-image thread's segments
(`lane_segments`). None where no launch counted a medium (a scene
without media, or a program without the counter)."""

from perfbench import program


def read(ctx):
    snap = program.snapshot()
    dev = {} if snap is None else snap["device"]
    if "medium_scatters" not in dev or not dev.get("lane_segments"):
        return None
    return 100.0 * dev["medium_scatters"] / dev["lane_segments"]
