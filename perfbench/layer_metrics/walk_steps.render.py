"""K2's closest-hit tests a bounce segment: the program's device counters
over the traced window, the node and row tests every in-image thread of
K2 ran (`walk_steps`: BVH nodes visited, leaves included, or a dense
segment's rows) over the bounce segments they ran (`lane_segments`).
None where no K2 launch counted its walk (K1's launches leave the
counter 0; a program without it has none)."""

from perfbench import program


def read(ctx):
    snap = program.snapshot()
    dev = {} if snap is None else snap["device"]
    if not dev.get("walk_iters") or not dev.get("lane_segments"):
        return None
    return dev["walk_steps"] / dev["lane_segments"]
