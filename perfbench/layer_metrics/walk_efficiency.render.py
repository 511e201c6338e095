"""Share of K2's closest-hit loop iterations that a lane spent on a test,
%: the program's device counters over the traced window, the node and
row tests every in-image thread ran (`walk_steps`) over 32 x the
iterations of each warp's search loop, its busiest lane's tests each
segment (`walk_iters`). A per-thread BVH walk diverges: lanes that end
their walk early idle until the warp's last lane ends. None where no K2
launch counted its walk."""

from perfbench import program


def read(ctx):
    snap = program.snapshot()
    dev = {} if snap is None else snap["device"]
    if not dev.get("walk_iters"):
        return None
    return 100.0 * dev["walk_steps"] / dev["walk_iters"]
