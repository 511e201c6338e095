"""The kernels' share of the FP32 peak in a render, %: the work of a
request as perfbench/workcount.py counts it, at the segments the
reference counted on the inputs it compared, over the mean device kernel
time of a request, against 67e12 FP32 operations a second (the card's
power limit is in the result's device.power_limit_w)."""

from perfbench import workcount


def read(ctx):
    ops = ctx.traffic.kernel_ops_per_request()
    kern = ctx.trace.mean(2)
    if ops is None or kern is None:
        return None
    return workcount.share_pct(ops, kern)
