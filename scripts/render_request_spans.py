"""A render cell's request loop, its host time split by the port's spans.

Runs perfbench's own traffic class for a render cell (set-up, then
`request(i)` in a closed loop, each Image dropped with its request) with
`profiling.annotate` replaced by a timer, so each span's wall time a
request is read without torch.profiler. The readback span starts with a
synchronize, so it times the copy and not the wait for the kernels.
Last, it times the first and the second write of a fresh mapping of one
frame's size: what a page that the process takes anew costs on this host.

Where host memory comes from decides much of the host path's time:
glibc hands large freed blocks back to the kernel when the free top of
its heap passes a threshold set from the largest block freed, and the
next render writes into fresh pages again. To read the path without that
cost, run it again with the thresholds fixed (glibc's tunables, this
process alone):

    python3 scripts/render_request_spans.py cornell.render 60
    MALLOC_MMAP_THRESHOLD_=268435456 MALLOC_TRIM_THRESHOLD_=1073741824 \\
        python3 scripts/render_request_spans.py cornell.render 60

from a checkout's root, on a CUDA card. Prints one JSON line.
"""

from __future__ import annotations

import contextlib
import json
import mmap
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import core  # noqa: E402
from tinyraytracer_tpu_torch.utils import profiling  # noqa: E402

SEED = 3_000_000_019


def main(cell_name: str, n: int) -> dict:
    spent: dict = {}

    @contextlib.contextmanager
    def span(name):
        if name == "tinyrt.render.readback":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0

    profiling.annotate = span
    cell = core.find_cell(cell_name)
    traffic = core.traffic_class(cell.entry["traffic"])(
        cell.config, cell.params, seed=SEED, device="cuda")
    traffic.setup()
    torch.cuda.synchronize()
    spent.clear()
    per = []
    for i in range(n):
        t0 = time.perf_counter()
        traffic.request(i)
        per.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    frame = cell.params["height"] * cell.params["width"] * 3 * 4
    m = mmap.mmap(-1, frame)
    pages = np.frombuffer(m, np.float32)
    t0 = time.perf_counter()
    pages.fill(1.0)
    t1 = time.perf_counter()
    pages.fill(2.0)
    t2 = time.perf_counter()
    del pages
    m.close()
    return dict(cell=cell_name, requests=n,
                request_ms_median=float(np.median(per)),
                span_ms={k: v * 1e3 / n for k, v in sorted(spent.items())},
                fresh_write_ms=(t1 - t0) * 1e3,
                warm_write_ms=(t2 - t1) * 1e3,
                malloc_env={k: v for k, v in os.environ.items()
                            if k.startswith("MALLOC_")},
                card=torch.cuda.get_device_name(0))


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1], int(sys.argv[2]))))
