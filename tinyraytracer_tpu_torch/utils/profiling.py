"""Profiler tracing on torch.profiler (port of utils/profiling.py).

One context manager wraps any region in a trace: host (CPU) activity, and
on a machine with CUDA the card's too (kernel launches and their device
time, copies, the host gaps between them). At the end it writes a Chrome
trace, `<log_dir>/tinyraytracer_<pid>_<ns>.pt.trace.json`, which
Perfetto (ui.perfetto.dev) and chrome://tracing open. The JAX package
writes an XLA `.xplane.pb` instead.

Usage (library):

    from tinyraytracer_tpu_torch.utils.profiling import trace
    with trace("/tmp/rt_profile"):
        renderer.render(camera, world)

CLI: `python -m tinyraytracer_tpu_torch --profile /tmp/rt_profile` traces
the whole render. `annotate(name)` adds a named host span to the trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed region into
    log_dir (created if missing). The trace is written even when the
    region raises; the exception goes on."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            try:
                yield
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
    finally:
        # a region that raises still leaves its trace
        prof.export_chrome_trace(os.path.join(
            log_dir, f"tinyraytracer_{os.getpid()}_{time.time_ns()}"
                     ".pt.trace.json"))


def annotate(name: str):
    """Named host-side span; nests inside an active trace()."""
    import torch

    return torch.profiler.record_function(name)
