"""Tracing on torch.profiler: the port's spans, counters and device stage
timers, and the Chrome trace exporter (port of utils/profiling.py).

Tracing is on exactly while a torch.profiler session is recording (the
benchmark's traced run, `trace()` below, the CLI's `--profile DIR`). With
it off, a span costs one check and records nothing, and the kernels run
their plain instantiations. This module is the port's only caller of
`record_function`.

- `annotate(name)`: a span. When tracing, a `record_function` of that
  name (so it lands in the profiler's trace, nested in the span open
  around it, on the clock of the device's records) and, in the registry,
  its count, total and self time (the total less its child spans', host
  `perf_counter` seconds).
- `count(name, n)`: a host counter, always on.
- `stage_events(prefix, stages, device)`: when tracing, CUDA events that a
  C launcher records on its stream at each stage's boundary; the device
  milliseconds of each stage are read at `snapshot()`.
- `device_counters(device)`: when tracing, the device's u64 counter
  buffer, which the forward kernels add to; read at `snapshot()`, summed
  over devices.
- `snapshot()`: everything since the last `reset()`; `counter(name)` one
  host counter.

Spans, and the per-layer metric (`perfbench/layer_metrics/`) that reads
each; the rest are read in the trace and the `--profile` export:

- `tinyrt.renderer.init`: Renderer.__init__ (unattributed_ms.render).
- `tinyrt.render`: Renderer.render, render_batch, render_async and its
  handle's result, MegakernelRenderer.render_burst
  (unattributed_ms.render). Its children:
  - `tinyrt.render.build`: world.build (lower_ms.render);
  - `tinyrt.render.lower`: MegakernelRenderer's set-up, the lowering,
    the copies of the table and camera to the device (lower_ms.render);
  - `tinyrt.render.launch`: the K1/K2 wrapper, its checks, allocations,
    the sample split's occupancy query and the launch (launch_ms.render);
  - `tinyrt.render.readback`: the copy of the image to the host, the
    wait for the kernels included;
  - `tinyrt.render.gamma`: the gamma, on a CUDA framebuffer the launch
    of its kernel before the readback (`Image.from_linear`,
    ops/tonemap.py `gamma_cuda`), else Image's numpy power
    (gamma_ms.render).
- `tinyrt.train.step`: a fused train step. Its children:
  - `tinyrt.train.table`: the scene from the live parameters, the flat
    table, camera and target on the device (table_ms.train);
  - `tinyrt.train.launch`: the K5/K4 wrapper's host time;
  - `tinyrt.train.grads`: the gradient tables, their scatter to the
    scene's fields, sanitising and masks (grads_ms.train);
  - `tinyrt.train.adam`: the optimizer's update (grads_ms.train).

Device stages (`stage_events`): `k5.image`, `k5.adjoint`, `k5.reduce`
(csrc/diffkernel_packed.cu), `k4.image`, `k4.adjoint`, `k4.reduce`
(csrc/diffkernel.cu): image_kernel_ms.train, adjoint_kernel_ms.train;
the reduce stages in the `--profile` export only.

Device counters (K1 and K2, csrc/common.cuh `render_pixel`):
`lane_segments`, the bounce segments every in-image thread ran, and
`warp_passes`, the passes of each warp's bounce loop:
simt_efficiency.render = lane_segments / (32 x warp_passes). K2 alone
(`count_walk`; K1 leaves them 0): `walk_steps`, the closest-hit tests
every in-image thread ran (BVH nodes visited, leaves included; a dense
segment's rows; the cull's blocks and the rows of the blocks it enters),
and `walk_iters`, 32 x the iterations of each warp's search loop (its
busiest lane's tests, each segment): walk_steps.render = walk_steps /
lane_segments, walk_efficiency.render = walk_steps / walk_iters. A
medium's test counts as a row's. K2's HAS_MED instantiation alone (a
scene with a ConstantMedium): `medium_scatters`, the bounce segments
whose closest hit was a medium's: medium_share.render = medium_scatters
/ lane_segments.

Host counters: `launches.<wrapper>`, one per kernel launch of each
wrapper (render_packed K1, render_flat K2, closest_hit K3, classic_diff
K4, packed_diff K5, sublanes P1, packgrad P2, packgrad2 P3, seglayout P4,
microbench P5; `launches.gamma`, tonemap.gamma_cuda's, one a CUDA
framebuffer or stack brought to the host as Images): the tests',
chip_smoke.py's and bench_torch.py's check of which kernel ran.

Usage (library):

    from tinyraytracer_tpu_torch.utils.profiling import trace
    with trace("/tmp/rt_profile"):
        renderer.render(camera, world)

`trace` writes `<log_dir>/tinyraytracer_<pid>_<ns>.pt.trace.json`, which
Perfetto (ui.perfetto.dev) and chrome://tracing open, and beside it
`tinyraytracer_<pid>_<ns>.counters.json`, the `snapshot()` of the region.
The JAX package writes an XLA `.xplane.pb` instead.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Iterator

import torch

DEVICE_COUNTERS = ("lane_segments", "warp_passes", "walk_steps",
                   "walk_iters", "medium_scatters")

_NOOP = contextlib.nullcontext()
_local = threading.local()
_spans: dict = {}           # name -> [count, total s, self s]
_counters: dict = {}        # name -> int
_stages: dict = {}          # name -> [count, device ms]
_pending: list = []         # (prefix, stages, events) not yet read
_device_bufs: dict = {}     # torch.device -> int64 tensor of DEVICE_COUNTERS


def enabled() -> bool:
    """Whether a torch.profiler session is recording."""
    return torch.autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "rf", "t0", "child")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.child = 0.0
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child += dt
        rec = _spans.get(self.name)
        if rec is None:
            rec = _spans[self.name] = [0, 0.0, 0.0]
        rec[0] += 1
        rec[1] += dt
        rec[2] += dt - self.child
        self.rf.__exit__(*exc)
        return False


def annotate(name: str):
    """A named span (see the module's docstring): the shared no-op context
    when tracing is off."""
    if not enabled():
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Adds n to the host counter `name`."""
    _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    """The host counter `name` (0 if never counted)."""
    return _counters.get(name, 0)


def stage_events(prefix: str, stages: tuple, device) -> list | None:
    """None when tracing is off; else len(stages) + 1 timing events on
    `device`, stage k running from event k to event k + 1, for a C
    launcher to record on its stream. Each is recorded once here, which
    creates it; the launcher's records replace that one."""
    if not enabled():
        return None
    stream = torch.cuda.current_stream(device)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(stages) + 1)]
    for e in events:
        e.record(stream)
    _pending.append((prefix, stages, events))
    return events


def device_counters(device) -> torch.Tensor | None:
    """None when tracing is off; else the device's counter buffer, int64
    words in DEVICE_COUNTERS' order, zero at first use."""
    if not enabled():
        return None
    device = torch.device(device)
    buf = _device_bufs.get(device)
    if buf is None:
        buf = _device_bufs[device] = torch.zeros(
            len(DEVICE_COUNTERS), dtype=torch.int64, device=device)
    return buf


def _resolve_stages() -> None:
    if not _pending:
        return
    torch.cuda.synchronize()
    for prefix, stages, events in _pending:
        for k, stage in enumerate(stages):
            rec = _stages.setdefault(f"{prefix}.{stage}", [0, 0.0])
            rec[0] += 1
            rec[1] += events[k].elapsed_time(events[k + 1])
    _pending.clear()


def snapshot() -> dict:
    """Everything since the last reset(): {"spans": {name: {"count",
    "total_ms", "self_ms"}}, "counters": {name: n}, "stages": {name:
    {"count", "ms"}}, "device": {counter: n} (empty when no kernel
    counted)}."""
    _resolve_stages()
    device = {}
    if _device_bufs:
        total = sum(b.cpu() for b in _device_bufs.values())
        device = dict(zip(DEVICE_COUNTERS, map(int, total.tolist())))
    return {
        "spans": {k: {"count": c, "total_ms": 1e3 * t, "self_ms": 1e3 * s}
                  for k, (c, t, s) in _spans.items()},
        "counters": dict(_counters),
        "stages": {k: {"count": c, "ms": ms}
                   for k, (c, ms) in _stages.items()},
        "device": device,
    }


def reset() -> None:
    """Clears every span, counter and stage time, and drops the device
    counter buffers."""
    _spans.clear()
    _counters.clear()
    _stages.clear()
    _pending.clear()
    _device_bufs.clear()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed region into
    log_dir (created if missing), and the registry's snapshot of it
    beside the trace. Both are written even when the region raises; the
    exception goes on."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
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
        stem = os.path.join(
            log_dir, f"tinyraytracer_{os.getpid()}_{time.time_ns()}")
        prof.export_chrome_trace(stem + ".pt.trace.json")
        with open(stem + ".counters.json", "w") as f:
            json.dump(snapshot(), f, indent=1)
