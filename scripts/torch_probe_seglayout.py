#!/usr/bin/env python3
"""scripts/probe_seglayout.py's lines, measured by the PyTorch/CUDA port
on an NVIDIA GPU: 64 path segments a ray, the scene's 24 rows gathered
from a table in shared memory (A, rays (1, TR)) or passed as scalars in
the kernel's parameters with select chains (B, (S, L) blocks).

    python3 scripts/torch_probe_seglayout.py     # needs a CUDA card

Times csrc/probe_seglayout.cu (tinyraytracer_tpu_torch/utils/probes.py
`seglayout`) at the probe's GRID = 4096 grid steps on the probe's own
tables (24 identical spheres: every ray misses from its second or third
segment on and its state is NaN from then; utils/probes.py), at each of
the probe's shapes: a warm-up, then the best of 5 launches, each timed by
CUDA events (device time; the probe timed the host's wall clock around a
readback). Prints the probe's lines (ms, ns a ray-segment, Mseg/s) and
one JSON line with each shape's `*_ms`, `*_ns_per_ray_seg`, `*_mseg_s`
and every run's ms, the grid, the segments and the card (`device_name`,
`power_limit_w` from nvidia-smi). Exits 1 without CUDA.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from tinyraytracer_tpu_torch.utils import probes  # noqa: E402

RUNS = 5


def name(body: str, shape) -> str:
    """The probe's label of a body and shape (:163, :173)."""
    if body == "A":
        return f"A (1,{shape[1]}) mxu-gather"
    return f"B ({shape[0]},{shape[1]}) packed"


def cases(device, grid: int = probes.P4_GRID,
          segments: int = probes.P4_SEGMENTS) -> dict:
    """{(body, shape): a launch of it at `grid` and `segments` on
    `device`}, on the probe's tables, in the probe's order."""
    tables = probes.seglayout_inputs(None, device)
    return {(b, s): (lambda b=b, s=s: probes.seglayout(b, s, tables, grid,
                                                       segments))
            for b, shapes in (("A", probes.P4_A_SHAPES),
                              ("B", probes.P4_B_SHAPES)) for s in shapes}


def segs(shape, grid: int = probes.P4_GRID,
         segments: int = probes.P4_SEGMENTS) -> int:
    return shape[0] * shape[1] * segments * grid


def line(body: str, shape, ms: float, grid: int = probes.P4_GRID,
         segments: int = probes.P4_SEGMENTS) -> str:
    """The probe's line (scripts/probe_seglayout.py:145)."""
    n, dt = segs(shape, grid, segments), ms * 1e-3
    return (f"{name(body, shape):28s}: {ms:8.2f} ms  {dt / n * 1e9:7.3f} "
            f"ns/ray-seg  ({n / dt / 1e6:7.1f} Mseg/s)")


def record(times: dict, grid: int = probes.P4_GRID,
           segments: int = probes.P4_SEGMENTS) -> dict:
    """The JSON line's numbers from {(body, shape): [ms of each run]}."""
    out = {"probe": "seglayout", "grid": grid, "segments": segments}
    for (body, shape), ts in times.items():
        key = f"{body}_{shape[0]}x{shape[1]}"
        ms, n = min(ts), segs(shape, grid, segments)
        out[f"{key}_ms"] = ms
        out[f"{key}_ns_per_ray_seg"] = ms * 1e6 / n
        out[f"{key}_mseg_s"] = n / ms / 1e3
        out[f"{key}_runs_ms"] = ts
    return out


def main() -> dict:
    import bench_torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: the times "
                         "are the card's")
    dev = torch.device("cuda", torch.cuda.current_device())
    times = {}
    for (body, shape), fn in cases(dev).items():
        times[body, shape] = probes.best_ms(fn, RUNS)[1]
        print(line(body, shape, min(times[body, shape])), flush=True)
    out = {"device": "cuda", **bench_torch.card(dev), **record(times)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
