#!/usr/bin/env python3
"""scripts/probe_sublanes.py's lines, measured by the PyTorch/CUDA port
on an NVIDIA GPU: 2 000 chained steps y = y * 1.000001 + x; y = (y > 2)
? y - 2 : y on every element of one block, for five block shapes.

    python3 scripts/torch_probe_sublanes.py     # needs a CUDA card

Times csrc/probe_sublanes.cu (tinyraytracer_tpu_torch/utils/probes.py
`sublanes`) at the probe's GRID = 512 grid steps on the probe's x = 0.5,
for each of its shapes: a warm-up, then the best of 5 launches, each
timed by CUDA events (device time; the probe timed the host's wall clock
around block_until_ready). The rate counts 3 operations a step, as the
probe does (utils/sol.py's rule counts 4: the bound in chip_smoke.py).
Prints the probe's lines (ms, Tops/s) and one JSON line with each
shape's `*_ms`, `*_tops` and every run's ms, the grid, the steps and the
card (`device_name`, `power_limit_w` from nvidia-smi). Exits 1 without
CUDA.
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


def cases(device, grid: int = probes.P1_GRID,
          iters: int = probes.P1_ITERS, shapes=probes.P1_SHAPES) -> dict:
    """{shape: a launch at `grid` and `iters` on the probe's x}."""
    xs = {s: probes.sublanes_inputs(s, None, device) for s in shapes}
    return {s: (lambda s=s: probes.sublanes(xs[s], grid, iters))
            for s in shapes}


def ops(shape, grid: int = probes.P1_GRID,
        iters: int = probes.P1_ITERS) -> int:
    """The probe's operation count (3 a step)."""
    return (shape[0] * shape[1] * iters * grid
            * probes.P1_PROBE_OPS_PER_STEP)


def line(shape, ms: float, grid: int = probes.P1_GRID,
         iters: int = probes.P1_ITERS) -> str:
    """The probe's line (scripts/probe_sublanes.py:234)."""
    tops = ops(shape, grid, iters) / (ms * 1e-3) / 1e12
    return f"{str(tuple(shape)):12s}: {ms:8.2f} ms  {tops:6.2f} Tops/s"


def record(times: dict, grid: int = probes.P1_GRID,
           iters: int = probes.P1_ITERS) -> dict:
    """The JSON line's numbers from {shape: [ms of each run]}."""
    out = {"probe": "sublanes", "grid": grid, "iters": iters,
           "ops_per_step": probes.P1_PROBE_OPS_PER_STEP}
    for shape, ts in times.items():
        key = f"{shape[0]}x{shape[1]}"
        out[f"{key}_ms"] = min(ts)
        out[f"{key}_tops"] = ops(shape, grid, iters) / min(ts) / 1e9
        out[f"{key}_runs_ms"] = ts
    return out


def main() -> dict:
    import bench_torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: the times "
                         "are the card's")
    dev = torch.device("cuda", torch.cuda.current_device())
    times = {}
    for shape, fn in cases(dev).items():
        times[shape] = probes.best_ms(fn, RUNS)[1]
        print(line(shape, min(times[shape])), flush=True)
    out = {"device": "cuda", **bench_torch.card(dev), **record(times)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
