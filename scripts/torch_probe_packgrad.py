#!/usr/bin/env python3
"""scripts/probe_packgrad.py's lines, measured by the PyTorch/CUDA port on
an NVIDIA GPU: per-lane gradients reaching a (24, 16) table by a scatter
(A) and by 48 masked sums (B).

    python3 scripts/torch_probe_packgrad.py     # needs a CUDA card

Times csrc/probe_packgrad.cu (tinyraytracer_tpu_torch/utils/probes.py
`packgrad`) at the probe's GRID = 1024 grid steps of a (32, 256) tile and
16 bounces: a warm-up, then the best of 3 launches, each timed by CUDA
events (device time; the probe timed the host's wall clock around a
readback). Prints the probe's two lines (ms, ns a lane-bounce) and one
JSON line with each body's `*_ms`, `*_ns_per_lane_bounce` and every run's
ms, the grid, the bounces and the card (`device_name`, `power_limit_w`
from nvidia-smi). Exits 1 without CUDA.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from tinyraytracer_tpu_torch.utils import probes  # noqa: E402

NAMES = {"A": "A reshape+MXU scatter", "B": "B masked lane-reduces "}
RUNS = 3


def cases(device, grid: int = probes.P2_GRID,
          bounces: int = probes.P2_BOUNCES) -> dict:
    """{body: a launch of it at `grid` and `bounces` on `device`}."""
    return {b: (lambda b=b: probes.packgrad(b, device, grid, bounces))
            for b in probes.BODIES["packgrad"]}


def lane_bounces(grid: int = probes.P2_GRID,
                 bounces: int = probes.P2_BOUNCES) -> int:
    s, width = probes.P2_SHAPE
    return grid * bounces * s * width


def line(body: str, ms: float, grid: int = probes.P2_GRID,
         bounces: int = probes.P2_BOUNCES) -> str:
    """The probe's line (scripts/probe_packgrad.py:87)."""
    per = ms * 1e6 / lane_bounces(grid, bounces)
    return f"{NAMES[body]}: {ms:8.2f} ms  {per:6.3f} ns/lane-bounce"


def record(times: dict, grid: int = probes.P2_GRID,
           bounces: int = probes.P2_BOUNCES) -> dict:
    """The JSON line's numbers from {body: [ms of each run]}."""
    out = {"probe": "packgrad", "grid": grid, "bounces": bounces,
           "shape": list(probes.P2_SHAPE)}
    for body, ts in times.items():
        out[f"{body}_ms"] = min(ts)
        out[f"{body}_ns_per_lane_bounce"] = (min(ts) * 1e6
                                             / lane_bounces(grid, bounces))
        out[f"{body}_runs_ms"] = ts
    return out


def main() -> dict:
    import bench_torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: the times "
                         "are the card's")
    dev = torch.device("cuda", torch.cuda.current_device())
    times = {}
    for body, fn in cases(dev).items():
        times[body] = probes.best_ms(fn, RUNS)[1]
        print(line(body, min(times[body])), flush=True)
    out = {"device": "cuda", **bench_torch.card(dev), **record(times)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
