#!/usr/bin/env python3
"""scripts/probe_packgrad2.py's lines, measured by the PyTorch/CUDA port
on an NVIDIA GPU: a winner-field gather from a (32, 24) table (C) and a
table built from block-wide scalar sums (D).

    python3 scripts/torch_probe_packgrad2.py     # needs a CUDA card

Times csrc/probe_packgrad2.cu (tinyraytracer_tpu_torch/utils/probes.py
`packgrad2`) at the probe's GRID = 512 grid steps of a (16, 256) tile
and 16 bounces, C on the probe's all-ones `pay`: a warm-up, then the
best of 3 launches, each timed by CUDA events (device time; the probe
timed the host's wall clock around a readback). Prints the probe's two
lines (ms, ns a lane-bounce) and one JSON line with each body's `*_ms`,
`*_ns_per_lane_bounce` and every run's ms, the grid, the bounces and the
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

NAMES = {"C": "C onehot MXU gather + unpack reshape",
         "D": "D scalar-sum table build           "}
RUNS = 3


def cases(device, grid: int = probes.P3_GRID,
          bounces: int = probes.P3_BOUNCES) -> dict:
    """{body: a launch of it at `grid` and `bounces` on `device`}: C on
    the probe's `pay`."""
    pay = probes.packgrad2_inputs(None, device)
    return {"C": lambda: probes.packgrad2("C", pay, grid=grid,
                                          bounces=bounces),
            "D": lambda: probes.packgrad2("D", device=device, grid=grid,
                                          bounces=bounces)}


def lane_bounces(grid: int = probes.P3_GRID,
                 bounces: int = probes.P3_BOUNCES) -> int:
    s, width = probes.P3_SHAPE
    return grid * bounces * s * width


def line(body: str, ms: float, grid: int = probes.P3_GRID,
         bounces: int = probes.P3_BOUNCES) -> str:
    """The probe's line (scripts/probe_packgrad2.py:195)."""
    per = ms * 1e6 / lane_bounces(grid, bounces)
    return f"{NAMES[body]}: {ms:8.2f} ms  {per:6.3f} ns/lane-bounce"


def record(times: dict, grid: int = probes.P3_GRID,
           bounces: int = probes.P3_BOUNCES) -> dict:
    """The JSON line's numbers from {body: [ms of each run]}."""
    out = {"probe": "packgrad2", "grid": grid, "bounces": bounces,
           "shape": list(probes.P3_SHAPE)}
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
