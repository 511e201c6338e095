#!/usr/bin/env python3
"""The card's measured-mix ceiling: scripts/probe_vpu_microbench.py's line,
measured by the PyTorch/CUDA port on an NVIDIA GPU.

    python3 scripts/torch_probe_vpu_microbench.py     # needs a CUDA card

Times csrc/microbench.cu (tinyraytracer_tpu_torch/utils/microbench.py):
five op mixes, each a loop of exactly counted FP32 operations over three
chains in every thread of one full wave of the card, run for about half a
second, the best of 3 after a warm-up. Rates are counted operations a
second in utils/sol.py's units (`fma` counts a fused multiply-add as two,
as the probe does). The `sphere` rate is sol.CAND_COUNTED_OPS_PER_SEC,
the `quad` rate sol.QUAD_COUNTED_OPS_PER_SEC, the `transcendental` rate
sol.FIXED_COUNTED_OPS_PER_SEC.

Prints one JSON line with the probe's keys (`fma_tops`, `select_tops`,
`sphere_tops`, `transcendental_tops` and their seconds `*_s`), the port's
`quad_tops` and `quad_s`, the card
(`device_name`, `power_limit_w` from nvidia-smi), the SM clock read
while each mix ran (`*_sm_clock_mhz`; `sm_clock_mhz` is the sphere
mix's) and each mix's iterations and threads. Exits 1 without CUDA.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from tinyraytracer_tpu_torch.utils import microbench as mb  # noqa: E402
from tinyraytracer_tpu_torch.utils import sol  # noqa: E402


def main() -> dict:
    import bench_torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: the rates "
                         "are the card's")
    dev = torch.device("cuda", torch.cuda.current_device())
    res = mb.measure(dev)
    out = {"device": "cuda", **bench_torch.card(dev),
           "spec_peak_tops": sol.FP32_PEAK / 1e12}
    for mix, r in res.items():
        out[f"{mix}_tops"] = r["tops"]
        out[f"{mix}_s"] = r["s"]
        for k in ("sm_clock_mhz", "iters", "threads", "ops_per_iter"):
            out[f"{mix}_{k}"] = r[k]
    out["sm_clock_mhz"] = res["sphere"]["sm_clock_mhz"]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
