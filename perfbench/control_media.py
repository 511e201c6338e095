"""Readings that a `render_media` cell's correctness limit is set from
(not run by the benchmark's own runs): perfbench/control.py's method for
the render cells whose traffic is traffic/render_media.py, whose control
control.py cannot draw (it builds traffic/render.py's Cell).

    python3 perfbench/control_media.py --workload rtnw_final.render \
        --seeds 1-6 --control-seeds 101-102 [--out FILE]

- `program`: for each seed, what a run's check reads (control.py's
  `program_reading`: the renders the check samples, then the check);
- `control`: for each control seed, the reference with media computed in
  bfloat16 put in the system's place and compared with the reference in
  f32, on the pixels and render seeds a run with that seed samples.

Each reading is one JSON line on standard output (and in --out).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from perfbench import control, core  # noqa: E402


def media_control(cell, seed: int, device: str,
                  dtype=control.CONTROL_DTYPE) -> dict:
    """png_diff_share of the reference in `dtype` against the reference in
    f32, on the pixels and render seeds a run with `seed` samples."""
    from perfbench.reference.forward import to_u8
    from perfbench.traffic.render import request_seed

    tr = core.traffic_class(cell.entry["traffic"])(
        cell.config, cell.params, seed=seed, device=device)
    diff = []
    for i in range(int(cell.params["check"]["renders"])):
        pix, s = tr.pixel_sample(i), request_seed(seed, i)
        ref, _ = tr.reference(s, pix)
        low, _ = tr.reference(s, pix, dtype)
        diff.append(to_u8(low) != to_u8(ref))
    return {"png_diff_share": float(np.mean(diff))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/control_media.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    core.set_cache_dirs()
    cell = core.find_cell(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, values, t0):
        line = json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                           "values": values,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    try:
        for seed in control._seeds(args.seeds):
            t0 = time.perf_counter()
            emit("program", seed,
                 control.program_reading(cell, seed, args.device), t0)
        for seed in control._seeds(args.control_seeds):
            t0 = time.perf_counter()
            emit("control", seed, media_control(cell, seed, args.device),
                 t0)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
