"""Readings that the correctness limits are set from (not run by the
benchmark's own runs).

    python3 perfbench/control.py --workload cornell.render \
        --seeds 1-12 --control-seeds 101-103 [--out FILE]

In one process, for the cell at its own sizes:

- `program`: for each seed, what a run's check reads: the system's timed
  path driven as a run drives it (render cells: as many renders as the
  check samples; train cells: the set-up's first steps), then the
  comparison with the reference;
- `control`: for each control seed, the reference computed in bfloat16,
  the nearest precision below the f32 the configuration states, put in
  the system's place and compared with the reference in f32;
- `fault.*` (train cells): the reference put in the system's place with
  a fault planted: `half_image` (the first half of the image's rows,
  the mean taken over them alone), `loss_altered` (each step's loss
  1 % high where it is produced), `unchanged` (a step that returns its
  state unchanged: the change's norms all 0).

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
import torch  # noqa: E402

from perfbench import core  # noqa: E402

CONTROL_DTYPE = torch.bfloat16


def _seeds(spec: str) -> list:
    out = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            out += list(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def program_reading(cell, seed: int, device: str) -> dict:
    """What a run's check reads for `seed`, without the timed window's
    length: the requests the check samples, then the check."""
    tr = core.traffic_class(cell.entry["traffic"])(
        cell.config, cell.params, seed=seed, device=device)
    tr.setup()
    for i in range(int(cell.params["check"].get("renders", 0))):
        tr.request(i)
    tr.release()
    out = {k: v["value"] for k, v in tr.check().items()}
    if hasattr(tr, "grad_norms"):
        rl, rg, rc, _ = tr.ref_readings
        out.update(tr.gaps((tr.losses, tr.grad_norms, tr.change_norms),
                           (rl, rg, rc), detail=True))
    return out


def render_control(cell, seed: int, device: str, dtype=CONTROL_DTYPE):
    """png_diff_share of the reference in `dtype` against the reference in
    f32, on the pixels and render seeds a run with `seed` samples."""
    from perfbench.reference.forward import to_u8
    from perfbench.traffic.render import request_seed

    tr = core.traffic_class("render")(cell.config, cell.params, seed=seed,
                                      device=device)
    diff = []
    for i in range(int(cell.params["check"]["renders"])):
        pix, s = tr.pixel_sample(i), request_seed(seed, i)
        ref, _ = tr.reference(s, pix)
        low, _ = tr.reference(s, pix, dtype)
        diff.append(to_u8(low) != to_u8(ref))
    return {"png_diff_share": float(np.mean(diff))}


def train_readings(cell, seed: int, device: str, faults: bool):
    """(control, {fault: reading}) of a train cell for `seed`."""
    tr = core.traffic_class("train")(cell.config, cell.params, seed=seed,
                                     device=device)
    tr.make_inputs()
    ref = tr.reference()[:3]
    out = {"control": tr.gaps(tr.reference(CONTROL_DTYPE)[:3], ref, True)}
    if faults:
        out["fault.half_image"] = tr.gaps(
            tr.reference(half_image=True)[:3], ref, True)
        out["fault.loss_altered"] = tr.gaps(
            ([x * 1.01 for x in ref[0]], ref[1], ref[2]), ref, True)
        out["fault.unchanged"] = tr.gaps(
            (ref[0], ref[1], {k: 0.0 for k in ref[2]}), ref, True)
    return out


def look(cell, seed: int, device: str, top: int = 4) -> dict:
    """Where a train cell's gaps come from: per step the loss gap, per
    leaf the change norms, and the entries whose change differs most,
    with both sides' first gradient there."""
    tr = core.traffic_class("train")(cell.config, cell.params, seed=seed,
                                     device=device)
    tr.setup()
    r = tr.reference_step()
    losses, g, change, _ = r.run(tr.steps0)
    out = {"loss_gaps": [abs(a - b) / abs(b) for a, b in zip(tr.losses,
                                                             losses)]}
    for k in change:
        d = (tr.change[k] - change[k]).abs().flatten()
        if not float(change[k].abs().max()) > 0.0:
            continue
        idx = torch.argsort(d, descending=True)[:top]
        flat = lambda t: t.flatten()[idx].tolist()  # noqa: E731
        out[k] = {"norm_prog": float(tr.change[k].norm()),
                  "norm_ref": float(change[k].norm()),
                  "entries": int(d.numel()),
                  "change_prog": flat(tr.change[k]),
                  "change_ref": flat(change[k]),
                  "grad1_prog": flat(tr.grad1[k]), "grad1_ref": flat(g[k]),
                  "grad1_ref_max": float(g[k].abs().max())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--no-faults", action="store_true")
    ap.add_argument("--look", default="",
                    help="train cells: seeds whose gaps to take apart")
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
        for seed in _seeds(args.seeds):
            t0 = time.perf_counter()
            emit("program", seed, program_reading(cell, seed, args.device),
                 t0)
        for seed in _seeds(args.look):
            t0 = time.perf_counter()
            emit("look", seed, look(cell, seed, args.device), t0)
        for seed in _seeds(args.control_seeds):
            t0 = time.perf_counter()
            if cell.entry["traffic"] == "render":
                emit("control", seed,
                     render_control(cell, seed, args.device), t0)
            else:
                for kind, v in train_readings(cell, seed, args.device,
                                              not args.no_faults).items():
                    emit(kind, seed, v, t0)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
