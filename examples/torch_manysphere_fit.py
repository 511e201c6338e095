"""Many-sphere inverse rendering with row-subset surrogates, on the
PyTorch/CUDA port.

examples/manysphere_fit.py on tinyraytracer_tpu_torch. A 128-sphere scene
under a lamp quad; the big diffuse sphere (at (-4, 1, 0)) is moved 1.5
units along z and fitted back by Adam on the photometric MSE, every other
primitive pinned. `trainable_rows` restricts the fused step's boundary
surrogates (silhouette and NEE soft shadow) to that one row, so the step
runs on the classic-layout kernel K4 and its cost follows the trained
subset, not the scene; the untrained rows must not move at all.

`--device cpu` runs K4's plain PyTorch twin: lower --size/--spp/--steps
there.

Run:
    python examples/torch_manysphere_fit.py --steps 80
    python examples/torch_manysphere_fit.py --device cpu --size 8 --spp 1 \\
        --steps 2
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from tinyraytracer_tpu_torch.diff import inverse, optim
from tinyraytracer_tpu_torch.models import presets
from tinyraytracer_tpu_torch.models.geometry import Quad
from tinyraytracer_tpu_torch.models.materials import Light
from tinyraytracer_tpu_torch.ops import trace as trace_ops
from tinyraytracer_tpu_torch.ops.diffkernel import build_diff_static
from tinyraytracer_tpu_torch.utils.device import resolve_device

BACKGROUND = (0.01, 0.01, 0.015)


def build(offset, n=128, width=128, height=128):
    """(scene, camera, preset kwargs, row): random_spheres(n) under a lamp
    quad, with the big diffuse sphere's row moved `offset` along z. The
    scene's tensors are on the CPU."""
    world, cam, kw = presets.random_spheres(width=width, height=height, n=n)
    world.add_material("lamp", Light((12.0, 12.0, 12.0)))
    world.add_geometry(Quad((-4.0, 11.99, -4.0), (8.0, 0.0, 0.0),
                            (0.0, 0.0, 8.0), "lamp"))
    scene = world.build()
    centers = scene.sph_center.numpy()
    rows = np.nonzero(scene.sph_valid.numpy())[0]
    target_row = int(rows[np.argmin(np.linalg.norm(
        centers[rows] - np.array([-4.0, 1.0, 0.0]), axis=-1))])
    moved = scene.sph_center.clone()
    moved[target_row, 2] += float(offset)
    return scene.replace(sph_center=moved), cam, kw, target_row


def main(argv=None) -> dict:
    """Runs the fit; returns the numbers it prints."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (K4's twin)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    scene_t, cam, kw, row = build(0.0, width=args.size, height=args.size)
    scene_t, cam = scene_t.to(dev), cam.to(dev)
    bg = torch.tensor(BACKGROUND, dtype=torch.float32, device=dev)
    target = trace_ops.render_image(
        scene_t, cam, spp=48, max_bounces=4, background=bg, seed=1,
        nee=True)
    scene0, _, _, _ = build(1.5, width=args.size, height=args.size)
    true_c = scene_t.sph_center[row].cpu().numpy()
    st = build_diff_static(scene0)
    print(f"scene: {len(st.sph_rows)} spheres; training row {row} only "
          f"(start offset 1.5)", flush=True)

    sched = optim.join_schedules(
        [optim.constant_schedule(0.08),
         optim.exponential_decay(0.08, transition_steps=10,
                                 decay_rate=0.5)],
        boundaries=[max(10, args.steps // 2)])
    step, (params, opt) = inverse.make_fused_train_step(
        scene0, cam, target, spp=args.spp, max_bounces=4,
        background=bg, seed=0, optimizer=optim.adam(sched),
        trainable=("sph_center",),
        trainable_rows={"sph": (row,)}, static=st, device=dev)
    t0 = time.perf_counter()
    curve = []
    for i in range(args.steps):
        params, opt, loss = step(params, opt, i)
        if i % 10 == 0 or i == args.steps - 1:
            got = params["sph_center"][row].cpu().numpy()
            err = float(np.linalg.norm(got - true_c))
            curve.append((i, float(loss), err))
            print(f"step {i:3d}  loss {float(loss):.6f}  err {err:.3f}",
                  flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    got = params["sph_center"][row].cpu().numpy()
    err = float(np.linalg.norm(got - true_c))
    n_rays = args.size * args.size * args.spp
    print(f"final position error: {err:.3f} (started 1.5); "
          f"{args.steps} steps in {dt:.1f}s "
          f"({n_rays * args.steps / dt / 1e6:.2f} Mrays/s incl. compile "
          "amortization)")
    # untrained rows must not have moved
    others = [r for r in st.sph_rows if r != row]
    drift = float(np.abs(params["sph_center"][others].cpu().numpy()
                         - scene0.sph_center[others].numpy()).max())
    print(f"max untrained-row drift: {drift} (must be 0.0)")
    return dict(row=row, spheres=len(st.sph_rows), curve=curve,
                final_error=err, seconds=dt, steps=args.steps, drift=drift)


if __name__ == "__main__":
    main()
