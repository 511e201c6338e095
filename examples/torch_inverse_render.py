"""Inverse rendering on the PyTorch/CUDA port: recover Cornell sphere
positions and albedos.

examples/inverse_render.py step for step, on tinyraytracer_tpu_torch:
BASELINE.md config 5. Render a target image of the cornell_spheres scene
(next-event estimation, seed 7), perturb the scene (spheres moved by
(2.5, -1.5, 3.0), two albedos tinted), then recover the parameters by Adam
on the photometric MSE. Geometry trains through adaptive_clip(4.0) and Adam
(b2 = 0.9) on a rate held for 80 % of the run and then halved every 20
steps; materials train with Adam(0.02). The last 20 % of the steps run at
--refine-spp, the albedos are clamped to [0, 1] after every step, and the
tail of the run is averaged (Polyak). Checkpoints every 50 steps let a fit
resume.

On a CUDA device `--engine auto` takes the fused step (kernel K5, or K4
for scenes past K5's limits; one launch a step); on the CPU the modular
autograd step. `--device cpu` runs the kernels' plain PyTorch twins:
lower --size/--spp/--steps there.

Run:
    python examples/torch_inverse_render.py --out output/torch_inverse
    python examples/torch_inverse_render.py --mesh 2 --sample-parallel 2
    python examples/torch_inverse_render.py --device cpu --size 12 --spp 2 \\
        --target-spp 2 --refine-spp 0 --steps 3 --max-bounces 2
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
from tinyraytracer_tpu_torch.diff.params import apply_params, scene_params
from tinyraytracer_tpu_torch.models import presets
from tinyraytracer_tpu_torch.ops import trace as trace_ops
from tinyraytracer_tpu_torch.parallel.sharded import make_mesh
from tinyraytracer_tpu_torch.utils.device import resolve_device
from tinyraytracer_tpu_torch.utils.image import Image


def perturb(scene):
    """The fit's start: every valid sphere moved by (2.5, -1.5, 3.0), the
    albedos of materials 4 and 5 tinted."""
    dev = scene.sph_center.device
    off = torch.where(scene.sph_valid[:, None],
                      torch.tensor([[2.5, -1.5, 3.0]], device=dev),
                      torch.zeros((), device=dev))
    albedo = scene.mat_albedo.clone()
    albedo[4] = torch.tensor([0.6, 0.2, 0.3], device=dev)
    albedo[5] = torch.tensor([0.3, 0.3, 0.7], device=dev)
    return scene.replace(sph_center=scene.sph_center + off,
                         mat_albedo=albedo)


def make_optimizer(scene, steps: int, lr: float, albedo_lr: float):
    """Geometry (sph_*, quad_*): adaptive_clip(4.0), then Adam (b2 = 0.9)
    at `lr` until max(40, 4/5 of the steps), halving every 20 steps after;
    materials: Adam(albedo_lr)."""
    geom_sched = optim.join_schedules(
        [optim.constant_schedule(lr),
         optim.exponential_decay(lr, transition_steps=20, decay_rate=0.5)],
        boundaries=[max(40, (steps * 4) // 5)])
    return optim.multi_transform(
        {"geom": optim.chain(inverse.adaptive_clip(4.0),
                             optim.adam(geom_sched, b2=0.9)),
         "mat": optim.adam(albedo_lr)},
        {k: ("geom" if k.startswith(("sph_", "quad_")) else "mat")
         for k in scene_params(scene)})


def main(argv=None) -> dict:
    """Runs the fit; returns the numbers it prints (and the per-step
    losses, the last iterate and the loop's wall time)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--refine-spp", type=int, default=128,
                    help="spp for the decay-phase steps (last 20%%); "
                         "0 disables")
    ap.add_argument("--target-spp", type=int, default=64)
    ap.add_argument("--max-bounces", type=int, default=6)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--lr", type=float, default=0.25)
    ap.add_argument("--albedo-lr", type=float, default=0.02)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard over this many devices (0 = single); the "
                         "list repeats the device when it has fewer")
    ap.add_argument("--sample-parallel", type=int, default=1)
    ap.add_argument("--out", default="output/inverse")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--trainable", default="sph_center,mat_albedo",
                    help="comma-separated param fields to optimize")
    ap.add_argument("--engine", choices=("auto", "fused", "modular"),
                    default="auto",
                    help="fused = one kernel launch a step (K5/K4); auto "
                         "picks fused on a CUDA device")
    ap.add_argument("--grad-chunks", type=int, default=1,
                    help="fused engine: median-of-N-chunks gradients")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' twins)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    world, camera, kw = presets.cornell_spheres(width=args.size,
                                                height=args.size)
    scene = world.build().to(dev)
    camera = camera.to(dev)
    bg = torch.tensor(kw["background"], dtype=torch.float32, device=dev)

    os.makedirs(args.out, exist_ok=True)

    def save(img, name):
        Image.from_linear(img).save(os.path.join(args.out, name))

    # the target takes the estimator family the fit uses (nee=True)
    target = trace_ops.render_image(
        scene, camera, spp=args.target_spp, max_bounces=args.max_bounces,
        background=bg, seed=7, nee=True)
    save(target, "target.png")

    s_valid = scene.sph_valid.cpu().numpy()
    true_centers = scene.sph_center.cpu().numpy()[s_valid]
    print("true centers:\n", true_centers)

    pert = perturb(scene)
    save(trace_ops.render_image(
        pert, camera, spp=args.target_spp, max_bounces=args.max_bounces,
        background=bg, seed=7), "initial.png")

    mesh = None
    if args.mesh:
        n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
        devices = ([torch.device("cuda", i % n_dev)
                    for i in range(args.mesh)] if dev.type == "cuda"
                   else [dev] * args.mesh)
        mesh = make_mesh(devices, sample_parallel=args.sample_parallel)
        print(f"mesh: {mesh.shape}")

    optimizer = make_optimizer(scene, args.steps, args.lr, args.albedo_lr)
    fused = (args.engine == "fused"
             or (args.engine == "auto" and dev.type == "cuda"))

    def build_step(spp):
        common = dict(spp=spp, max_bounces=args.max_bounces,
                      background=kw["background"], seed=13,
                      optimizer=optimizer, mesh=mesh,
                      trainable=tuple(args.trainable.split(",")),
                      device=dev)
        if fused:
            return inverse.make_fused_train_step(
                pert, camera, target,
                grad_chunks=(args.grad_chunks
                             if spp % max(args.grad_chunks, 1) == 0
                             else 1),
                **common)
        return inverse.make_train_step(pert, camera, target, **common)

    step, (params, opt_state) = build_step(args.spp)
    print(f"engine: {'fused' if fused else 'modular'}")

    start = 0
    ckpt = args.checkpoint
    if ckpt and os.path.exists(ckpt):
        params, opt_state, start = inverse.load_checkpoint(ckpt, opt_state)
        print(f"resumed from step {start}")

    # the refine phase swaps in a higher-spp step when the geometry rate
    # starts to decay; the Polyak window starts after that boundary
    refine_from = max(40, (args.steps * 4) // 5)
    avg_from = start + (args.steps - start) * 3 // 4
    if args.refine_spp > args.spp and refine_from < args.steps:
        avg_from = max(avg_from,
                       refine_from + (args.steps - refine_from) // 4)
    avg_params, avg_n = None, 0

    refine_step = None
    if args.refine_spp > args.spp:
        refine_step = lambda: build_step(args.refine_spp)[0]  # noqa: E731

    losses = []
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        if refine_step is not None and i >= refine_from:
            step = refine_step()
            refine_step = None
            print(f"refine phase: spp -> {args.refine_spp}")
        params, opt_state, loss = step(params, opt_state, i)
        losses.append(loss)
        # albedos live in [0, 1]
        params["mat_albedo"] = torch.clamp(params["mat_albedo"], 0.0, 1.0)
        if i >= avg_from:
            avg_n += 1
            if avg_params is None:
                avg_params = dict(params)
            else:
                avg_params = {k: v + (params[k] - v) / avg_n
                              for k, v in avg_params.items()}
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}")
        if ckpt and (i + 1) % 50 == 0:
            inverse.save_checkpoint(ckpt, params, opt_state, i + 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    last = {k: v.detach().cpu() for k, v in params.items()}

    if avg_params is not None:
        params = avg_params
    fitted = apply_params(pert, params)
    save(trace_ops.render_image(
        fitted, camera, spp=args.target_spp, max_bounces=args.max_bounces,
        background=bg, seed=7), "fitted.png")
    got_centers = fitted.sph_center.detach().cpu().numpy()[s_valid]
    print("recovered centers:\n", got_centers)
    err = float(np.abs(got_centers - true_centers).max())
    print(f"max center error: {err:.3f} (initial offset ~4.2)")
    alb = fitted.mat_albedo.detach().cpu().numpy()[4:6]
    print("recovered albedos (true 0.2,0.4,0.8 / 0.8,0.6,0.2):\n", alb)
    return dict(engine="fused" if fused else "modular", start=start,
                losses=[float(x) for x in losses], seconds=seconds,
                steps=args.steps - start, max_center_error=err,
                centers=got_centers, albedos=alb, last_params=last)


if __name__ == "__main__":
    main()
