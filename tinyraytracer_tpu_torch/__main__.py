"""Scene application / CLI — the reference binary's role (src/main.rs:5-125).

    python -m tinyraytracer_tpu_torch                  # Cornell 300x300 spp=300
    python -m tinyraytracer_tpu_torch --preset three_spheres --spp 100
    python -m tinyraytracer_tpu_torch --width 600 --height 600 --spp 200 \\
        --out output/cornell600.png --progress
    python -m tinyraytracer_tpu_torch --device cpu --width 64 --height 48
    python -m tinyraytracer_tpu_torch --sample-parallel 2   # over all cards
    python -m tinyraytracer_tpu_torch --preset random_spheres --accelerator bvh
    python -m tinyraytracer_tpu_torch --profile output/profile  # Chrome trace

Defaults reproduce the reference binary: Cornell box, 300x300, spp=300,
max_bounces=20, background (0.001, 0.001, 0.001) (src/main.rs:6-21). The
device defaults to CUDA and is never guessed: without CUDA, pass
`--device cpu` to render with the kernel's PyTorch twin. With `--device
cuda` and more than one visible CUDA device the render runs over a (tile
x sample) mesh of all of them, `--sample-parallel` of them splitting each
pixel's samples (parallel/sharded.py); `--device cuda:k` renders on that
card alone. `--accelerator` picks the render path as the JAX CLI's does:
the megakernels (`auto`, `megakernel`), the modular tracer with BVH
selection (`bvh`) or with dense selection (`none`). `--profile DIR`
writes a torch.profiler Chrome trace of the render into DIR and, beside
it, the port's spans and counters (`*.counters.json`,
utils/profiling.py).
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tinyraytracer_tpu_torch",
        description="Path tracer in PyTorch with a CUDA megakernel",
    )
    ap.add_argument("--preset", default="cornell_box",
                    help="scene preset (see models/presets.py)")
    ap.add_argument("--width", type=int, default=300)
    ap.add_argument("--height", type=int, default=300)
    ap.add_argument("--spp", type=int, default=300,
                    help="samples per pixel (src/main.rs:15)")
    ap.add_argument("--max-bounces", type=int, default=None,
                    help="bounce budget (default: preset's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="output/output.png",
                    help="PNG path (src/main.rs:20)")
    ap.add_argument("--progress", action="store_true",
                    help="progress bar (the indicatif analog)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (CUDA kernel; every visible "
                         "card), cuda:k (that card alone) or cpu (twin)")
    ap.add_argument("--sample-parallel", type=int, default=1,
                    help="devices cooperating on the same pixels: with "
                         "--device cuda and more than one visible CUDA "
                         "device the render runs over a mesh of all of "
                         "them")
    ap.add_argument("--accelerator", default="auto",
                    choices=("auto", "megakernel", "bvh", "none"),
                    help="auto/megakernel: the CUDA megakernels (their "
                         "twins on the CPU); bvh: the modular tracer with "
                         "BVH selection; none: the modular tracer with "
                         "dense selection")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the "
                         "render into DIR (open it in Perfetto), and the "
                         "port's spans and counters beside it")
    args = ap.parse_args(argv)

    import torch

    from tinyraytracer_tpu_torch.models import presets
    from tinyraytracer_tpu_torch.renderer import Renderer

    if args.preset not in presets.PRESETS:
        ap.error(f"unknown preset {args.preset!r}; "
                 f"choose from {sorted(presets.PRESETS)}")
    world, camera, kw = presets.PRESETS[args.preset](
        width=args.width, height=args.height
    )
    max_bounces = (
        kw["max_bounces"] if args.max_bounces is None else args.max_bounces
    )
    if max_bounces < 1:
        ap.error("--max-bounces must be >= 1")
    devices = None
    # a bare "cuda" takes every visible card; "cuda:k" names one card
    if (torch.device(args.device) == torch.device("cuda")
            and torch.cuda.is_available() and torch.cuda.device_count() > 1):
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    renderer = Renderer(
        samples_per_pixel=args.spp,
        max_bounces=max_bounces,
        progressbar=args.progress,
        background_color=kw["background"],
        seed=args.seed,
        devices=devices,
        accelerator=args.accelerator,
        sample_parallel=args.sample_parallel,
        device=None if devices else args.device,
    )
    t0 = time.perf_counter()
    if args.profile:
        from tinyraytracer_tpu_torch.utils.profiling import trace

        with trace(args.profile):
            image = renderer.render(camera, world)
    else:
        image = renderer.render(camera, world)   # ends in a host copy
    dt = time.perf_counter() - t0
    dev = renderer.device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (PyTorch twin)" if args.accelerator in (
                "auto", "megakernel") else "cpu")
    if devices:
        name = f"{len(devices)} x {name} (mesh {renderer.mesh.shape})"
    rays = args.width * args.height * args.spp
    print(f"{args.preset}: {args.width}x{args.height} spp={args.spp} "
          f"bounces={max_bounces} accelerator={args.accelerator} on "
          f"{name} — "
          f"{dt:.2f}s (one call: scene lowering and, on a first CUDA "
          f"run, the kernel build included), "
          f"{rays / dt / 1e6:.2f} Mrays/s")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    image.save(args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
