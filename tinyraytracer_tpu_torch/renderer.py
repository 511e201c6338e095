"""User-facing Renderer, mirroring the reference API surface.

Reference: `Renderer::new(samples_per_pixel, num_sampler_threads,
max_bounces, progressbar, background_color)` + `render(camera, world) ->
Image` (renderer/renderer.rs:21-79). Generation, tracing and accumulation
run in one megakernel launch per image (ops/megakernel.py).

The device is named, never guessed: `device="cuda"` (the default) renders
with the CUDA kernel and raises where there is no CUDA device; a CPU
render runs the kernel's plain PyTorch twin and is asked for with
`device="cpu"`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from tinyraytracer_tpu_torch.models.camera import Camera
from tinyraytracer_tpu_torch.models.world import SceneArrays, World
from tinyraytracer_tpu_torch.ops import tonemap
from tinyraytracer_tpu_torch.ops.megakernel import MegakernelRenderer
from tinyraytracer_tpu_torch.utils.image import Image
from tinyraytracer_tpu_torch.utils.progress import ProgressBar


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device that this machine does
    not have raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available on this "
            "machine; pass device='cpu' to render with the PyTorch twin")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class Renderer:
    def __init__(
        self,
        samples_per_pixel: int,
        num_sampler_threads: int = 0,  # accepted for API parity; unused
        max_bounces: int = 20,
        progressbar: bool = False,
        background_color: Optional[Tuple[float, float, float]] = None,
        seed: int = 0,
        devices: Optional[Sequence] = None,
        spp_per_round: int = 0,
        accelerator: str = "auto",
        sample_parallel: int = 1,
        device="cuda",
    ):
        self.samples_per_pixel = int(samples_per_pixel)
        self.max_bounces = int(max_bounces)
        self.progressbar = bool(progressbar)
        # default background is black (renderer.rs:33); a ((r,g,b),
        # (r,g,b)) pair is a gradient sky [bottom, top]
        self.background_color = (
            (0.0, 0.0, 0.0) if background_color is None
            else tuple(background_color)
        )
        self.seed = int(seed)
        self.spp_per_round = int(spp_per_round) if spp_per_round else 0
        if accelerator not in ("auto", "megakernel", "bvh", "none"):
            raise ValueError(f"unknown accelerator {accelerator!r}")
        if accelerator in ("bvh", "none"):
            raise NotImplementedError(
                f"accelerator={accelerator!r} needs the modular path "
                "(ops/trace.py, ops/bvh.py), which is not ported yet")
        self.accelerator = accelerator
        if devices is not None and len(devices) > 1:
            raise NotImplementedError(
                "multi-device rendering (parallel/sharded.py) is not "
                "ported yet")
        if sample_parallel and int(sample_parallel) > 1:
            raise NotImplementedError(
                "sample_parallel > 1 needs multi-device rendering, which "
                "is not ported yet")
        self.device = resolve_device(device)

    def render_array(self, camera: Camera, scene: SceneArrays) -> torch.Tensor:
        """Linear-radiance (H, W, 3) f32 framebuffer on the device."""
        mk = MegakernelRenderer(scene, camera, self.background_color,
                                self.device)
        return mk.render(spp=self.samples_per_pixel,
                         max_bounces=self.max_bounces, seed=self.seed)

    def render(self, camera: Camera, world: World) -> Image:
        """Full render to a gamma-2.2 Image (the reference's end product)."""
        scene = world.build() if isinstance(world, World) else world
        if self.progressbar:
            fb = self._render_with_progress(camera, scene)
        else:
            fb = self.render_array(camera, scene)
        return Image.from_linear(fb, gamma=tonemap.GAMMA)

    def render_async(self, camera: Camera, world: World):
        raise NotImplementedError("render_async is not ported yet")

    def render_batch(self, camera: Camera, world: World, seeds):
        raise NotImplementedError("render_batch is not ported yet")

    def _render_with_progress(self, camera: Camera, scene: SceneArrays):
        """Chunk samples into rounds (global sample ids [off, off + n)) so
        the host can tick a progress bar between launches."""
        spp = self.samples_per_pixel
        chunk = self.spp_per_round or max(1, spp // 20)
        mk = MegakernelRenderer(scene, camera, self.background_color,
                                self.device)
        bar = ProgressBar(total=spp, label="spp")
        acc = torch.zeros((camera.height, camera.width, 3),
                          dtype=torch.float32, device=self.device)
        for off in range(0, spp, chunk):
            n = min(chunk, spp - off)
            part = mk.render(spp=n, max_bounces=self.max_bounces,
                             seed=self.seed, spp_offset=off)
            acc = acc + part * (n / spp)
            bar.update(n)
        bar.close()
        return acc
