"""User-facing Renderer, mirroring the reference API surface.

Reference: `Renderer::new(samples_per_pixel, num_sampler_threads,
max_bounces, progressbar, background_color)` + `render(camera, world) ->
Image` (renderer/renderer.rs:21-79). Generation, tracing and accumulation
run in one megakernel launch per image (ops/megakernel.py);
`accelerator="none"` renders with the modular tracer (ops/trace.py)
instead, and `accelerator="bvh"` with the modular tracer selecting hits
by a BVH walk (ops/bvh.py), as the JAX package's do.

The device is named, never guessed: `device="cuda"` (the default) renders
with the CUDA kernel and raises where there is no CUDA device; a CPU
render runs the kernel's plain PyTorch twin and is asked for with
`device="cpu"`. `devices=[...]` with more than one entry renders over a
device mesh (parallel/sharded.py), as the JAX package's does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from tinyraytracer_tpu_torch.models.camera import Camera
from tinyraytracer_tpu_torch.models.world import SceneArrays, World
from tinyraytracer_tpu_torch.ops import tonemap
from tinyraytracer_tpu_torch.ops.bvh import build_bvh
from tinyraytracer_tpu_torch.ops.megakernel import MegakernelRenderer
from tinyraytracer_tpu_torch.parallel import sharded
from tinyraytracer_tpu_torch.utils.device import resolve_device
from tinyraytracer_tpu_torch.utils.image import Image
from tinyraytracer_tpu_torch.utils.progress import ProgressBar


class RenderHandle:
    """A render in flight: its device framebuffer and, on a CUDA device,
    an event recorded on the stream right after the kernel launch."""

    def __init__(self, fb: torch.Tensor, event):
        self._fb = fb
        self._event = event

    def done(self) -> bool:
        """Whether the render has finished, without waiting. A CPU render
        finished before the handle was made."""
        return self._event is None or self._event.query()

    def result(self) -> Image:
        """Waits for the render; returns the gamma-2.2 Image."""
        if self._event is not None:
            self._event.synchronize()
        return Image.from_linear(self._fb, gamma=tonemap.GAMMA)


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
        device=None,
    ):
        """`device` (default "cuda") is where a render runs. `devices`, a
        list of more than one device (it may repeat one), renders over a
        (tile x sample) mesh of them (parallel/sharded.py), with
        `sample_parallel` of them splitting each pixel's samples; the
        image lands on the first, and `device` may only name that one.
        samples_per_pixel must divide by sample_parallel, with or without
        a mesh (the JAX package's check)."""
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
        # "auto" and "megakernel": the megakernels (their twins on the
        # CPU); "bvh": the modular tracer with BVH selection; "none": the
        # modular tracer with dense selection (the oracle)
        if accelerator not in ("auto", "megakernel", "bvh", "none"):
            raise ValueError(f"unknown accelerator {accelerator!r}")
        self.accelerator = accelerator
        self.sample_parallel = int(sample_parallel) if sample_parallel else 1
        if self.samples_per_pixel % self.sample_parallel:
            raise ValueError(
                f"samples_per_pixel={self.samples_per_pixel} not divisible "
                f"by sample_parallel={self.sample_parallel}")
        self.mesh = None
        if devices is not None and len(devices) > 1:
            self.mesh = sharded.make_mesh(
                devices, sample_parallel=self.sample_parallel)
            if (device is not None
                    and resolve_device(device) != self.mesh.device):
                raise ValueError(f"device {device!r} is not the mesh's "
                                 f"first device {self.mesh.device}")
            self.device = self.mesh.device
        else:
            if device is None:
                device = devices[0] if devices else "cuda"
            self.device = resolve_device(device)

    def _sampler(self, camera: Camera, scene: SceneArrays):
        """f(spp, seed, spp_offset) -> (H, W, 3) mean radiance over samples
        [spp_offset, spp_offset + spp) on the device, over the renderer's
        mesh (the one-cell mesh of its device when it has none): the
        megakernels, or the modular tracer (ops/trace.py) with dense
        closest-hit selection (`accelerator="none"`) or with a BVH walk
        (`"bvh"`; the BVH is built here, once per sampler)."""
        mesh = self.mesh or sharded.one_cell(self.device)
        if self.accelerator not in ("none", "bvh"):
            mk = MegakernelRenderer(scene, camera, self.background_color,
                                    self.device)
            return lambda spp, seed, spp_offset=0: mk.render(
                spp=spp, max_bounces=self.max_bounces, seed=seed,
                spp_offset=spp_offset, mesh=mesh)
        bvh = None
        if self.accelerator == "bvh":
            bvh = build_bvh(scene).to(self.device)
        return lambda spp, seed, spp_offset=0: sharded.render_image_sharded(
            scene, camera, spp=spp, max_bounces=self.max_bounces,
            background=self.background_color, seed=seed, mesh=mesh,
            spp_offset=spp_offset, bvh=bvh)

    def render_array(self, camera: Camera, scene: SceneArrays) -> torch.Tensor:
        """Linear-radiance (H, W, 3) f32 framebuffer on the device."""
        return self._sampler(camera, scene)(self.samples_per_pixel,
                                            self.seed)

    def render(self, camera: Camera, world: World) -> Image:
        """Full render to a gamma-2.2 Image (the reference's end product)."""
        scene = world.build() if isinstance(world, World) else world
        if self.progressbar:
            fb = self._render_with_progress(camera, scene)
        else:
            fb = self.render_array(camera, scene)
        return Image.from_linear(fb, gamma=tonemap.GAMMA)

    def render_async(self, camera: Camera, world: World) -> "RenderHandle":
        """Start a render and return at once; the reference's
        `JoinHandle<Image>` (renderer/renderer.rs:37-79). The launch is
        queued on the current CUDA stream; `.result()` waits for it."""
        scene = world.build() if isinstance(world, World) else world
        fb = self.render_array(camera, scene)
        event = None
        if fb.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(fb.device))
        return RenderHandle(fb, event)

    def render_batch_array(self, camera: Camera, scene: SceneArrays,
                           seeds) -> torch.Tensor:
        """len(seeds) linear-radiance frames, (n, H, W, 3) f32 on the
        device, frame k bitwise equal to `render_array` with seed
        seeds[k]: the frames render one after another from one scene
        lowering (one BVH build on the BVH route)."""
        seeds = [int(s) for s in seeds]
        scene = scene.build() if isinstance(scene, World) else scene
        if not seeds:
            return torch.zeros((0, camera.height, camera.width, 3),
                               dtype=torch.float32, device=self.device)
        render = self._sampler(camera, scene)
        return torch.stack([render(self.samples_per_pixel, s)
                            for s in seeds])

    def render_batch(self, camera: Camera, world: World, seeds) -> list:
        """One gamma-2.2 Image per seed, each bitwise equal to `render`
        with that seed: `render_batch_array`'s frames, brought back in one
        host copy."""
        frames = self.render_batch_array(camera, world, seeds).cpu().numpy()
        return [Image.from_linear(f, gamma=tonemap.GAMMA) for f in frames]

    def _render_with_progress(self, camera: Camera, scene: SceneArrays):
        """Chunk samples into rounds (global sample ids [off, off + n)) so
        the host can tick a progress bar between launches. Over a mesh a
        round's samples stay divisible by the sample axis (and so, since
        spp is, does the last round's)."""
        spp = self.samples_per_pixel
        chunk = self.spp_per_round or max(1, spp // 20)
        if self.mesh is not None:
            n_sample = self.mesh.shape[sharded.SAMPLE_AXIS]
            chunk = max(n_sample, (chunk // n_sample) * n_sample)
        render = self._sampler(camera, scene)
        bar = ProgressBar(total=spp, label="spp")
        acc = torch.zeros((camera.height, camera.width, 3),
                          dtype=torch.float32, device=self.device)
        for off in range(0, spp, chunk):
            n = min(chunk, spp - off)
            part = render(n, self.seed, off)
            acc = acc + part * (n / spp)
            bar.update(n)
        bar.close()
        return acc
