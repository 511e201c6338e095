"""tinyraytracer_tpu_torch — the path tracer in PyTorch, with its forward
megakernel hand-written in CUDA for NVIDIA Hopper (sm_90a).

A port of the JAX package `tinyraytracer_tpu`, which stays the reference
it is tested against. This package imports neither JAX nor the JAX
package. Implemented so far: the scene API (cameras, spheres, quads,
groups, materials, worlds, presets), the forward render path
(`Renderer.render` -> scene lowering -> the packed megakernel for scenes
of up to 48 primitives, the classic-layout megakernel above -> gamma-2.2
`Image` -> PNG), `Renderer.render_batch` and `Renderer.render_async`, and
the CLI (`python -m tinyraytracer_tpu_torch`).

A CUDA device renders with the CUDA kernel (csrc/, built with nvcc at
first use); `device="cpu"` renders with the kernel's plain PyTorch twin.
"""

from tinyraytracer_tpu_torch.models.camera import Camera
from tinyraytracer_tpu_torch.models.geometry import Group, Quad, Sphere, make_box
from tinyraytracer_tpu_torch.models.materials import (
    Dielectric,
    Lambertian,
    Light,
    Metal,
)
from tinyraytracer_tpu_torch.models.world import (
    SceneArrays,
    World,
    scene_from_numpy,
)
from tinyraytracer_tpu_torch.renderer import Renderer, RenderHandle
from tinyraytracer_tpu_torch.utils.image import Image

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Sphere",
    "Quad",
    "Group",
    "make_box",
    "Lambertian",
    "Metal",
    "Dielectric",
    "Light",
    "World",
    "SceneArrays",
    "scene_from_numpy",
    "Renderer",
    "RenderHandle",
    "Image",
]
