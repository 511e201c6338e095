"""tinyraytracer_tpu_torch — the path tracer in PyTorch, with its kernels
hand-written in CUDA for NVIDIA Hopper (sm_90a).

A port of the JAX package `tinyraytracer_tpu`, which stays the reference
it is tested against. This package imports neither JAX nor the JAX
package. It has:

- the scene API: cameras, spheres, quads, groups, materials, worlds,
  presets; participating media (`ConstantMedium`: a constant density
  inside a sphere, an isotropic phase; rendered by K2 alone); the `Ray`
  and `Transform` value types;
- the forward render path: `Renderer.render` -> scene lowering -> the
  packed megakernel (K1) for scenes of up to 48 primitives, the
  classic-layout megakernel (K2) above -> gamma-2.2 `Image` -> PNG;
  `Renderer.render_batch_array`, `render_batch` and `render_async`; the
  CLI (`python -m tinyraytracer_tpu_torch`, with `--accelerator` and
  `--profile DIR`: a torch.profiler trace, utils/profiling.py);
- the BVH accelerator (`ops/bvh.py`: a numpy build, a plain PyTorch walk):
  `Renderer(accelerator="bvh")` and `bvh=` on the modular tracer's
  `trace`/`render_pixels`/`render_image` and on `render_image_sharded`;
- the modular differentiable path (`ops/trace.py`, `diff/`: the training
  loss, `make_train_step`, `fit(engine="modular")`), its closest-hit
  selection on kernel K3;
- the fused training path: `make_fused_train_step` and
  `fit(engine="fused"|"auto")`, one launch of the fused differentiable
  kernel K5 (small scenes) or K4 (the rest, and row-subset surrogates)
  per step;
- sharded rendering and training over a (tile x sample) device mesh
  (`parallel/sharded.py`: `Renderer(devices=, sample_parallel=)`,
  `render_image_sharded`, and `mesh=` on the megakernels and every train
  step), in one process or over a torch.distributed process group.

A CUDA device renders with the CUDA kernels (csrc/, built with nvcc at
first use); `device="cpu"` runs each kernel's plain PyTorch twin.
"""

from tinyraytracer_tpu_torch.models.camera import Camera
from tinyraytracer_tpu_torch.models.geometry import (
    ConstantMedium,
    Group,
    Quad,
    Sphere,
    make_box,
)
from tinyraytracer_tpu_torch.models.materials import (
    Dielectric,
    Lambertian,
    Light,
    Metal,
)
from tinyraytracer_tpu_torch.models.ray import Ray
from tinyraytracer_tpu_torch.models.transform import Transform
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
    "ConstantMedium",
    "Lambertian",
    "Metal",
    "Dielectric",
    "Light",
    "Ray",
    "Transform",
    "World",
    "SceneArrays",
    "scene_from_numpy",
    "Renderer",
    "RenderHandle",
    "Image",
]
