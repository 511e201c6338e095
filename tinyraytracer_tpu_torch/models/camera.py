"""Thin-lens camera with defocus blur (port of models/camera.py).

Reproduces the reference camera (camera.rs:16-71): viewport from vertical
fov + focus distance, orthonormal basis w = pos - look_at, u = up x w,
v = w x u, viewport origin at the *upper-left*, v axis flipped, and
defocus-disk depth of field. The frame is computed in f32 with the JAX
package's op order (explicit cross products and sqrt-of-sum norms), so the
fields agree with it to an ulp. `Camera.new` builds the frame on the host
as CPU tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Tuple

import numpy as np
import torch

from tinyraytracer_tpu_torch.ops import rng

_VEC_FIELDS = ("position", "viewport_upper_left", "forward", "horizontal",
               "vertical", "defocus_disk_u", "defocus_disk_v")


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt((v * v).sum())


@dataclasses.dataclass
class Camera:
    """Precomputed camera frame: seven (3,) f32 tensors and the image
    size in pixels."""

    position: torch.Tensor
    viewport_upper_left: torch.Tensor
    forward: torch.Tensor            # w * focus_distance
    horizontal: torch.Tensor         # u * viewport_width
    vertical: torch.Tensor           # v * viewport_height
    defocus_disk_u: torch.Tensor
    defocus_disk_v: torch.Tensor
    width: int = 0
    height: int = 0

    @staticmethod
    def new(
        focus_distance: float,
        defocus_angle: float,
        position: Tuple[float, float, float],
        look_at: Tuple[float, float, float],
        up: Tuple[float, float, float],
        vertical_fov: float,
        width: int,
        height: int,
    ) -> "Camera":
        """Same signature and math as Camera::new (camera.rs:16-56)."""
        position = torch.tensor(position, dtype=torch.float32)
        look_at = torch.tensor(look_at, dtype=torch.float32)
        up = torch.tensor(up, dtype=torch.float32)

        viewport_height = (2.0 * focus_distance
                           * math.tan(math.radians(vertical_fov) / 2.0))
        aspect_ratio = width / height
        viewport_width = aspect_ratio * viewport_height

        w = _normalize(position - look_at)
        u = _normalize(_cross(up, w))
        v = _normalize(_cross(w, u))

        forward = w * focus_distance
        horizontal = u * viewport_width
        vertical = v * viewport_height
        viewport_upper_left = (position - horizontal / 2.0
                               + vertical / 2.0 - forward)

        defocus_radius = focus_distance * math.tan(
            math.radians(defocus_angle) / 2.0)
        return Camera(
            position=position,
            viewport_upper_left=viewport_upper_left,
            forward=forward,
            horizontal=horizontal,
            vertical=vertical,
            defocus_disk_u=u * defocus_radius,
            defocus_disk_v=v * defocus_radius,
            width=width,
            height=height,
        )

    @staticmethod
    def from_numpy(fields: Mapping[str, np.ndarray], width: int,
                   height: int) -> "Camera":
        """A camera from its seven (3,) f32 fields keyed by name (the JAX
        package's Camera leaves, for example), kept bit for bit."""
        vals = {}
        for name in _VEC_FIELDS:
            a = np.asarray(fields[name])
            if a.shape != (3,) or a.dtype != np.float32:
                raise ValueError(f"{name}: expected (3,) float32, got "
                                 f"{a.shape} {a.dtype}")
            vals[name] = torch.from_numpy(a.copy())
        return Camera(**vals, width=int(width), height=int(height))

    def to(self, device) -> "Camera":
        """The same camera with its fields on `device`."""
        return dataclasses.replace(
            self, **{n: getattr(self, n).to(device) for n in _VEC_FIELDS})

    def get_image_size(self) -> Tuple[int, int]:
        return (self.width, self.height)

    def get_ray(self, u: torch.Tensor, v: torch.Tensor, disk: torch.Tensor):
        """Rays through unit viewport coords (u, v) with defocus offsets
        (camera.rs:58-66): u, v are (...,), disk is (..., 2) points in the
        unit disk. Returns (origin, unit direction), each (..., 3)."""
        origin = (self.position
                  + disk[..., 0:1] * self.defocus_disk_u
                  + disk[..., 1:2] * self.defocus_disk_v)
        target = (self.viewport_upper_left
                  + u[..., None] * self.horizontal
                  - v[..., None] * self.vertical)
        direction = target - origin
        direction = direction / torch.sqrt(torch.clamp_min(
            (direction * direction).sum(-1, keepdim=True), 1e-24))
        return origin, direction


def generate_rays(camera: Camera, pixel_id: torch.Tensor, sample_id, seed):
    """Jittered primary rays for flat pixel ids y*width + x (pointgen.rs:
    38-51), on the device of `pixel_id` (the camera must be there too).

    Jitter is u = (x + r1)/(width-1), v = (y + r2)/(height-1), the
    reference's normalization, with max(., 1) guarding 1-pixel images.
    """
    pixel_id = pixel_id.to(torch.int64)
    px = (pixel_id % camera.width).to(torch.float32)
    py = (pixel_id // camera.width).to(torch.float32)
    r1, r2, r3, r4 = rng.uniform4(seed, pixel_id, sample_id, 0)
    u = (px + r1) / float(max(camera.width - 1, 1))
    v = (py + r2) / float(max(camera.height - 1, 1))
    disk = rng.uniform_in_unit_disk(r3, r4)
    return camera.get_ray(u, v, disk)
