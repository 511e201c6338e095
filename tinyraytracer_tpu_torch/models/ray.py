"""Ray value type (ray.rs:4-27), batched (port of models/ray.py).

The tracer carries origins and directions as separate (R, 3) tensors;
this is the user-facing object for scripting and tests, keeping the
reference's rule that a direction is normalised when the ray is made
(ray.rs:13). `Ray.new` builds on the card unless `device="cpu"` is asked
for, and raises where there is no CUDA device. A tensor `t` given to
`at` is computed on where it lies (the ray comes to it); host data goes
to the ray's device.
"""

from __future__ import annotations

import dataclasses

import torch

from tinyraytracer_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Ray:
    origin: torch.Tensor     # (..., 3) f32
    direction: torch.Tensor  # (..., 3) f32, unit

    @staticmethod
    def new(origin, direction, device="cuda") -> "Ray":
        dev = resolve_device(device)
        o = torch.as_tensor(origin, dtype=torch.float32, device=dev)
        d = torch.as_tensor(direction, dtype=torch.float32, device=dev)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)  # ray.rs:13
        return Ray(o, d)

    def at(self, t) -> torch.Tensor:
        """origin + t * direction (ray.rs:24-26)."""
        dev = t.device if isinstance(t, torch.Tensor) else self.origin.device
        t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        return (self.origin.to(dev)
                + t[..., None] * self.direction.to(dev))

    def to(self, device) -> "Ray":
        return Ray(self.origin.to(device), self.direction.to(device))
