"""4x4 affine transforms (math/transform.rs:10-111), port of
models/transform.py.

The matrix is a (4, 4) f32 tensor applied to homogeneous column vectors;
application to points is batched over any leading shape and
differentiable through autograd (a matrix that requires grad passes its
gradient back through `@`, `apply` and `apply_vector`). The reference
never wires Transform into a render path, but ships and tests it as
public API; so do both packages.

Devices follow the package's rule: the constructors build on the card
unless `device="cpu"` is asked for, and raise where there is no CUDA
device. A tensor given to `apply` or `apply_vector` is computed on where
it lies (the matrix comes to it); host data (lists, numpy) goes to the
matrix's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from tinyraytracer_tpu_torch.utils.device import resolve_device

Vec = Tuple[float, float, float]


def _eye(device) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=resolve_device(device))


@dataclasses.dataclass
class Transform:
    """Affine transform: `matrix` applies to homogeneous column vectors."""

    matrix: torch.Tensor  # (4, 4) f32

    # -- constructors (transform.rs:20-97) --------------------------------

    @staticmethod
    def identity(device="cuda") -> "Transform":
        return Transform(_eye(device))

    @staticmethod
    def translate(offset: Vec, device="cuda") -> "Transform":
        m = _eye(device)
        m[0:3, 3] = torch.as_tensor(offset, dtype=torch.float32,
                                    device=m.device)
        return Transform(m)

    @staticmethod
    def scale(factors: Vec, device="cuda") -> "Transform":
        return Transform(torch.diag(torch.as_tensor(
            list(factors) + [1.0], dtype=torch.float32,
            device=resolve_device(device))))

    @staticmethod
    def _rot(axis0: int, axis1: int, degrees: float, device) -> "Transform":
        r = math.radians(degrees)
        c, s = math.cos(r), math.sin(r)
        m = _eye(device)
        m[axis0, axis0], m[axis0, axis1] = c, -s
        m[axis1, axis0], m[axis1, axis1] = s, c
        return Transform(m)

    @staticmethod
    def rotate_x(degrees: float, device="cuda") -> "Transform":
        return Transform._rot(1, 2, degrees, device)

    @staticmethod
    def rotate_y(degrees: float, device="cuda") -> "Transform":
        # y-rotation has the transposed sign layout (transform.rs)
        return Transform._rot(2, 0, degrees, device)

    @staticmethod
    def rotate_z(degrees: float, device="cuda") -> "Transform":
        return Transform._rot(0, 1, degrees, device)

    @staticmethod
    def new(translation: Vec, scaling: Vec, rotation_degrees: Vec,
            device="cuda") -> "Transform":
        """T · S · Rz · Ry · Rx composition (transform.rs:20)."""
        t = Transform.translate(translation, device)
        s = Transform.scale(scaling, device)
        rx = Transform.rotate_x(rotation_degrees[0], device)
        ry = Transform.rotate_y(rotation_degrees[1], device)
        rz = Transform.rotate_z(rotation_degrees[2], device)
        return t @ s @ rz @ ry @ rx

    # -- operations -------------------------------------------------------

    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(self.matrix @ other.matrix)

    def _operand(self, x):
        """`x` as f32 where it lies (a tensor) or on the matrix's device
        (host data), with the matrix on that device."""
        dev = x.device if isinstance(x, torch.Tensor) else self.matrix.device
        return (torch.as_tensor(x, dtype=torch.float32, device=dev),
                self.matrix.to(dev))

    def apply(self, points) -> torch.Tensor:
        """Apply to (..., 3) points via homogeneous coordinates
        (transform.rs:99-111)."""
        p, m = self._operand(points)
        h = torch.cat([p, torch.ones(p.shape[:-1] + (1,), dtype=p.dtype,
                                     device=p.device)], dim=-1)
        out = h @ m.T
        return out[..., :3] / out[..., 3:4]

    def apply_vector(self, vectors) -> torch.Tensor:
        """Apply the linear part only (directions: no translation)."""
        v, m = self._operand(vectors)
        return v @ m[:3, :3].T

    def to(self, device) -> "Transform":
        return Transform(self.matrix.to(device))
