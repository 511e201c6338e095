"""Host-side geometry construction API.

The reference represents geometry as boxed trait objects (hittable/sphere.rs,
quad.rs) grouped by a missing-but-implied `HittableList` composite
(src/main.rs:89-125). Here geometry objects are lightweight descriptions that
World.build() lowers into SoA arrays. Identical to the JAX package's module
(numpy only), so both packages lower a scene to the same arrays.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple, Union

import numpy as np

Vec = Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class Sphere:
    """center/radius sphere (hittable/sphere.rs:8-27)."""

    center: Vec
    radius: float
    material: str


@dataclasses.dataclass(frozen=True)
class Quad:
    """Parallelogram: corner + edge vectors u, v (hittable/quad.rs:8-31).

    The derived plane quantities n = u x v, w = n/(n.n), d = n.corner are
    computed at scene lowering (ops/scene_table.py), so only the defining
    vectors are stored here.
    """

    corner: Vec
    u: Vec
    v: Vec
    material: str


@dataclasses.dataclass(frozen=True)
class Group:
    """Composite of hittables — the reference's implied `HittableList`
    (src/main.rs:3,89-125): hit = closest over members. Lowering simply
    splices the members into the global SoA arrays."""

    members: Tuple[Union["Sphere", "Quad", "Group"], ...]

    @staticmethod
    def of(members: Sequence[Union["Sphere", "Quad", "Group"]]) -> "Group":
        return Group(tuple(members))


Geometry = Union[Sphere, Quad, Group]


def make_box(a: Vec, b: Vec, material: str) -> Group:
    """Axis-aligned box as a 6-quad Group, mirroring the reference scene
    helper `new_box` (src/main.rs:89-125)."""
    mn = np.minimum(np.asarray(a, np.float32), np.asarray(b, np.float32))
    mx = np.maximum(np.asarray(a, np.float32), np.asarray(b, np.float32))
    dx = (float(mx[0] - mn[0]), 0.0, 0.0)
    dy = (0.0, float(mx[1] - mn[1]), 0.0)
    dz = (0.0, 0.0, float(mx[2] - mn[2]))
    ndx = (-dx[0], 0.0, 0.0)
    ndz = (0.0, 0.0, -dz[2])
    mnx, mny, mnz = (float(mn[0]), float(mn[1]), float(mn[2]))
    mxx, mxy, mxz = (float(mx[0]), float(mx[1]), float(mx[2]))
    return Group(
        (
            Quad((mnx, mny, mxz), dx, dy, material),   # front  (+z)
            Quad((mxx, mny, mxz), ndz, dy, material),  # right
            Quad((mxx, mny, mnz), ndx, dy, material),  # back   (-z)
            Quad((mnx, mny, mnz), dz, dy, material),   # left
            Quad((mnx, mxy, mxz), dx, ndz, material),  # top
            Quad((mnx, mny, mnz), dx, dz, material),   # bottom
        )
    )


def flatten_geometry(geoms: Sequence[Geometry]) -> Tuple[List[Sphere], List[Quad]]:
    """Lower a geometry list (with nested Groups) to flat sphere/quad lists."""
    spheres: List[Sphere] = []
    quads: List[Quad] = []
    stack = list(geoms)[::-1]
    while stack:
        g = stack.pop()
        if isinstance(g, Sphere):
            spheres.append(g)
        elif isinstance(g, Quad):
            quads.append(g)
        elif isinstance(g, Group):
            stack.extend(reversed(g.members))
        else:
            raise TypeError(f"unknown geometry {type(g)!r}")
    return spheres, quads
