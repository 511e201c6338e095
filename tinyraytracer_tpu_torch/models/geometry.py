"""Host-side geometry construction API.

The reference represents geometry as boxed trait objects (hittable/sphere.rs,
quad.rs) grouped by a missing-but-implied `HittableList` composite
(src/main.rs:89-125). Here geometry objects are lightweight descriptions that
World.build() lowers into SoA arrays. Identical to the JAX package's module
(numpy only), so both packages lower a scene to the same arrays, but for
`ConstantMedium`, which the port alone has.

`ConstantMedium` is Ray Tracing: The Next Week's participating medium
(`constant_medium`, section "Volumes"): a constant density inside a
boundary sphere, scattering with an isotropic phase function. A ray that
lies along the boundary sphere's line between its two roots t1 < t2 (t1
raised to T_MIN) samples a free-flight distance -ln(u) / density and hits
the medium at t1 + distance / |d| when that is below t2; the closest hit
is the least t over surfaces and media together, and a medium hit
scatters to a uniform unit direction, its throughput times the medium's
albedo, with no emission. Departures from the book:
- `u` is a counter-based draw, a pure function of (pixel, sample, bounce,
  the medium's ordinal, seed) (ops/megakernel.py `medium_stream`), not
  the book's next draw of a shared generator; u = 0 gives no hit, as the
  book's ln(0) = -inf does;
- the near root is raised to T_MIN (1e-3) where the book raises it to
  the ray's interval start and then to 0; the book's second boundary hit
  (the far root past t1 + 1e-4) is the far root itself, so a ray that
  only grazes the boundary (t1 >= t2 after the raise) misses;
- the hit is taken while strictly below t2, where the book takes it up
  to t2 inclusive;
- the boundary is a sphere only (the book takes any hittable), and the
  medium is added to the World itself, not inside a Group.
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


@dataclasses.dataclass(frozen=True)
class ConstantMedium:
    """A constant-density medium inside `boundary`, with an isotropic
    phase function of colour `albedo` (the book's `constant_medium` with
    an `isotropic` material; see the module's docstring for its
    semantics). The boundary gives only the shape: its material is not
    used, and the sphere is a surface too only where it is added as one
    (the book's glass ball that holds a medium). Only the megakernel K2
    renders media: `Renderer.render` routes a world that holds one there;
    the other entry points raise."""

    boundary: Sphere
    density: float
    albedo: Vec

    def __post_init__(self):
        if not isinstance(self.boundary, Sphere):
            raise ValueError("a ConstantMedium's boundary must be a Sphere, "
                             f"got {type(self.boundary).__name__}")
        d = float(self.density)
        if not np.isfinite(d) or d <= 0.0:
            raise ValueError(f"density must be finite and positive, got "
                             f"{self.density!r}")


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
