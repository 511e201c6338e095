"""Material model.

The reference's four materials (material/lambertian.rs, metal.rs,
dielectric.rs, light.rs) are trait objects dispatched per hit. Here every
material is one row of a *material table* {kind, albedo, fuzz, ior,
emission}; the megakernel evaluates the scatter lobes of the kinds present
and selects by kind (see ops/megakernel.py).

These host-side classes are the user-facing construction API; World.build()
packs them into the table. Same codes and values as the JAX package, and
one more that it lacks: ISOTROPIC, the phase function of a
`geometry.ConstantMedium`, which no surface takes (K2's medium rows
carry it).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

Vec = Tuple[float, float, float]

# Material kind codes (the "enum" of the material table).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
LIGHT = 3
# A medium's phase function: scatter to a uniform unit direction, times
# the medium's albedo, no emission (the book's `isotropic`).
ISOTROPIC = 4


@dataclasses.dataclass(frozen=True)
class Material:
    kind: int = LAMBERTIAN
    albedo: Vec = (0.0, 0.0, 0.0)
    fuzz: float = 0.0
    ior: float = 1.0
    emission: Vec = (0.0, 0.0, 0.0)


def Lambertian(albedo: Vec) -> Material:
    """Diffuse: scatter dir = normal + uniform unit vector
    (lambertian.rs:16-22), degenerate-direction fallback to the normal."""
    return Material(kind=LAMBERTIAN, albedo=tuple(albedo))


def Metal(albedo: Vec, fuzz: float = 0.0) -> Material:
    """Specular: reflect + fuzz * uniform-in-sphere (metal.rs:18-25);
    fuzz clamped to [0, 1] at construction (metal.rs:13)."""
    return Material(kind=METAL, albedo=tuple(albedo), fuzz=min(max(float(fuzz), 0.0), 1.0))


def Dielectric(albedo: Vec, refraction_index: float) -> Material:
    """Glass: Schlick reflectance, total-internal-reflection, probabilistic
    reflect-vs-refract, tinted by albedo (dielectric.rs:26-46)."""
    return Material(kind=DIELECTRIC, albedo=tuple(albedo), ior=float(refraction_index))


def Light(color: Vec) -> Material:
    """Emitter: absorbs (scatter = None), emits `color` (light.rs:17-23)."""
    return Material(kind=LIGHT, emission=tuple(color))
