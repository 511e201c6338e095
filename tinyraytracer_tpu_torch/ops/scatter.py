"""Branchless material scatter (port of ops/scatter.py).

Every ray evaluates all four lobes with vector math and selects by
material kind:

  - Lambertian: dir = normal + uniform unit vector, with fallback to the
    normal when the sum is near zero, |comp| < 1e-7;
  - Metal: dir = reflect(d, n) + fuzz * uniform-in-ball;
  - Dielectric: eta by front face, Schlick reflectance, TIR-or-
    probabilistic reflect vs refract, attenuation = albedo;
  - Light: absorbs.

Returned directions are normalized.
"""

from __future__ import annotations

import torch

from tinyraytracer_tpu_torch.models import materials as mat
from tinyraytracer_tpu_torch.ops import rng
from tinyraytracer_tpu_torch.ops.intersect import (
    HitRecord,
    const,
    maximum,
    minimum,
)


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def reflect(d, n):
    """v - 2 (v.n) n."""
    return d - 2.0 * _dot(d, n) * n


def refract(d, n, eta):
    """Snell refraction with the cos clamp. eta: (R, 1); d, n unit (R, 3).
    The sqrt argument is floored at 1e-12: at grazing incidence its
    derivative is infinite, and every ray evaluates every lobe before the
    select, so that infinity would leak NaN into unrelated gradients."""
    cos = minimum(-_dot(n, d), 1.0)
    perp = eta * (d + n * cos)
    k = torch.abs(1.0 - torch.sum(perp * perp, dim=-1, keepdim=True))
    parallel = -torch.sqrt(maximum(k, 1e-12)) * n
    return parallel + perp


def _schlick(cos, eta):
    """Schlick reflectance with the reference's eta convention; (1-cos)^5
    as x2*x2*x, XLA's integer_pow order."""
    sqrt_r0 = (1.0 - eta) / (1.0 + eta)
    r0 = sqrt_r0 * sqrt_r0
    x = 1.0 - cos
    x2 = x * x
    return r0 + (1.0 - r0) * (x2 * x2 * x)


def scatter(d, rec: HitRecord, seed, pixel_id, sample_id, bounce: int):
    """Scatter a ray batch off its hit records.

    d: (R,3) incoming unit directions. Returns (new_dir (R,3) unit,
    attenuation (R,3), absorbed (R,) bool). Randomness is drawn from the
    counter-based stream 1 + bounce (the camera ray uses stream 0)."""
    u1, u2, u3, u4 = rng.uniform4(seed, pixel_id, sample_id, bounce + 1)
    in_ball = rng.uniform_in_unit_sphere(u1, u2, u3)           # (R,3)
    ball_norm = torch.sqrt(maximum(
        torch.sum(in_ball * in_ball, dim=-1, keepdim=True), 1e-24))
    unit = in_ball / ball_norm

    n = rec.normal

    lam_dir = n + unit
    degenerate = torch.all(torch.abs(lam_dir) < 1e-7, dim=-1, keepdim=True)
    lam_dir = torch.where(degenerate, n, lam_dir)

    met_dir = reflect(d, n) + rec.fuzz[:, None] * in_ball

    eta = torch.where(rec.front_face, 1.0 / rec.ior, rec.ior)[:, None]
    cos = minimum(-_dot(n, d), 1.0)
    sin = torch.sqrt(torch.maximum(const(0.0, cos), 1.0 - cos * cos))
    total_reflection = eta * sin > 1.0
    reflectance = _schlick(cos, eta)
    choose_reflect = total_reflection | (reflectance > u4[:, None])
    die_dir = torch.where(choose_reflect, reflect(d, n), refract(d, n, eta))

    kind = rec.mat_kind[:, None]
    new_dir = torch.where(kind == mat.LAMBERTIAN, lam_dir,
                          torch.where(kind == mat.METAL, met_dir, die_dir))
    new_dir = new_dir / torch.sqrt(maximum(
        torch.sum(new_dir * new_dir, dim=-1, keepdim=True), 1e-24))
    attenuation = rec.albedo
    absorbed = rec.mat_kind == mat.LIGHT
    return new_dir, attenuation, absorbed
