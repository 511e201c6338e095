"""Counter-based, placement-invariant RNG (PyTorch port of ops/rng.py).

Every random draw is a pure function of (seed, pixel_id, sample_id,
stream): the PCG4D hash (Jarzynski & Olano, "Hash Functions for GPU
Rendering", JCGT 2020). The words are bit-identical to the JAX package's
and to the CUDA kernel's, so a pixel's random stream never depends on
which framework, device or thread computes it.

PyTorch has no complete u32 arithmetic (``+`` and ``>>`` are missing on
``torch.uint32``), so the hash runs in int64 holding values in
[0, 2^32): every ``+``, ``*`` and ``>>`` is masked back to 32 bits. An
int64 product of two u32 values may wrap past 2^63, which leaves the low
32 bits intact. Words are returned as int64 tensors in [0, 2^32).
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_MUL = 1664525
_ADD = 1013904223
# 2^-24: map the top 24 bits of a u32 to [0, 1) (exact in f32).
_INV_2_24 = 1.0 / (1 << 24)
# f32(2*pi) = 6.2831855, the rounding JAX applies to 2.0 * jnp.pi.
_TWO_PI = 2.0 * math.pi


def _u32(x):
    # A Python int stays one: mixed with a tensor it rides along as a
    # kernel argument, where a device tensor made from it would cost a
    # host-to-device copy (and a synchronisation) per call.
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return int(x) & _MASK


def pcg4d(a, b, c, d):
    """PCG4D hash: four u32 counters -> four decorrelated u32 words.

    Inputs are tensors or Python ints and broadcast against each other.
    """
    dev = next((t.device for t in (a, b, c, d)
                if isinstance(t, torch.Tensor)), None)
    x, y, z, w = (_u32(t) for t in (a, b, c, d))

    x = (x * _MUL + _ADD) & _MASK
    y = (y * _MUL + _ADD) & _MASK
    z = (z * _MUL + _ADD) & _MASK
    w = (w * _MUL + _ADD) & _MASK

    x = (x + y * w) & _MASK
    y = (y + z * x) & _MASK
    z = (z + x * y) & _MASK
    w = (w + y * z) & _MASK

    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)

    x = (x + y * w) & _MASK
    y = (y + z * x) & _MASK
    z = (z + x * y) & _MASK
    w = (w + y * z) & _MASK
    return tuple(torch.as_tensor(v, dtype=torch.int64, device=dev)
                 for v in (x, y, z, w))


def _to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """u32 word -> f32 uniform in [0, 1) from its top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * _INV_2_24


def uniform4(seed, pixel_id, sample_id, stream):
    """Four independent f32 uniforms in [0, 1) per (seed, pixel, sample,
    stream); the same argument order as the JAX package's uniform4."""
    x, y, z, w = pcg4d(pixel_id, sample_id, stream, seed)
    return _to_uniform(x), _to_uniform(y), _to_uniform(z), _to_uniform(w)


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """x^(1/3) for x >= 0 as exp(log(x) * f32(1/3)), the form the kernels
    use (there is no cbrt in the TPU kernel language, and keeping one form
    keeps scatter directions identical across every path)."""
    return torch.exp(torch.log(torch.clamp_min(x, 1e-30)) * (1.0 / 3.0))


def uniform_in_unit_sphere(u1, u2, u3) -> torch.Tensor:
    """Uniform point in the unit ball by inverse CDF: theta = 2*pi*u1,
    cos(phi) = 1 - 2*u2, r = cbrt(u3). Returns (..., 3)."""
    theta = _TWO_PI * u1
    cos_phi = 1.0 - 2.0 * u2
    sin_phi = torch.sqrt(torch.clamp_min(1.0 - cos_phi * cos_phi, 0.0))
    r = cbrt(u3)
    x = r * sin_phi * torch.cos(theta)
    y = r * sin_phi * torch.sin(theta)
    z = r * cos_phi
    return torch.stack([x, y, z], dim=-1)


def uniform_unit_vector(u1, u2) -> torch.Tensor:
    """Uniform direction on the unit sphere (the ball sampler at r = 1).
    Returns (..., 3)."""
    theta = _TWO_PI * u1
    cos_phi = 1.0 - 2.0 * u2
    sin_phi = torch.sqrt(torch.clamp_min(1.0 - cos_phi * cos_phi, 0.0))
    x = sin_phi * torch.cos(theta)
    y = sin_phi * torch.sin(theta)
    return torch.stack([x, y, cos_phi], dim=-1)


def uniform_in_unit_disk(u1, u2) -> torch.Tensor:
    """Uniform point in the unit disk, polar form r = sqrt(u1),
    theta = 2*pi*u2. Returns (..., 2)."""
    r = torch.sqrt(u1)
    theta = _TWO_PI * u2
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
