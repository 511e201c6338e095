"""PCG4D counter-based RNG in plain PyTorch: the benchmark's own copy.

Every draw is a pure function of (seed, pixel id, sample id, stream):
the PCG4D hash (Jarzynski & Olano, "Hash Functions for GPU Rendering",
JCGT 2020), four u32 words mapped to uniforms in [0, 1) from their top
24 bits. The hash runs in int64 holding values in [0, 2^32), every
``+``, ``*`` and ``>>`` masked back to 32 bits (an int64 product of two
u32 values may wrap past 2^63, which keeps the low 32 bits intact).
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_MUL = 1664525
_ADD = 1013904223
_INV_2_24 = 1.0 / (1 << 24)


def _u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return int(x) & MASK


def pcg4d(a, b, c, d):
    """Four u32 counters (tensors or ints, broadcast) -> four u32 words
    as int64 tensors."""
    dev = next((t.device for t in (a, b, c, d)
                if isinstance(t, torch.Tensor)), None)
    x, y, z, w = (_u32(t) for t in (a, b, c, d))
    x = (x * _MUL + _ADD) & MASK
    y = (y * _MUL + _ADD) & MASK
    z = (z * _MUL + _ADD) & MASK
    w = (w * _MUL + _ADD) & MASK
    x = (x + y * w) & MASK
    y = (y + z * x) & MASK
    z = (z + x * y) & MASK
    w = (w + y * z) & MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = (x + y * w) & MASK
    y = (y + z * x) & MASK
    z = (z + x * y) & MASK
    w = (w + y * z) & MASK
    return tuple(torch.as_tensor(v, dtype=torch.int64, device=dev)
                 for v in (x, y, z, w))


def uniform4(seed, pixel_id, sample_id, stream, dtype=torch.float32):
    """Four uniforms in [0, 1) per (seed, pixel, sample, stream), exact in
    f32 (24 bits), then rounded to `dtype`."""
    words = pcg4d(pixel_id, sample_id, stream, seed)
    return tuple(((v >> 8).to(torch.float32) * _INV_2_24).to(dtype)
                 for v in words)
