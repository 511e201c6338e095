"""Gamma correction and quantization (utils/image.rs:92-110).

The reference applies gamma at set_pixel time (image.rs:38-44) and
quantizes with clamp to [0, 0.999] * 255 at save (image.rs:101-110).
`gamma_correct` and `to_u8` are elementwise maps on tensors of any device.

`gamma_cuda` is the render's gamma on the card (csrc/gamma.cu), which
`Image.from_linear` takes for a CUDA framebuffer before the readback:
each value max(x, 0) ** float32(1 / gamma) in double precision, rounded
once to float32. `gamma_reference` is its plain twin in numpy. Each launch
adds one to the host counter `launches.gamma` (utils/profiling.py).
"""

from __future__ import annotations

import numpy as np
import torch

from tinyraytracer_tpu_torch import _build
from tinyraytracer_tpu_torch.utils import profiling

GAMMA = 2.2  # renderer/imager.rs:40
INTENSITY_MAX = 0.999  # image.rs:104


def gamma_correct(img: torch.Tensor, gamma: float = GAMMA) -> torch.Tensor:
    """c^(1/gamma), with negatives clamped (radiance is non-negative)."""
    return torch.clamp_min(img, 0.0) ** (1.0 / gamma)


def to_u8(img_gamma: torch.Tensor) -> torch.Tensor:
    """Quantize gamma-corrected floats to u8 with the reference's clamp
    (image.rs:101-110; Rust `as u8` truncates, as does the cast)."""
    return (torch.clamp(img_gamma, 0.0, INTENSITY_MAX) * 255.0).to(
        torch.uint8)


def inv_gamma(gamma: float) -> np.float32:
    """The exponent numpy raises a float32 image to for `** (1.0 / gamma)`
    (a Python float next to a float32 array is cast to float32)."""
    return np.float32(1.0 / gamma)


def gamma_reference(img: np.ndarray, gamma: float = GAMMA) -> np.ndarray:
    """`gamma_cuda`'s plain twin: np.maximum(img, 0) ** inv_gamma(gamma) in
    float64, rounded once to float32."""
    m = np.maximum(np.asarray(img, np.float32), 0).astype(np.float64)
    return (m ** np.float64(inv_gamma(gamma))).astype(np.float32)


def gamma_cuda(fb: torch.Tensor, gamma: float = GAMMA) -> torch.Tensor:
    """The gamma of a linear framebuffer on its CUDA device, by the kernel
    of csrc/gamma.cu on the current stream, into a new tensor (`fb` is
    left as it was); the values of `gamma_reference`. `fb`: a contiguous
    float32 (H, W, 3) image or (N, H, W, 3) stack of them. Raises
    ValueError for another dtype, shape or layout or a tensor off CUDA,
    RuntimeError if the launch fails."""
    if fb.dtype != torch.float32:
        raise ValueError(f"gamma_cuda needs float32, got {fb.dtype}")
    if fb.ndim not in (3, 4) or fb.shape[-1] != 3:
        raise ValueError(f"gamma_cuda needs (H, W, 3) or (N, H, W, 3), got "
                         f"{tuple(fb.shape)}")
    if not fb.is_contiguous():
        raise ValueError("gamma_cuda needs a contiguous tensor")
    if fb.device.type != "cuda":
        raise ValueError(f"gamma_cuda needs a CUDA tensor, got {fb.device}")
    lib = _build.load()
    out = torch.empty_like(fb)
    with torch.cuda.device(fb.device):
        stream = torch.cuda.current_stream(fb.device).cuda_stream
        err = lib.tinyrt_gamma(fb.data_ptr(), out.data_ptr(), fb.numel(),
                               float(inv_gamma(gamma)), stream)
    if err != 0:
        msg = lib.tinyrt_error_string(err).decode()
        raise RuntimeError(f"gamma launch failed: CUDA error {err} ({msg})")
    profiling.count("launches.gamma")
    return out
