"""Gamma correction and quantization (utils/image.rs:92-110).

The reference applies gamma at set_pixel time (image.rs:38-44) and
quantizes with clamp to [0, 0.999] * 255 at save (image.rs:101-110).
Both are elementwise maps on tensors of any device.
"""

from __future__ import annotations

import torch

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
