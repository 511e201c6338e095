"""Host-side image container and PNG output (utils/image.rs:5-111).

The framebuffer stays a tensor on its device until the end; this wrapper
only handles the host boundary: gamma (on the card for a CUDA
framebuffer, `from_linear`; numpy's otherwise), quantization, PNG encode.
`Image.save` writes through the port's native encoder (native/, built at
first use; a failed build raises). `encode_png` is its plain version in
the standard library (zlib + struct): the same 8-bit RGB, one IDAT
chunk, filter type 0 on every row, zlib level 6.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from tinyraytracer_tpu_torch.ops import tonemap
from tinyraytracer_tpu_torch.utils import profiling

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """PNG bytes of an (H, W, 3) uint8 array."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape} "
                         f"{rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _to_host(data, gamma):
    """(host array, the gamma still to apply) of a framebuffer: a CUDA
    tensor's gamma is applied on the card before the readback (None
    left); anything else comes back as it is, its gamma left to Image."""
    if hasattr(data, "detach"):
        data = data.detach()
        if data.device.type == "cuda" and gamma is not None:
            with profiling.annotate("tinyrt.render.gamma"):
                data = tonemap.gamma_cuda(data.float().contiguous(), gamma)
            gamma = None
        # the wait for the render (and the gamma), then the copy
        with profiling.annotate("tinyrt.render.readback"):
            data = data.cpu().numpy()
    return np.asarray(data), gamma


class Image:
    """Float image with optional gamma applied at construction, mirroring
    Image::new_with_gamma_correction (image.rs:29-36)."""

    def __init__(self, data: np.ndarray, gamma: Optional[float] = None):
        data = np.asarray(data, np.float32)
        if data.ndim != 3 or data.shape[-1] != 3:
            raise ValueError(f"expected (H, W, 3), got {data.shape}")
        if gamma is not None:
            with profiling.annotate("tinyrt.render.gamma"):
                data = np.maximum(data, 0.0) ** (1.0 / gamma)
        self._data = data

    @staticmethod
    def from_linear(data, gamma: float = tonemap.GAMMA) -> "Image":
        """From a linear (H, W, 3) framebuffer: numpy array or tensor on
        any device (copied to the host). A CUDA tensor's gamma runs on the
        card before the copy (`tonemap.gamma_cuda`); a CPU tensor's and an
        array's is numpy's, as `Image(data, gamma)` computes it."""
        data, gamma = _to_host(data, gamma)
        return Image(data, gamma=gamma)

    @staticmethod
    def from_linear_frames(frames, gamma: float = tonemap.GAMMA) -> list:
        """One Image a frame of a linear (N, H, W, 3) stack, each equal to
        `from_linear` of its frame, the stack brought to the host in one
        copy (after one gamma launch over it, for a CUDA tensor)."""
        frames, gamma = _to_host(frames, gamma)
        return [Image(f, gamma=gamma) for f in frames]

    @property
    def data(self) -> np.ndarray:
        return self._data

    def size(self) -> Tuple[int, int]:
        h, w, _ = self._data.shape
        return (w, h)

    def get_pixel(self, x: int, y: int) -> np.ndarray:
        return self._data[y, x]

    def to_u8(self) -> np.ndarray:
        return np.asarray(
            np.clip(self._data, 0.0, tonemap.INTENSITY_MAX) * 255.0, np.uint8
        )

    def save(self, filename: str) -> None:
        from tinyraytracer_tpu_torch.native import runtime

        runtime.write_png(filename, self.to_u8())
