"""The port's native host library: src/tinyrt.cpp's threaded BVH builder
and PNG encoder, compiled with g++ at first use and loaded with ctypes.

`bvh_build` and `write_png` are the JAX package's native entry points
(its native/runtime.py) over the port's own copy of the source; the port
never loads the JAX package's library. The library is built into
tinyraytracer_tpu_torch/_build/ (gitignored, beside the CUDA kernels')
through the kernels' build cache (`_build.hashed_path`, `cached_build`,
`load_once`): the name carries a hash of the source and the flags, so a
changed source builds anew, and concurrent builders (test workers) each
write a temporary file and `os.replace` it.

There is no quiet fallback: if the compiler or zlib's header is missing
or the build fails, the compiler's error is raised. The numpy builder is
`ops.bvh.build_bvh(scene, use_native=False)`; `utils.image.encode_png`
encodes in Python.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from tinyraytracer_tpu_torch import _build

SRC = Path(__file__).resolve().parent / "src" / "tinyrt.cpp"
FLAGS = ["-std=c++17", "-O3", "-fPIC", "-shared"]
LIBS = ["-lz"]


def cxx_path() -> str:
    """The C++ compiler: $CXX, else g++ on $PATH."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler ($CXX unset, no g++ on $PATH): "
                           "the native BVH builder and PNG encoder cannot "
                           "be built; build_bvh(scene, use_native=False) "
                           "takes the numpy builder")
    return cxx


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    return _build.hashed_path("tinyrt_native", FLAGS + LIBS, [SRC])


def build() -> Path:
    """Compile src/tinyrt.cpp unless the library for it exists; returns
    its path. Raises with the compiler's output if the build fails."""
    def make(tmp):
        cmd = [cxx_path(), *FLAGS, "-o", str(tmp), str(SRC), *LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"native build failed: {' '.join(cmd)}: {e}; "
                               "build_bvh(scene, use_native=False) takes the "
                               "numpy builder") from e
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed with code "
                               f"{proc.returncode}: {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}"
                               "build_bvh(scene, use_native=False) takes the "
                               "numpy builder")
        return None
    return _build.cached_build(library_path(), make)


def _declare(lib: ctypes.CDLL) -> None:
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.tinyrt_bvh_build.argtypes = [fp, fp, ctypes.c_int, fp, fp, ip, ip,
                                     ip]
    lib.tinyrt_bvh_build.restype = ctypes.c_int
    lib.tinyrt_write_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
        ctypes.c_int]
    lib.tinyrt_write_png.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """The library, built if needed and loaded once per process (keyed by
    its path: a changed source or build directory builds and loads
    anew)."""
    path = library_path()
    return _build.load_once(path, build, _declare)


def bvh_build(bb_min: np.ndarray, bb_max: np.ndarray):
    """Threaded (hit-link/miss-link) BVH over primitive AABBs (N, 3):
    (node_min (2N-1, 3) f32, node_max, hit_link (2N-1,) i32, miss_link,
    leaf_prim) in DFS preorder; leaf_prim holds local primitive indices,
    -1 for inner nodes."""
    bb_min = np.ascontiguousarray(bb_min, np.float32)
    bb_max = np.ascontiguousarray(bb_max, np.float32)
    n = bb_min.shape[0]
    if n == 0 or bb_min.shape != (n, 3) or bb_max.shape != (n, 3):
        raise ValueError(f"expected two (N, 3) arrays with N > 0, got "
                         f"{bb_min.shape} and {bb_max.shape}")
    m = 2 * n - 1
    node_min = np.empty((m, 3), np.float32)
    node_max = np.empty((m, 3), np.float32)
    hit_link = np.empty((m,), np.int32)
    miss_link = np.empty((m,), np.int32)
    leaf_prim = np.empty((m,), np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    rc = load().tinyrt_bvh_build(
        bb_min.ctypes.data_as(fp), bb_max.ctypes.data_as(fp), n,
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        hit_link.ctypes.data_as(ip), miss_link.ctypes.data_as(ip),
        leaf_prim.ctypes.data_as(ip))
    if rc != 0:
        raise RuntimeError(f"tinyrt_bvh_build failed: {rc}")
    return node_min, node_max, hit_link, miss_link, leaf_prim


def write_png(path: str, rgb: np.ndarray) -> None:
    """Writes an (H, W, 3) uint8 array as an 8-bit RGB PNG at `path`."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape} "
                         f"{rgb.dtype}")
    h, w, _ = rgb.shape
    rc = load().tinyrt_write_png(
        os.fsencode(path), rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        w, h)
    if rc != 0:
        raise RuntimeError(f"tinyrt_write_png failed: {rc}")
