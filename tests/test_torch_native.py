"""The port's native host library (tinyraytracer_tpu_torch/native/, built
with g++ at first use): the C++ BVH builder against the port's numpy
builder and the JAX package's native builder, bit for bit; the PNG
encoder against `encode_png` and the JAX package's native encoder; the
build's failures, and concurrent builds.

The JAX package's library is compiled here from its own source into a
temporary directory and loaded through its runtime module (the port
never loads it)."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from tinyraytracer_tpu.models import presets as jax_presets
from tinyraytracer_tpu.native import runtime as jax_runtime
from tinyraytracer_tpu.ops import bvh as jax_bvh
from tinyraytracer_tpu_torch import _build
from tinyraytracer_tpu_torch.models import presets
from tinyraytracer_tpu_torch.native import runtime
from tinyraytracer_tpu_torch.ops import bvh
from tinyraytracer_tpu_torch.utils.image import Image, encode_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("node_min", "node_max", "hit_link", "miss_link", "leaf_prim")
SCENES = [("random_spheres", dict(n=300)), ("cornell_box", {}),
          ("three_spheres", {})]


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's runtime over its source compiled into a
    temporary directory, as its native/build.py compiles it."""
    lib = tmp_path_factory.mktemp("jax_native") / "libtinyrt.so"
    src = os.path.join(REPO, "tinyraytracer_tpu", "native", "src",
                       "tinyrt.cpp")
    subprocess.run(["g++", "-std=c++17", "-O3", "-fPIC", "-shared", "-o",
                    str(lib), src, "-lz"], check=True, capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_runtime, "_LIB_PATH", str(lib))
        mp.setattr(jax_runtime, "_LIB", None)
        mp.setattr(jax_runtime, "_TRIED", False)
        assert jax_runtime.available()
        yield jax_runtime


@pytest.mark.parametrize("name,kw", SCENES)
def test_native_bvh_is_numpy_and_jax_native_bit_for_bit(jax_native, name,
                                                        kw):
    world, _, _ = presets.PRESETS[name](width=8, height=8, **kw)
    scene = world.build()
    native = bvh.build_bvh(scene)
    host = bvh.build_bvh(scene, use_native=False)
    jworld, _, _ = jax_presets.PRESETS[name](width=8, height=8, **kw)
    jscene = jworld.build()
    want = jax_bvh.build_bvh(jscene, use_native=True)
    # the JAX builder took its native library: same arrays as its
    # runtime's, mapped to global ids
    raw = jax_native.bvh_build(*jax_bvh.primitive_aabbs(jscene)[:2])
    assert np.array_equal(np.asarray(want.node_min), raw[0])
    for f in FIELDS:
        a = getattr(native, f).numpy()
        assert a.dtype == getattr(host, f).numpy().dtype
        np.testing.assert_array_equal(a, getattr(host, f).numpy())
        np.testing.assert_array_equal(a, np.asarray(getattr(want, f)))
    assert native.leaf_prim.dtype == torch.int32


def test_native_bvh_maps_local_to_global_ids():
    """cornell_box's BVH holds quads only: leaves carry global primitive
    ids (spheres first), not the builder's local indices."""
    world, _, _ = presets.cornell_box(width=8, height=8)
    scene = world.build()
    bb_min, bb_max, prim_ids = bvh.primitive_aabbs(scene)
    local = runtime.bvh_build(bb_min, bb_max)[4]
    lp = bvh.build_bvh(scene).leaf_prim.numpy()
    leaves = local >= 0
    assert (lp[leaves] == prim_ids[local[leaves]]).all()
    assert (lp[~leaves] == -1).all()
    assert not np.array_equal(lp[leaves], local[leaves])


def test_native_png_is_encode_png_and_jax_native(jax_native, tmp_path):
    rgb = np.random.default_rng(0).random((37, 61, 3)).astype(np.float32)
    img = Image(rgb * 1.2)
    path = tmp_path / "port.png"
    img.save(str(path))
    data = path.read_bytes()
    decoded = np.asarray(PILImage.open(io.BytesIO(data)).convert("RGB"))
    want = np.asarray(PILImage.open(io.BytesIO(encode_png(img.to_u8()))))
    np.testing.assert_array_equal(decoded, img.to_u8())
    np.testing.assert_array_equal(decoded, want)
    jax_path = tmp_path / "jax.png"
    jax_native.write_png(str(jax_path), img.to_u8())
    assert data == jax_path.read_bytes()


def test_write_png_checks_its_input(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        runtime.write_png(str(tmp_path / "x.png"), np.zeros((2, 2, 3)))
    with pytest.raises(RuntimeError, match="tinyrt_write_png failed"):
        runtime.write_png(str(tmp_path / "missing" / "x.png"),
                          np.zeros((2, 2, 3), np.uint8))


@pytest.fixture
def fresh_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return tmp_path / "_build"


def test_broken_compiler_raises_and_nothing_falls_back(fresh_build_dir,
                                                       tmp_path,
                                                       monkeypatch):
    world, _, _ = presets.three_spheres(width=8, height=8)
    scene = world.build()
    monkeypatch.setattr(runtime, "cxx_path",
                        lambda: str(tmp_path / "no" / "g++"))
    with pytest.raises(RuntimeError, match="use_native=False"):
        bvh.build_bvh(scene)
    with pytest.raises(RuntimeError, match="use_native=False"):
        Image(np.zeros((2, 2, 3), np.float32)).save(str(tmp_path / "a.png"))
    assert not (tmp_path / "a.png").exists()
    failing = tmp_path / "failing_cxx"
    failing.write_text("#!/bin/sh\necho 'tinyrt.cpp:1: error: boom' >&2\n"
                       "exit 1\n")
    failing.chmod(0o755)
    monkeypatch.setattr(runtime, "cxx_path", lambda: str(failing))
    with pytest.raises(RuntimeError, match="error: boom"):
        runtime.build()
    assert not list(fresh_build_dir.glob("*"))
    # the numpy builder needs no compiler
    n = scene.sph_center.shape[0] + scene.quad_corner.shape[0]
    assert bvh.build_bvh(scene, use_native=False).leaf_prim.numel() <= 2 * n


def test_no_compiler_on_path_raises(monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="no C.. compiler"):
        runtime.cxx_path()


BUILD_ONE = (
    "import sys\n"
    "from pathlib import Path\n"
    "from tinyraytracer_tpu_torch import _build\n"
    "_build.BUILD_DIR = Path(sys.argv[1])\n"
    "from tinyraytracer_tpu_torch.native import runtime\n"
    "runtime.load()\n"
    "print(runtime.library_path().name)\n")


def test_concurrent_builds_agree(fresh_build_dir):
    """Six processes (the test workers) building at once into one empty
    directory each load the same library, and no temporary file is left
    behind."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_ONE, str(fresh_build_dir)], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, outs
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert [p.name for p in fresh_build_dir.iterdir()] == list(names)
