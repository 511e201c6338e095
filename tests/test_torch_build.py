"""The port's kernel build step, driven by a stand-in for nvcc.

No CUDA compiler is needed: a shell script takes nvcc's place, so the
logic around it (source hashing, the build cache, error reporting) is
checked on any machine.
"""

import ctypes

import pytest

from tinyraytracer_tpu_torch import _build


def _fake_nvcc(tmp_path, body: str) -> str:
    exe = tmp_path / "fake_nvcc"
    exe.write_text("#!/bin/sh\n" + body)
    exe.chmod(0o755)
    return str(exe)


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    (src / "j.cu").write_text('#include "c.cuh"\n')
    (src / "c.cuh").write_text("// header v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return tmp_path


def test_build_caches_by_source_and_flag_hash(fake_tree, monkeypatch):
    """One nvcc per source (-c), then one link (-shared); a rebuild only
    when a source, a header or the flags change."""
    calls = fake_tree / "calls"
    nvcc = _fake_nvcc(fake_tree, (
        f'echo "$*" >> "{calls}"\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        'echo "ptxas info : Used 8 registers" >&2\n'
        ': > "$out"\n'))
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)

    def links():
        return [c for c in calls.read_text().splitlines() if "-shared" in c]

    first = _build.build()
    assert first.is_file() and first.parent == fake_tree / "_build"
    assert "Used 8 registers" in first.with_suffix(".log").read_text()
    compiles = [c for c in calls.read_text().splitlines() if " -c " in c]
    assert sorted(c.split()[-1].rsplit("/", 1)[-1] for c in compiles) == [
        "j.cu", "k.cu"]
    assert len(links()) == 1 and links()[0].count(".o") == 2
    assert _build.build() == first                  # cached: no rebuild
    assert len(links()) == 1
    fma = _build.build(fmad=True)                   # other flags, other file
    assert fma != first and len(links()) == 2
    (fake_tree / "csrc" / "k.cu").write_text("// v2\n")
    second = _build.build()                         # changed source
    assert second != first and len(links()) == 3
    (fake_tree / "csrc" / "c.cuh").write_text("// header v2\n")
    assert _build.build() not in (first, second)    # changed header
    assert len(links()) == 4
    left = {p.suffix for p in (fake_tree / "_build").iterdir()}
    assert left == {".so", ".log"}                  # no objects, no .tmp


def test_declare_types_every_exported_function():
    """Each kernel entry point gets argtypes, pointers as c_void_p: with
    untyped arguments ctypes would pass them as 32-bit ints."""
    from types import SimpleNamespace

    names = ("tinyrt_megakernel_packed", "tinyrt_megakernel_flat",
             "tinyrt_closest_hit", "tinyrt_error_string")
    lib = SimpleNamespace(**{n: SimpleNamespace() for n in names})
    _build._declare(lib)
    p = ctypes.c_void_p
    packed = lib.tinyrt_megakernel_packed.argtypes
    assert len(packed) == 17
    assert [k for k, t in enumerate(packed) if t is p] == [0, 1, 5, 16]
    flat = lib.tinyrt_megakernel_flat.argtypes
    assert len(flat) == 23
    assert [k for k, t in enumerate(flat) if t is p] == [0, 1, 4, 6, 8, 11,
                                                         22]
    assert flat[18] is ctypes.c_float
    assert flat[14] is flat[15] is ctypes.c_uint
    k3 = lib.tinyrt_closest_hit.argtypes
    assert len(k3) == 16
    assert [k for k, t in enumerate(k3) if t is p] == [0, 3, 6, 8, 11, 12,
                                                       13, 15]
    # the ray strides are 64-bit: a (R, 3) view's row stride times R
    # passes 2^31 elements at R = 716 million rays
    assert [k for k, t in enumerate(k3) if t is ctypes.c_longlong] == [
        1, 2, 4, 5]
    for n in names[:3]:
        assert getattr(lib, n).restype is ctypes.c_int


def test_build_failure_raises_compiler_output(fake_tree, monkeypatch):
    nvcc = _fake_nvcc(fake_tree, 'echo "k.cu(3): error: boom" >&2\nexit 2\n')
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    with pytest.raises(RuntimeError, match="error: boom"):
        _build.build()
    assert not list((fake_tree / "_build").glob("*.so*"))


def test_flags_target_hopper_without_fast_math():
    for fmad in (False, True):
        f = _build.flags(fmad)
        assert "arch=compute_90a,code=sm_90a" in f
        assert f"--fmad={'true' if fmad else 'false'}" in f
        assert not any("fast" in x for x in f)
